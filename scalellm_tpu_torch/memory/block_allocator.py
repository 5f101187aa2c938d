"""Free-list block allocator.

Equivalent of the reference's BlockAllocator
(reference: src/memory/block_allocator.h:14-56). Owns block ids only; the
actual KV storage is the preallocated device arrays managed by the engine.
Not thread safe — owned by the scheduler loop (same discipline as the
reference, block_allocator.h:11).
"""

from __future__ import annotations

from typing import List

from scalellm_tpu_torch.memory.block import Block


class BlockAllocator:
    def __init__(self, total_blocks: int, block_size: int):
        assert total_blocks > 0 and block_size > 0
        self._block_size = block_size
        self._total_blocks = total_blocks
        # LIFO free list for locality.
        self._free_ids: List[int] = list(range(total_blocks - 1, -1, -1))
        # Ids pinned out of the pool forever (the manager's padding block).
        self._reserved_ids: set = set()

    def reserve(self, block_id: int) -> None:
        """Mark an allocated block as permanently reserved: freeing it is
        a bug (multi-step decode writes overshoot KV through zero-padded
        block tables into the padding block)."""
        assert block_id not in self._free_ids
        self._reserved_ids.add(block_id)

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def total_blocks(self) -> int:
        return self._total_blocks

    @property
    def num_free_blocks(self) -> int:
        return len(self._free_ids)

    @property
    def num_used_blocks(self) -> int:
        return self._total_blocks - len(self._free_ids)

    def allocate(self) -> Block:
        assert self._free_ids, "out of blocks"
        return Block(self._free_ids.pop(), self._block_size, self)

    def allocate_many(self, n: int) -> List[Block]:
        assert len(self._free_ids) >= n, "out of blocks"
        return [self.allocate() for _ in range(n)]

    def free(self, block_id: int) -> None:
        """Called by Block.dec_ref when refcount hits 0."""
        # Reserved blocks (the manager's padding block 0, reference:
        # block_manager.cpp:40-42) must NEVER return to the free pool:
        # multi-step decode's past-end micro-steps write KV through the
        # zero-padded block-table tail into page 0 (executor.py overshoot
        # invariant).
        assert block_id not in self._reserved_ids, (
            "padding block must stay reserved"
        )
        self._free_ids.append(block_id)
