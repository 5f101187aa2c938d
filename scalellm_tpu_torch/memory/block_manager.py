"""BlockManager — facade over BlockAllocator + PrefixCache.

Equivalent of the reference's BlockManager
(reference: src/memory/block_manager.h:15, block_manager.cpp). Allocates KV
blocks for sequences, serves prefix-cache hits, caches finished/preempted
sequences' blocks, and evicts when the free list runs dry. Block 0 is
reserved as the padding block (reference: block_manager.cpp:40-42) so padded
batch entries can safely point at a real slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional

from scalellm_tpu_torch.memory.block import Block
from scalellm_tpu_torch.memory.block_allocator import BlockAllocator
from scalellm_tpu_torch.memory.prefix_cache import PrefixCache

if TYPE_CHECKING:  # avoid circular import (sequence.py imports memory.block)
    from scalellm_tpu_torch.request.sequence import Sequence


@dataclass
class BlockManagerOptions:
    num_blocks: int = 1024
    block_size: int = 16
    enable_prefix_cache: bool = True


class BlockManager:
    def __init__(self, options: BlockManagerOptions):
        self._options = options
        self._block_size = options.block_size
        self._allocator = BlockAllocator(options.num_blocks, options.block_size)
        self._prefix_cache = (
            PrefixCache(options.block_size) if options.enable_prefix_cache else None
        )
        # Reserve block 0 for padding (never handed to sequences).
        self._padding_block = self._allocator.allocate()
        assert self._padding_block.id == 0
        self._allocator.reserve(0)

    @property
    def options(self) -> BlockManagerOptions:
        return self._options

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def num_free_blocks(self) -> int:
        return self._allocator.num_free_blocks

    @property
    def num_blocks_in_prefix_cache(self) -> int:
        return self._prefix_cache.num_blocks if self._prefix_cache else 0

    @property
    def kv_cache_utilization(self) -> float:
        total = self._allocator.total_blocks
        return self._allocator.num_used_blocks / total if total else 0.0

    @property
    def max_seq_tokens(self) -> int:
        """Most KV slots a single sequence can ever hold (all usable blocks).
        Requests needing more can never be scheduled — reject them upfront
        instead of leaving them in the wait queue forever."""
        return (self._allocator.total_blocks - 1) * self._block_size

    # ------------------------------------------------------------- allocate

    def allocate_blocks_for(self, seq: "Sequence", num_tokens: int) -> bool:
        """Ensure seq has KV capacity for num_tokens total tokens.

        Serves the prompt prefix from the prefix cache when possible, then
        allocates fresh blocks, evicting from the cache if needed
        (reference: block_manager.cpp:48 allocate_blocks_for).
        """
        if (
            self._prefix_cache is not None
            and not seq.blocks
            # prompt_logprobs needs every prompt position to run through
            # prefill — a prefix hit would skip the cached positions'
            # scores, so those requests bypass cache reuse (they still
            # PUBLISH their blocks to the cache on release).
            and seq.sampling_params.prompt_logprobs is None
        ):
            # Only match the *prompt* prefix, and never the full sequence —
            # the last token's KV must be recomputed to produce logits.
            matchable = seq.prefix_key_tokens(seq.num_prompt_tokens - 1)
            shared = self._prefix_cache.match(matchable)
            if shared:
                seq.append_blocks(shared)
                seq.set_shared_kv_tokens(len(shared) * self._block_size)

        cur_capacity = seq.kv_cache_capacity
        if num_tokens <= cur_capacity:
            return True
        need = (num_tokens - cur_capacity + self._block_size - 1) // self._block_size
        if not self._ensure_free(need):
            return False
        seq.append_blocks(self._allocator.allocate_many(need))
        return True

    def allocate_fresh_blocks_for(self, seq: "Sequence", num_tokens: int) -> bool:
        """allocate_blocks_for WITHOUT prefix-cache matching — used by KV
        swap-in, whose staged data already covers generated tokens (which
        the prefix cache never serves) and must land in unshared blocks."""
        cur_capacity = seq.kv_cache_capacity
        if num_tokens <= cur_capacity:
            return True
        need = (num_tokens - cur_capacity + self._block_size - 1) // self._block_size
        if not self._ensure_free(need):
            return False
        seq.append_blocks(self._allocator.allocate_many(need))
        return True

    def has_enough_blocks(self, num_blocks: int) -> bool:
        """(reference: block_manager.cpp:112) — true if allocation of
        num_blocks can succeed, possibly after cache eviction."""
        if self._allocator.num_free_blocks >= num_blocks:
            return True
        if self._prefix_cache is None:
            return False
        evictable = self._prefix_cache.num_blocks
        return self._allocator.num_free_blocks + evictable >= num_blocks

    def _ensure_free(self, num_blocks: int) -> bool:
        if self._allocator.num_free_blocks >= num_blocks:
            return True
        if self._prefix_cache is None:
            return False
        need = num_blocks - self._allocator.num_free_blocks
        self._prefix_cache.evict(need)
        return self._allocator.num_free_blocks >= num_blocks

    # ------------------------------------------------------------- release

    def cache_blocks_for(self, seq: "Sequence") -> None:
        """Insert the sequence's computed-KV prefix into the prefix cache
        (reference: block_manager.cpp cache_blocks_for)."""
        if self._prefix_cache is None:
            return
        n_cached_tokens = seq.num_kv_cache_tokens()
        n_blocks = n_cached_tokens // self._block_size
        if n_blocks:
            self._prefix_cache.insert(
                seq.prefix_key_tokens(n_blocks * self._block_size),
                seq.blocks[:n_blocks],
            )

    def release_without_caching(self, seq: "Sequence") -> None:
        """Free the sequence's blocks WITHOUT publishing to the prefix
        cache — KV swap-out staged the contents to host memory, and the
        swap-in must land in unshared blocks."""
        for block in seq.blocks:
            block.dec_ref()
        seq.release_blocks()

    def deallocate(self, seq: "Sequence") -> None:
        """Release the sequence's blocks, caching them first when prefix
        caching is on."""
        self.cache_blocks_for(seq)
        for block in seq.blocks:
            block.dec_ref()
        seq.release_blocks()
