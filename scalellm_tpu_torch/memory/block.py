"""Ref-counted KV-cache block handle.

Equivalent of the reference's Block (reference: src/memory/block.h:13-76).
A Block maps to `size` contiguous KV slots in the device cache arrays; block id
b covers global slots [b*size, (b+1)*size). Blocks auto-free back to their
allocator when the refcount hits zero.
"""

from __future__ import annotations

from typing import Optional


class Block:
    __slots__ = ("id", "size", "_allocator", "_ref_count")

    def __init__(self, block_id: int, size: int, allocator: Optional["BlockAllocator"] = None):
        self.id = block_id
        self.size = size
        self._allocator = allocator
        self._ref_count = 1

    @property
    def ref_count(self) -> int:
        return self._ref_count

    def is_shared(self) -> bool:
        return self._ref_count > 1

    def inc_ref(self) -> "Block":
        assert self._ref_count > 0, "reviving a freed block"
        self._ref_count += 1
        return self

    def dec_ref(self) -> None:
        assert self._ref_count > 0, "double free of block"
        self._ref_count -= 1
        if self._ref_count == 0 and self._allocator is not None:
            self._allocator.free(self.id)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Block(id={self.id}, size={self.size}, refs={self._ref_count})"
