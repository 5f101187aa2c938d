"""Prefix cache: a token-id trie over KV blocks with LRU eviction.

Equivalent of the reference's PrefixCache
(reference: src/memory/prefix_cache.h:12-110). Nodes hold block-aligned runs
of token ids plus the blocks whose KV covers them; matching walks the trie
greedily, splitting nodes on partial (block-aligned) matches. Eviction walks
an LRU list, freeing leaf nodes whose blocks are not currently referenced by
any live sequence.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence as Seq, Tuple

from scalellm_tpu_torch.memory.block import Block

_access_counter = itertools.count()


class _Node:
    __slots__ = ("tokens", "blocks", "children", "parent", "last_access")

    def __init__(self, tokens: List[int], blocks: List[Block], parent: Optional["_Node"]):
        self.tokens = tokens
        self.blocks = blocks
        self.parent = parent
        # children keyed by the TUPLE of the child's first block of token
        # ids — a child hit therefore always matches >= 1 whole block, which
        # keeps insert() monotonic (a first-token key would loop forever when
        # two blocks share a first token but diverge mid-block).
        self.children: Dict[tuple, "_Node"] = {}
        self.last_access = next(_access_counter)

    def touch(self) -> None:
        self.last_access = next(_access_counter)


class PrefixCache:
    def __init__(self, block_size: int):
        assert block_size > 0
        self._block_size = block_size
        self._root = _Node([], [], None)
        self._num_blocks = 0

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    # --------------------------------------------------------------- match

    def match(self, token_ids: Seq[int]) -> List[Block]:
        """Longest block-aligned prefix match. Returns blocks with an extra
        ref taken for the caller (caller owns releasing them)."""
        n = (len(token_ids) // self._block_size) * self._block_size
        matched: List[Block] = []
        node = self._root
        pos = 0
        while pos < n:
            key = tuple(token_ids[pos : pos + self._block_size])
            child = node.children.get(key)
            if child is None:
                break
            # Compare block by block within the child.
            k = 0  # number of matched blocks within child
            while (
                (k + 1) * self._block_size <= len(child.tokens)
                and pos + (k + 1) * self._block_size <= n
                and child.tokens[k * self._block_size : (k + 1) * self._block_size]
                == list(token_ids[pos + k * self._block_size : pos + (k + 1) * self._block_size])
            ):
                k += 1
            if k == 0:
                break
            child.touch()
            matched.extend(b.inc_ref() for b in child.blocks[:k])
            pos += k * self._block_size
            if k * self._block_size < len(child.tokens):
                break  # partial match within this node: stop
            node = child
        return matched

    # --------------------------------------------------------------- insert

    def insert(self, token_ids: Seq[int], blocks: Seq[Block]) -> int:
        """Cache the block-aligned prefix of (token_ids, blocks). The cache
        takes its own reference on newly-cached blocks. Returns the number of
        blocks newly added to the cache."""
        n_blocks = min(len(token_ids) // self._block_size, len(blocks))
        if n_blocks == 0:
            return 0
        tokens = list(token_ids[: n_blocks * self._block_size])
        node = self._root
        pos = 0  # token position
        bi = 0  # block index
        new_blocks = 0
        while bi < n_blocks:
            key = tuple(tokens[pos : pos + self._block_size])
            child = node.children.get(key)
            if child is None:
                # Insert remainder as a new leaf.
                rem_tokens = tokens[pos:]
                rem_blocks = [b.inc_ref() for b in blocks[bi:n_blocks]]
                leaf = _Node(rem_tokens, rem_blocks, node)
                node.children[key] = leaf
                self._num_blocks += len(rem_blocks)
                new_blocks += len(rem_blocks)
                return new_blocks
            # Match whole blocks within child.
            k = 0
            max_k = min(len(child.tokens) // self._block_size, n_blocks - bi)
            while (
                k < max_k
                and child.tokens[k * self._block_size : (k + 1) * self._block_size]
                == tokens[pos + k * self._block_size : pos + (k + 1) * self._block_size]
            ):
                k += 1
            child.touch()
            if k < len(child.tokens) // self._block_size and k < n_blocks - bi:
                # Diverged mid-node: split child at block k.
                self._split(child, k)
            pos += k * self._block_size
            bi += k
            if bi < n_blocks and k == len(child.tokens) // self._block_size:
                node = child
            elif bi < n_blocks:
                node = child  # after split, child holds exactly k blocks
        return new_blocks

    def _split(self, node: _Node, k_blocks: int) -> None:
        """Split `node` so it keeps its first k_blocks; the rest moves to a
        new child node (reference: prefix_cache.h Node splitting)."""
        cut = k_blocks * self._block_size
        tail_tokens = node.tokens[cut:]
        tail_blocks = node.blocks[k_blocks:]
        node.tokens = node.tokens[:cut]
        node.blocks = node.blocks[:k_blocks]
        tail = _Node(tail_tokens, tail_blocks, node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_access = node.last_access
        node.children = {tuple(tail_tokens[: self._block_size]): tail}

    # --------------------------------------------------------------- evict

    def evict(self, n_blocks: int) -> int:
        """Try to release n_blocks back to the allocator. Only evicts blocks
        not referenced by live sequences (cache holds exactly one ref on an
        idle cached block). Returns the number of blocks evicted."""
        evicted = 0
        while evicted < n_blocks:
            victim = self._pick_lru_leaf()
            if victim is None:
                break
            # Evict whole blocks from the tail of the victim node.
            while victim.blocks and evicted < n_blocks:
                blk = victim.blocks[-1]
                if blk.ref_count > 1:
                    break  # in use by a sequence
                victim.blocks.pop()
                victim.tokens = victim.tokens[: len(victim.blocks) * self._block_size]
                blk.dec_ref()
                self._num_blocks -= 1
                evicted += 1
            if not victim.blocks:
                # Unlink empty node from the trie.
                parent = victim.parent
                for key, c in list(parent.children.items()):
                    if c is victim:
                        del parent.children[key]
                        break
            elif victim.blocks and victim.blocks[-1].ref_count > 1:
                # Couldn't evict further from this node; mark it recently
                # used so _pick_lru_leaf doesn't spin on it.
                victim.touch()
                if evicted < n_blocks and self._has_other_candidates(victim):
                    continue
                break
        return evicted

    def _pick_lru_leaf(self) -> Optional[_Node]:
        best: Optional[_Node] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children:
                continue
            if not node.blocks:
                continue
            # Eviction is tail-first, so a node is a candidate only if its
            # tail block is idle (cache holds the sole reference).
            if node.blocks[-1].ref_count > 1:
                continue
            if best is None or node.last_access < best.last_access:
                best = node
        return best

    def _has_other_candidates(self, excluded: _Node) -> bool:
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node is excluded or node.children:
                continue
            if node.blocks and node.blocks[-1].ref_count == 1:
                return True
        return False
