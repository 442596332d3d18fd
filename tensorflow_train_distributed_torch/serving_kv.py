"""Paged KV-cache bookkeeping: block pool + radix prefix index.

The HOST half of the serving engine's paged KV cache
(``serving.ServingEngine`` with ``paged=True``, the default).  Device
memory is one fixed pool of ``[num_blocks, block_size, kv_heads,
head_dim]`` rows per layer (static shape — jit/sharding see one
allocation for the whole session, the Mesh-TensorFlow static-shape
rule; ``kv_cache_int8`` configs store int8 rows with a parallel
``[2, num_blocks, block_size, kv_heads]`` f32 scale pool — same block
ids, half the row bytes, so every table this module hands out covers
both).  The DEVICE read is either an XLA block gather or the fused
paged-attention kernel (``ops.pallas_kernels.paged_attention``) —
both steer their DMA by the tables built here, so this bookkeeping is
layout-authoritative for both legs.  WHICH physical block backs WHICH
logical position of WHICH lane is pure host bookkeeping, and this
module owns all of it:

- ``KVBlockPool``: a free list + per-block reference counts over the
  ``n_blocks`` allocatable physical blocks.  Block id 0 is RESERVED as
  the scratch block (idle/retired lanes' garbage writes land there —
  the paged analog of the linear cache's stale-row rule), so physical
  ids run ``1..n_blocks``.
- ``RadixPrefixIndex``: a radix tree over token ids at BLOCK
  granularity — each edge is one ``block_size``-token chunk, each node
  pins one physical block whose rows hold exactly that chunk's KV.
  Requests sharing a prompt prefix map their leading table entries to
  the same physical blocks (copy-on-write at allocation: suffixes
  always start at a block boundary, so a sharer never writes a shared
  block) and prefill only the suffix.  The tree holds its own pool
  reference per node; lanes add one more while mapped.  Eviction is
  LRU over fully-retired leaves (tree-only references, no children) —
  evicting a leaf may expose its parent, so pressure drains whole
  retired subtrees back to the free list, never a block a live lane
  can still read.

Sharing is exact, not approximate: a node is only ever matched by
token-for-token equality of its chunk, and the KV rows of a shared
block were computed from those very tokens at those very positions
(per-lane positions all start at 0), so a prefix hit reads bit-identical
rows to the prefill it skipped.  Partial (sub-block) prefixes are not
shared — the tail of a prompt that doesn't fill a block is private to
its lane, which is what makes lane writes copy-free.

Everything here is plain Python on the engine's single-threaded host
loop — no jax imports, no device work — so the allocator is testable
without a device and adds nothing to the serving hot path beyond dict
walks over O(prompt/block_size) nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Physical block 0 is the scratch block: never allocated, never shared,
# the write target the engine points idle/retired lanes at.
SCRATCH_BLOCK = 0


class KVBlockPool:
    """Free list + refcounts over ``n_blocks`` allocatable blocks.

    Blocks are freed automatically when their refcount drops to zero;
    ``alloc`` either returns exactly ``n`` ids or None (all-or-nothing,
    so a request that cannot fit is REFUSED admission instead of
    corrupting a live lane with a partial table).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError(f"need >= 1 allocatable block, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # Device bytes one physical block's rows pin across layers
        # (target + draft + int8 scale pools; 0 = unknown).  Set by
        # the engine from the real cache eval_shape, so this host
        # allocator can answer in BYTES — the unit HBM budgets and the
        # /healthz capacity view reason in — not just block counts
        # (``ServingEngine.kv_bytes_in_use`` is the consumer).
        self.bytes_per_block = 0
        # LIFO free list: recently-freed blocks are re-handed first
        # (their rows are most likely still warm in cache hierarchy).
        self._free: List[int] = list(range(n_blocks, 0, -1))
        self._refs: Dict[int, int] = {}
        self.stats = {"allocated_blocks": 0, "freed_blocks": 0}

    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def bytes_in_use(self) -> int:
        """Referenced blocks in device bytes (live lanes + radix
        cache; 0 when the engine never set ``bytes_per_block``)."""
        return self.blocks_in_use() * self.bytes_per_block

    def bytes_total(self) -> int:
        """Allocatable capacity in device bytes."""
        return self.n_blocks * self.bytes_per_block

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or None if the free list is
        short (caller may evict from the radix index and retry)."""
        if n < 0:
            raise ValueError(f"alloc takes n >= 0, got {n}")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.stats["allocated_blocks"] += n
        return out

    def ref(self, block: int) -> None:
        """One more holder of an already-live block (prefix sharing)."""
        refs = self._refs.get(block, 0)
        if refs <= 0:
            raise ValueError(f"ref of free block {block}")
        self._refs[block] = refs + 1

    def deref(self, block: int) -> None:
        """Drop one holder; the last one out frees the block."""
        refs = self._refs.get(block, 0)
        if refs <= 0:
            raise ValueError(f"deref of free block {block}")
        if refs == 1:
            del self._refs[block]
            self._free.append(block)
            self.stats["freed_blocks"] += 1
        else:
            self._refs[block] = refs - 1


@dataclasses.dataclass
class _RadixNode:
    """One cached block: ``chunk`` (its block_size token ids) keys it
    under ``parent``; ``block`` is the physical id whose rows hold the
    chunk's KV.  The node owns one pool reference for as long as it is
    in the tree."""

    chunk: Tuple[int, ...]
    block: int
    parent: Optional["_RadixNode"]
    children: Dict[Tuple[int, ...], "_RadixNode"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0


class RadixPrefixIndex:
    """Block-granular radix tree over token ids → physical KV blocks.

    ``match`` walks a prompt chunk by chunk and returns the shared
    leading blocks; ``insert`` registers a lane's freshly-prefilled (or
    decoded) full blocks so LATER requests share them; ``evict_for``
    frees least-recently-used fully-retired leaves under pressure.
    """

    def __init__(self, pool: KVBlockPool):
        self._pool = pool
        self._bs = pool.block_size
        self._root = _RadixNode(chunk=(), block=SCRATCH_BLOCK, parent=None)
        self._clock = 0          # monotonic LRU clock (match/insert bump)
        self._nodes = 0
        self.stats = {"hits": 0, "hit_tokens": 0, "evicted_blocks": 0,
                      "inserted_blocks": 0}

    def __len__(self) -> int:
        return self._nodes

    def cached_blocks(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens, allow_full: bool = False,
              record: bool = True) -> Tuple[int, List[int]]:
        """Longest cached block-aligned prefix STRICTLY shorter than
        ``tokens`` → ``(matched_len, [block_ids])``.  At least one
        suffix token must remain unprefilled (its logit picks the first
        generated token), so at most ``(len-1) // block_size`` blocks
        match — unless ``allow_full`` (preload dedup: no logit is
        needed, the whole span may hit).  Touches matched nodes' LRU
        clocks; takes NO pool references — the caller refs what it
        keeps.  ``record=False`` skips the hit stats (a starved queue
        head re-matches every engine step while it waits; counting each
        retry would report thousands of hits for one admission) —
        recency still refreshes, which keeps the blocks the waiter
        needs at the back of the eviction order."""
        bs = self._bs
        now = self._tick()
        node = self._root
        blocks: List[int] = []
        limit = (len(tokens) - (0 if allow_full else 1)) // bs
        for j in range(limit):
            chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = now
            blocks.append(child.block)
            node = child
        if blocks and record:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(blocks) * bs
        return len(blocks) * bs, blocks

    def insert(self, tokens, block_of) -> int:
        """Register the full blocks of ``tokens`` whose rows are valid
        (caller guarantees positions ``[0, n_full*bs)`` hold these
        tokens' KV in the given physical blocks).  ``block_of(j)``
        returns the lane's physical block for table slot ``j``.  Where a
        node already exists the EXISTING block stays canonical (the
        lane's duplicate copy is simply not cached); new nodes take one
        pool reference each.  Returns how many new blocks were cached.
        """
        bs = self._bs
        now = self._tick()
        node = self._root
        added = 0
        for j in range(len(tokens) // bs):
            chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                block = block_of(j)
                if block == SCRATCH_BLOCK:
                    break          # lane has no real block here — stop
                self._pool.ref(block)
                child = _RadixNode(chunk=chunk, block=block, parent=node,
                                   last_used=now)
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            child.last_used = now
            node = child
        self.stats["inserted_blocks"] += added
        return added

    def _evictable(self) -> List[_RadixNode]:
        """Leaves only the tree still references: no live lane can read
        them, no deeper cached block needs them on its path."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self._pool.refcount(n.block) == 1:
                out.append(n)
        return out

    def evict_for(self, n_needed: int) -> int:
        """Free least-recently-used retired leaves until ``n_needed``
        blocks are available on the pool's free list (or nothing is
        left to evict).  Evicting a leaf may expose its parent as the
        next candidate, so whole retired subtrees drain under
        sustained pressure.  Returns the number of blocks evicted."""
        evicted = 0
        while self._pool.free_blocks() < n_needed:
            leaves = self._evictable()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            self._pool.deref(victim.block)
            del victim.parent.children[victim.chunk]
            self._nodes -= 1
            evicted += 1
        self.stats["evicted_blocks"] += evicted
        return evicted

    def check_invariants(self) -> None:
        """Structural audit for tests: every node's block is live in the
        pool (the tree's own reference), node count matches the walk,
        and children are keyed by their own chunk."""
        count = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            count += 1
            assert len(n.chunk) == self._bs, "chunk width != block_size"
            assert self._pool.refcount(n.block) >= 1, "node block is free"
            assert n.block != SCRATCH_BLOCK, "scratch block in the tree"
            for key, child in n.children.items():
                assert key == child.chunk, "child keyed by foreign chunk"
                assert child.parent is n, "broken parent link"
                stack.append(child)
        assert count == self._nodes, "node count drifted"


@dataclasses.dataclass
class LaneKV:
    """One lane's paged-KV claim: the physical block table backing its
    logical positions, split into the ``shared`` leading blocks (radix
    prefix hits — read-only for this lane) and the ``owned`` rest (its
    private, writable blocks).  ``matched`` is the shared token count
    (= len(shared) * block_size)."""

    request_id: int
    matched: int
    shared: List[int]
    owned: List[int]

    def table(self, width: int) -> List[int]:
        """Physical ids for table slots 0..width-1, scratch-padded."""
        row = self.shared + self.owned
        return (row + [SCRATCH_BLOCK] * (width - len(row)))[:width]

    def blocks(self) -> List[int]:
        return self.shared + self.owned
