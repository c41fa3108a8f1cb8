"""Block-granular paged KV cache — allocator + device pool (the port of the
JAX package's ``runtime/kvblocks.py``, without the host tier).

* **Device pool** — :class:`PagedKVCache` stores KV as torch tensors
  ``[L, n_blocks, n_kv, block_size, hd]``; a sequence's logical cache is a
  *block table* (host ``int32[max_blocks]``) of physical block ids, and the
  paged decode step (``models/llama.py`` ``paged_forward``) reaches K/V
  through it. Physical block 0 is the **null block**: never allocated, the
  write target for inactive ride-along rows and the read target for
  unallocated table tail entries (masked by position, so its contents are
  value-invisible — the same argument as padded prefill tails).

* **Host allocator** — :class:`BlockPool` refcounts physical blocks.
  Prefix reuse is block-level sharing: full blocks of prefill-built prompt
  ids register under a trie of chain ids (tuple-exact, no collisions), a
  new prompt walks the chain and shares every matching physical block
  (refcount++, zero prefill work). Shared blocks are full and positions
  only advance, so a shared block is never written in place; the tail of
  the match is copy-on-write — the best partially-matching registered
  block is copied into a fresh block, then the new sequence overwrites its
  own rows from the divergence point. Retired sequences' registered blocks
  park in an LRU "cached" state: still shareable until allocation pressure
  evicts them. Only prefill-built tokens register.

The allocator is pure host bookkeeping and behaves call for call like the
JAX package's ``BlockPool`` with no host tier (``tests/test_torch_kvblocks.py``
replays one op sequence on both); :meth:`BlockPool.alloc` fires the
``kv_alloc`` failpoint, whose ``raise`` is an injected exhaustion. Left out:
the host tier (spill to pinned host memory, page-in).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch

from . import failpoints
from .kvcache import padded_cache_len

# the root chain id of every prefix trie (the empty prefix)
_ROOT = 0


class BlockPoolExhausted(RuntimeError):
    """No free or evictable block is available. The batch scheduler treats
    this as back-pressure — the request stays queued, never a crash."""


def validate_block_size(seq_len: int, block_size: int) -> None:
    """``--kv-block-size`` validation: power of two, and it must tile the
    padded physical context exactly (every power of two <= 128 does; larger
    sizes must divide the padded row count)."""
    padded = padded_cache_len(seq_len)
    if block_size < 1 or block_size & (block_size - 1):
        raise ValueError(
            f"--kv-block-size must be a power of two, got {block_size}")
    if block_size > padded or padded % block_size:
        raise ValueError(
            f"--kv-block-size {block_size} must tile the padded context "
            f"({padded} rows for seq_len {seq_len}); use a power of two "
            f"<= {min(padded, 128)} or a divisor of {padded}")


def blocks_per_seq(seq_len: int, block_size: int) -> int:
    """Block-table width: blocks covering the padded physical context."""
    return padded_cache_len(seq_len) // block_size


class PagedKVCache(NamedTuple):
    """Device-side block pool: ``[L, n_blocks, n_kv, block_size, hd]``."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg, n_blocks: int, block_size: int,
               dtype=torch.float32, device="cpu") -> "PagedKVCache":
        shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


class BlockPool:
    """Refcounted physical-block allocator with block-level prefix sharing.

    States of a physical block (id ``1..n_blocks-1``; 0 is the null block):

    * **free** — on the free list; contents meaningless.
    * **live** — refcount >= 1; owned by that many sequences. A block with
      refcount > 1 is *shared* and is never a write target.
    * **cached** — refcount 0 but registered in the prefix index; contents
      preserved for future sharing until LRU eviction recycles it.

    Not thread-safe on its own — the batch scheduler's loop thread owns it.
    """

    NULL = 0

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 null + 1 usable), "
                             f"got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.reset()

    # -- accounting ----------------------------------------------------------

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def free_blocks(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    def used_blocks(self) -> int:
        """Blocks held by live sequences (refcount >= 1)."""
        return self.n_blocks - 1 - self.free_blocks()

    def shared_blocks(self) -> int:
        """Physical blocks referenced by more than one live sequence."""
        return sum(1 for r in self._ref[1:] if r > 1)

    # -- alloc / free --------------------------------------------------------

    def alloc(self) -> int:
        """One fresh block (refcount 1). When the free list is dry the LRU
        cached block is evicted (unregistered) and reused; raises
        :class:`BlockPoolExhausted` when nothing is allocatable, including
        through the ``kv_alloc`` failpoint (injected exhaustion)."""
        try:
            failpoints.fire("kv_alloc")
        except failpoints.FailpointError as e:
            raise BlockPoolExhausted(f"injected block-pool exhaustion: {e}") from e
        if self._free:
            bid = self._free.pop()
        elif self._cached:
            bid, _ = self._cached.popitem(last=False)  # LRU
            self._unregister(bid)
        else:
            raise BlockPoolExhausted(
                f"KV block pool exhausted ({self.n_blocks - 1} blocks, "
                f"block size {self.block_size}) — request stays queued")
        assert self._ref[bid] == 0, (bid, self._ref[bid])
        self._ref[bid] = 1
        return bid

    def share(self, bid: int) -> None:
        """Take one more reference on a live or cached block."""
        if bid == self.NULL:
            raise ValueError("cannot share the null block")
        if self._ref[bid] == 0:
            if bid not in self._cached:
                raise ValueError(f"block {bid} is free, not shareable")
            del self._cached[bid]
        self._ref[bid] += 1

    def release(self, bid: int) -> None:
        """Drop one reference. At zero, a registered block parks in the
        cached LRU (still shareable); an unregistered one returns to the
        free list. Releasing a free block is a double free and raises."""
        if bid == self.NULL:
            raise ValueError("cannot release the null block")
        if self._ref[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if bid in self._meta:
                self._cached[bid] = None  # most-recently-used end
            else:
                self._free.append(bid)

    def reset(self) -> None:
        """Forget everything (crash recovery): all blocks free, the prefix
        index cleared so nothing can match rows a half-finished dispatch may
        have corrupted."""
        self._ref = [0] * self.n_blocks
        # LIFO free list: recently freed (cache-warm) blocks recycle first
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU, oldest first
        # prefix index as a trie over integer chain ids: node key =
        # (parent_chain_id, block_tokens), so a lookup hashes one block's
        # tokens; matching stays tuple-exact
        self._nodes: dict[tuple, tuple[int, int]] = {}  # (pcid, blk) -> (cid, bid)
        self._by_parent: dict[int, list[int]] = {}      # pcid -> candidate tails
        self._meta: dict[int, tuple] = {}               # bid -> (kind, pcid, tokens)
        self._next_cid = 1  # 0 is _ROOT (the empty prefix)

    # -- prefix sharing ------------------------------------------------------

    def register_prompt(self, bids: list[int], tokens: list[int]) -> None:
        """Index a committed prompt's blocks for future sharing. ``tokens``
        are the prefill-built prompt ids (``prompt_ids[:-1]``); ``bids`` must
        cover them. Full blocks chain into the exact-match trie; a partial
        tail block registers as a copy-on-write candidate under its parent
        chain. Blocks already registered (shared prefixes) are skipped."""
        bs = self.block_size
        n_full, tail = divmod(len(tokens), bs)
        cid = _ROOT
        for j in range(n_full):
            blk = tuple(tokens[j * bs:(j + 1) * bs])
            node = self._nodes.get((cid, blk))
            if node is not None:
                cid = node[0]  # chain already indexed (shared or duplicate)
                continue
            bid = bids[j]
            if bid in self._meta:
                continue  # registered under a different chain: skip it
            new_cid = self._next_cid
            self._next_cid += 1
            self._nodes[(cid, blk)] = (new_cid, bid)
            self._by_parent.setdefault(cid, []).append(bid)
            self._meta[bid] = ("full", cid, blk)
            cid = new_cid
        if tail:
            bid = bids[n_full]
            if bid not in self._meta:
                self._by_parent.setdefault(cid, []).append(bid)
                self._meta[bid] = ("partial", cid, tuple(tokens[n_full * bs:]))

    def _unregister(self, bid: int) -> None:
        kind, pcid, blk = self._meta.pop(bid)
        if kind == "full":
            node = self._nodes.get((pcid, blk))
            if node is not None and node[1] == bid:
                # descendants become unreachable (match stops at the gap)
                # but each still owns one node entry, freed with its block
                del self._nodes[(pcid, blk)]
        sibs = self._by_parent.get(pcid)
        if sibs is not None:
            if bid in sibs:
                sibs.remove(bid)
            if not sibs:
                del self._by_parent[pcid]

    def match_prefix(self, tokens) -> tuple[list[int], int, int | None, int]:
        """Longest block-level match of ``tokens`` against the index:
        ``(shared_bids, n_shared_tokens, cow_src_bid, cow_tokens)``.

        ``shared_bids`` are full blocks covering ``n_shared_tokens`` (a
        multiple of block_size) — the caller :meth:`share`\\ s them (no
        refcounts are taken here). ``cow_src_bid``, when not None, is the
        registered block whose first ``cow_tokens`` ids extend the match —
        the caller allocates a fresh block, copies the source into it, and
        resumes prefill at ``n_shared_tokens + cow_tokens``."""
        bs = self.block_size
        cid = _ROOT
        shared: list[int] = []
        i = 0
        while i + bs <= len(tokens):
            node = self._nodes.get((cid, tuple(tokens[i:i + bs])))
            if node is None:
                break
            cid, bid = node
            shared.append(bid)
            i += bs
        tail = tuple(tokens[i:])
        best_bid, best_r = None, 0
        if tail:
            for bid in self._by_parent.get(cid, ()):
                cand = self._meta[bid][2]
                r = 0
                for a, b in zip(tail, cand):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best_bid, best_r = bid, r
        return shared, i, best_bid, best_r
