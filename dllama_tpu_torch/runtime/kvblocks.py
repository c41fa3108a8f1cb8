"""Block-granular paged KV cache — allocator, device pool and host tier (the
port of the JAX package's ``runtime/kvblocks.py``).

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

* **Host tier** — with ``n_host_blocks > 0`` (``--kv-host-blocks``) the
  cached LRU becomes a *spill point* instead of a drop point: under
  allocation pressure the coldest cached blocks move to host memory
  (:class:`HostKVMirror`, chunks of :data:`SPILL_BATCH` blocks) and their
  prefix-trie registrations follow them to host ids ``n_blocks ..
  n_blocks + n_host_blocks - 1``. A later prefix-matched admission (a
  resumed session) pages them back in: fresh device blocks, the host bytes
  restored bit for bit, the trie rebound to the device ids — no prefill
  again. A logical block lives in exactly one tier; host blocks are never
  refcounted live, never write targets and never in a block table. A
  failed spill degrades to the drop-evict contract; a failed page-in
  (:class:`PageInError`) fails only the resuming request.

The allocator is pure host bookkeeping and behaves call for call like the
JAX package's ``BlockPool`` (``tests/test_torch_kvblocks.py`` replays one op
sequence on both, with and without a host tier); the device<->host copies
run through the ``spill_fn``/``host_drop_fn``/``host_room_fn`` hooks the
generator installs. :meth:`BlockPool.alloc` fires the ``kv_alloc``
failpoint, whose ``raise`` is an injected exhaustion.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple

import torch

from . import failpoints
from .kvcache import padded_cache_len

# the root chain id of every prefix trie (the empty prefix)
_ROOT = 0

# blocks per batched device<->host copy and per HostKVMirror chunk (the JAX
# package's width, so the two pools' spills and chunk caps agree)
SPILL_BATCH = 4


class BlockPoolExhausted(RuntimeError):
    """No free or evictable block is available. The batch scheduler treats
    this as back-pressure — the request stays queued, never a crash."""


class PageInError(RuntimeError):
    """A host->device page-in failed (the ``pagein`` failpoint, or a real
    copy error). Fails ONLY the resuming request, 503-shaped — the host
    copies stay intact and bystander slots keep decoding."""


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

    @property
    def pools(self) -> list["PagedKVCache"]:
        """The pools of the shards: this one."""
        return [self]

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``l``'s ``[n_blocks, n_kv, block_size, hd]`` pools."""
        return self.k[l], self.v[l]


class ShardedPagedKVCache(NamedTuple):
    """The block pool split over kv heads in ``tp`` shards (the JAX
    package's ``paged_kv_sharding``): ``shards[j]`` is a
    :class:`PagedKVCache` ``[L, n_blocks, n_kv_l, block_size, hd]`` on
    ``devices[j]`` with the heads ``parallel.sharding.kv_heads(cfg, tp, j)``.
    Every shard has the same blocks: one :class:`BlockPool` and one set of
    block tables address them all, and a block copy touches each shard."""

    shards: list[PagedKVCache]

    @classmethod
    def create(cls, cfg, devices, n_blocks: int, block_size: int,
               dtype=torch.float32) -> "ShardedPagedKVCache":
        from ..parallel.sharding import local_kv_heads

        shape = (cfg.n_layers, n_blocks, local_kv_heads(cfg, len(devices)), block_size,
                 cfg.head_dim)
        return cls([PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=d),
                                 v=torch.zeros(shape, dtype=dtype, device=d))
                    for d in devices])

    @property
    def pools(self) -> list[PagedKVCache]:
        return list(self.shards)

    def layer(self, l: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Layer ``l``'s per-shard pools."""
        return [s.k[l] for s in self.shards], [s.v[l] for s in self.shards]


class _ChunkBuf:
    """One host chunk buffer: the K and V planes of :data:`SPILL_BATCH`
    blocks, and (on a card) the event its last device->host copy recorded."""

    __slots__ = ("k", "v", "stored")

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k, self.v = k, v
        self.stored = None


def _host_unregister(slab: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(slab.data_ptr())


class HostKVMirror:
    """Host-DRAM side of the KV tier: chunk-granular storage for spilled
    blocks and the device<->host copies.

    A spill moves up to :data:`SPILL_BATCH` blocks in one hop:
    ``models.llama.gather_kv_blocks`` pulls them out of the pool into a
    device staging chunk on the compute stream, and a side stream copies
    the chunk into a host chunk buffer behind an event (the staging tensor
    is held for the side stream with ``record_stream``, so the pool may
    reuse the source blocks at once and nothing waits on the host). A
    page-in makes the compute stream wait for that chunk's copy event,
    brings the chunk back on the compute stream and scatters it into fresh
    device blocks IN PLACE (``models.llama.scatter_kv_blocks``; unwanted
    lanes to the null block), so it lands before the next graph replay;
    a host buffer is written again only by a later spill, whose side-stream
    copy waits for an event recorded on the compute stream after every
    earlier page-in read it. A logical block is host- OR device-resident,
    never both.

    The host buffers are one slab, allocated once at :meth:`warmup` for all
    ``max_chunks`` and sliced into chunks, so the mirror holds exactly the
    bytes :func:`~dllama_tpu_torch.runtime.hbm.fit_host_pool` priced
    (``host_bytes``). On a card the slab is page-locked in place with
    ``cudaHostRegister``: ``pin_memory=True`` goes through PyTorch's caching
    host allocator, which rounds each block up to a power of two, and
    ``cudaHostAlloc`` mid-serving would stall the card. On the CPU it is an
    ordinary tensor — the same code, the device decides (``kind`` is
    ``"pinned"`` or ``"cpu"``). The
    JAX mirror re-warms its transfer programs once the pool's sharding
    settles (``_tier_rewarm``: XLA keys executables on input sharding);
    eager torch copies key on nothing, so there is no counterpart here.

    Owned by the paged generator (the loop thread), like the pool it mirrors.
    """

    def __init__(self, max_chunks: int = 0):
        # the HARD host-RAM bound, in chunks: a chunk is SPILL_BATCH blocks
        # of buffer whether or not every lane is live, so the budget is
        # counted in chunks, not lanes. At the cap has_room refuses and the
        # spill degrades to drop-evict. 0 = uncapped (buffers made on demand;
        # tests driving the mirror directly)
        self.max_chunks = max(0, max_chunks)
        self.kind: str | None = None  # "pinned" | "cpu", set by warmup
        self._chunks: dict[int, dict] = {}            # cid -> {"buf", "live"}
        self._where: dict[int, tuple[int, int]] = {}  # host bid -> (cid, lane)
        self._next_cid = 0
        self._idle: list[_ChunkBuf] = []  # host buffers no chunk holds
        self.host_bytes = 0               # the warmed slab's size
        self._geom: tuple | None = None   # (device, chunk shape, dtype)
        self._side = None                 # the copy stream on a card

    def has_room(self) -> bool:
        """Whether a new spill chunk fits the chunk-accounted budget."""
        return not self.max_chunks or len(self._chunks) < self.max_chunks

    @staticmethod
    def _pad_ids(bids: list[int]) -> list[int]:
        return list(bids) + [0] * (SPILL_BATCH - len(bids))  # pad = null block

    def _new_buf(self) -> _ChunkBuf:
        # uncapped mirrors only: a capped one draws from its warmed slab
        device, shape, dtype = self._geom
        pin = device.type == "cuda"
        return _ChunkBuf(torch.empty(shape, dtype=dtype, pin_memory=pin),
                         torch.empty(shape, dtype=dtype, pin_memory=pin))

    def _alloc_slab(self) -> torch.Tensor:
        """Every chunk's K and V planes in one host tensor ``[max_chunks, 2,
        *chunk]``, page-locked in place on a card."""
        device, shape, dtype = self._geom
        slab = torch.empty((self.max_chunks, 2, *shape), dtype=dtype)
        if device.type == "cuda" and slab.numel():
            err = int(torch.cuda.cudart().cudaHostRegister(slab.data_ptr(), slab.nbytes, 0))
            if err:
                raise RuntimeError(f"host KV tier: cudaHostRegister of {slab.nbytes} bytes "
                                   f"failed with cudaError {err}")
            # unregister before the slab's memory goes back to the allocator
            weakref.finalize(self, _host_unregister, slab)
        return slab

    def warmup(self, pkv: "PagedKVCache") -> None:  # owner: loop thread
        """Allocate every host chunk buffer the budget allows and run both
        hops once on the null block, so the first spill under pressure is a
        copy, never an allocation. Raises if the host memory or a copy
        fails: a tier that was asked for is never quietly absent."""
        from .kvcache import cache_bits

        bits = cache_bits(pkv.k)
        device = bits.device
        shape = (bits.shape[0], SPILL_BATCH, *bits.shape[2:])
        self._geom = (device, shape, bits.dtype)
        self.kind = "pinned" if device.type == "cuda" else "cpu"
        if device.type == "cuda":
            self._side = torch.cuda.Stream(device=device)
        slab = self._alloc_slab()
        self.host_bytes = slab.nbytes
        self._idle = [_ChunkBuf(slab[i, 0], slab[i, 1]) for i in range(self.max_chunks)]
        self.store(pkv, [0], [-1])
        self.load(pkv, [(-1, 0)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def store(self, pkv: "PagedKVCache", dev_bids: list[int],
              host_bids: list[int]) -> None:  # owner: loop thread
        """One spill batch: gather ``dev_bids`` from the pool and park the
        chunk under ``host_bids``' lanes. Never synchronises the host."""
        from ..models.llama import gather_kv_blocks

        buf = self._idle.pop() if self._idle else self._new_buf()
        try:
            ck, cv = gather_kv_blocks(pkv, self._pad_ids(dev_bids))
            if self._side is None:
                buf.k.copy_(ck)
                buf.v.copy_(cv)
            else:
                # the side stream copies once the gather has run (and, with
                # it, every earlier page-in that read this buffer)
                self._side.wait_stream(torch.cuda.current_stream(ck.device))
                with torch.cuda.stream(self._side):
                    buf.k.copy_(ck, non_blocking=True)
                    buf.v.copy_(cv, non_blocking=True)
                    ck.record_stream(self._side)
                    cv.record_stream(self._side)
                    buf.stored = torch.cuda.Event()
                    buf.stored.record(self._side)
        except BaseException:
            self._idle.append(buf)
            raise
        cid = self._next_cid
        self._next_cid += 1
        self._chunks[cid] = {"buf": buf, "live": set(host_bids)}
        for lane, hb in enumerate(host_bids):
            self._where[hb] = (cid, lane)

    def load(self, pkv: "PagedKVCache", pairs: list[tuple[int, int]]) -> None:  # owner: loop thread
        """One page-in batch: restore each ``(host_bid, dev_bid)`` pair's
        content into the pool (one host->device copy and one scatter per
        touched chunk) and free the lanes. Every copy runs before the lane
        bookkeeping changes, so a failed batch leaves the lanes intact and
        consistent with the pool's restored host pins: a retry finds its
        content. (The scatter writes only the fresh blocks the page-in
        allocated, so a partial batch harms nothing.)"""
        from ..models.llama import scatter_kv_blocks

        by_chunk: dict[int, list[tuple[int, int, int]]] = {}
        for hb, dev in pairs:
            cid, lane = self._where[hb]
            by_chunk.setdefault(cid, []).append((hb, lane, dev))
        for cid, entries in by_chunk.items():
            buf = self._chunks[cid]["buf"]
            ids = [0] * SPILL_BATCH  # all null: unwanted lanes are no-ops
            for _, lane, dev in entries:
                ids[lane] = dev
            if buf.stored is not None:
                torch.cuda.current_stream(pkv.k.device).wait_event(buf.stored)
            scatter_kv_blocks(pkv, buf.k, buf.v, ids)
        for cid, entries in by_chunk.items():
            ch = self._chunks[cid]
            for hb, _, _ in entries:
                del self._where[hb]
                ch["live"].discard(hb)
            if not ch["live"]:
                self._release(cid)

    def _release(self, cid: int) -> None:
        self._idle.append(self._chunks.pop(cid)["buf"])

    def drop(self, host_bids: list[int]) -> None:  # owner: loop thread
        """Forget lanes the pool evicted from the host LRU (their content is
        gone for good — the tier's own drop-evict under host pressure)."""
        for hb in host_bids:
            loc = self._where.pop(hb, None)
            if loc is None:
                continue
            ch = self._chunks.get(loc[0])
            if ch is not None:
                ch["live"].discard(hb)
                if not ch["live"]:
                    self._release(loc[0])

    def drop_all(self) -> None:  # owner: loop thread
        """Crash recovery twin of :meth:`BlockPool.reset`."""
        for cid in list(self._chunks):
            self._release(cid)
        self._where.clear()

    def lane(self, host_bid: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The host bytes of one spilled block, ``(k, v)`` each ``[L, n_kv,
        bs, hd]`` (tests and the on-card check read them)."""
        cid, lane = self._where[host_bid]
        buf = self._chunks[cid]["buf"]
        if buf.stored is not None:
            buf.stored.synchronize()
        return buf.k[:, lane], buf.v[:, lane]


class BlockPool:
    """Refcounted physical-block allocator with block-level prefix sharing
    and an optional host tier.

    States of a physical block (id ``1..n_blocks-1``; 0 is the null block):

    * **free** — on the free list; contents meaningless.
    * **live** — refcount >= 1; owned by that many sequences. A block with
      refcount > 1 is *shared* and is never a write target.
    * **cached** — refcount 0 but registered in the prefix index; contents
      preserved for future sharing until LRU pressure spills (host tier) or
      evicts it.

    Host ids ``n_blocks..n_blocks+n_host_blocks-1`` hold spilled cold
    registered content only: refcount 0, never write targets, never in a
    block table — a prefix match returning a host id is the page-in signal.

    Not thread-safe on its own — the batch scheduler's loop thread owns it.
    """

    NULL = 0

    def __init__(self, n_blocks: int, block_size: int, n_host_blocks: int = 0):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 null + 1 usable), "
                             f"got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_host_blocks = max(0, n_host_blocks)
        # installed by the generator (the only component that touches the
        # device): spill_fn(dev_bids, host_bids) -> bool runs the batched
        # device->host copy (False/raise = degrade to drop-evict);
        # host_drop_fn(host_bids) makes the mirror forget lanes the host LRU
        # evicted for good; host_room_fn() -> bool says whether the
        # mirror's chunk budget has room for one more spill chunk
        self.spill_fn = None
        self.host_drop_fn = None
        self.host_room_fn = None
        self.reset()

    # -- accounting ----------------------------------------------------------

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def is_host(self, bid: int) -> bool:
        """Whether ``bid`` is a host-tier id (cold content in the mirror;
        paged in before it can be shared or attended)."""
        return bid >= self.n_blocks

    def free_blocks(self) -> int:
        """DEVICE blocks allocatable right now (free + evictable cached; with
        a host tier the cached ones spill instead of dropping, reclaimable
        either way). Host-resident blocks are not device capacity."""
        return len(self._free) + len(self._cached)

    def used_blocks(self) -> int:
        """Device blocks held by live sequences (refcount >= 1)."""
        return self.n_blocks - 1 - self.free_blocks()

    def shared_blocks(self) -> int:
        """Physical blocks referenced by more than one live sequence."""
        return sum(1 for r in self._ref[1:] if r > 1)

    def host_total_blocks(self) -> int:
        return self.n_host_blocks

    def host_used_blocks(self) -> int:
        """Host-tier blocks holding spilled (cold, registered) content."""
        return self.n_host_blocks - len(self._host_free)

    # -- alloc / free --------------------------------------------------------

    def alloc(self) -> int:
        """One fresh DEVICE block (refcount 1). When the free list is dry,
        pressure resolves against the cached LRU: with a host tier armed
        the coldest cached blocks SPILL to host (content survives for a
        later page-in); without one, or when the spill fails, the LRU cached
        block is dropped (evicted + unregistered). Raises
        :class:`BlockPoolExhausted` when nothing is allocatable, including
        through the ``kv_alloc`` failpoint (injected exhaustion)."""
        try:
            failpoints.fire("kv_alloc")
        except failpoints.FailpointError as e:
            raise BlockPoolExhausted(f"injected block-pool exhaustion: {e}") from e
        if not self._free and self._cached:
            self._try_spill()
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
        """Take one more reference on a live or cached DEVICE block (a
        host-resident block is paged in first)."""
        if bid == self.NULL:
            raise ValueError("cannot share the null block")
        if self.is_host(bid):
            raise ValueError(f"block {bid} is host-resident — page it in "
                             f"before sharing")
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
        if self.is_host(bid):
            raise ValueError(f"block {bid} is host-resident (never "
                             f"refcounted live)")
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
        have corrupted. Host-tier bookkeeping clears too (the generator drops
        the mirror's buffers alongside)."""
        self._ref = [0] * (self.n_blocks + self.n_host_blocks)
        # LIFO free list: recently freed (cache-warm) blocks recycle first
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU, oldest first
        self._host_free = list(range(self.n_blocks + self.n_host_blocks - 1,
                                     self.n_blocks - 1, -1))
        self._host_cached: OrderedDict[int, None] = OrderedDict()  # host LRU
        # prefix index as a trie over integer chain ids: node key =
        # (parent_chain_id, block_tokens), so a lookup hashes one block's
        # tokens; matching stays tuple-exact
        self._nodes: dict[tuple, tuple[int, int]] = {}  # (pcid, blk) -> (cid, bid)
        self._by_parent: dict[int, list[int]] = {}      # pcid -> candidate tails
        self._meta: dict[int, tuple] = {}               # bid -> (kind, pcid, tokens)
        self._next_cid = 1  # 0 is _ROOT (the empty prefix)

    # -- tiering: spill (device->host) and page-in (host->device) -----------

    def _rebind(self, old_bid: int, new_bid: int) -> None:
        """Move one registered block's identity (trie node, CoW candidacy,
        meta) from ``old_bid`` to ``new_bid``; chain ids are untouched, so
        the chain matches exactly the same prompts afterwards."""
        kind, pcid, blk = self._meta.pop(old_bid)
        self._meta[new_bid] = (kind, pcid, blk)
        if kind == "full":
            node = self._nodes.get((pcid, blk))
            if node is not None and node[1] == old_bid:
                self._nodes[(pcid, blk)] = (node[0], new_bid)
        sibs = self._by_parent.get(pcid)
        if sibs is not None:
            for i, b in enumerate(sibs):
                if b == old_bid:
                    sibs[i] = new_bid
                    break

    def _try_spill(self) -> None:
        """Spill up to :data:`SPILL_BATCH` LRU cached device blocks to the
        host tier through ``spill_fn``. Chunk-budget room first (a spill the
        mirror would refuse must not cost the oldest idle sessions their
        KV; draining the host LRU oldest first eventually frees a whole
        fragmented chunk), then lane room (the host LRU drops for real). Any
        failure leaves the cached set untouched; the caller falls back to
        drop-evict."""
        if self.spill_fn is None or not self.n_host_blocks:
            return
        want = min(SPILL_BATCH, len(self._cached))

        def drop_host_lru() -> bool:
            if not self._host_cached:
                return False
            victim, _ = self._host_cached.popitem(last=False)
            self._unregister(victim)
            self._host_free.append(victim)
            if self.host_drop_fn is not None:
                # per victim, so the mirror frees a chunk the moment its last
                # lane dies — host_room_fn watches for that
                self.host_drop_fn([victim])
            return True

        if self.host_room_fn is not None:
            while not self.host_room_fn():
                if not drop_host_lru():
                    return
        while len(self._host_free) < want and self._host_cached:
            drop_host_lru()
        want = min(want, len(self._host_free))
        if want <= 0:
            return
        devs = [b for b, _ in zip(self._cached, range(want))]  # LRU first
        hosts = [self._host_free.pop() for _ in range(want)]
        try:
            ok = bool(self.spill_fn(devs, hosts))
        except Exception:  # noqa: BLE001 — degrade to drop-evict, never crash alloc
            ok = False
        if not ok:
            self._host_free.extend(reversed(hosts))
            return
        for dev, host in zip(devs, hosts):
            del self._cached[dev]
            self._rebind(dev, host)
            self._host_cached[host] = None  # MRU end
            self._free.append(dev)

    def begin_pagein(self, host_bids: list[int]) -> list[tuple[int, int]]:
        """Stage a page-in of ``host_bids`` (host-resident registered
        blocks): pin each out of the host LRU (so a concurrent spill's
        host-room eviction can't drop it) and allocate one fresh device
        block per entry, which may itself spill OTHER cold blocks. Returns
        ``(host_bid, dev_bid)`` pairs; the caller copies the content, then
        :meth:`commit_pagein` or :meth:`abort_pagein`. Atomic: exhaustion
        midway rolls everything back and re-raises (the request stays
        queued)."""
        pairs: list[tuple[int, int]] = []
        pinned: list[int] = []
        try:
            for hb in host_bids:
                if not self.is_host(hb) or hb not in self._host_cached:
                    raise ValueError(f"block {hb} is not host-resident")
                del self._host_cached[hb]  # pin across the allocs below
                pinned.append(hb)
            for hb in pinned:
                pairs.append((hb, self.alloc()))
        except BaseException:
            for _, dev in pairs:
                self.release(dev)
            for hb in pinned:
                self._host_cached[hb] = None
            raise
        return pairs

    def commit_pagein(self, pairs: list[tuple[int, int]]) -> None:
        """The copies landed: rebind each registration host->device and
        return the host lanes to the free list. The device blocks keep the
        refcount 1 taken in :meth:`begin_pagein` (the caller owns them like
        freshly shared blocks)."""
        for hb, dev in pairs:
            self._rebind(hb, dev)
            self._host_free.append(hb)

    def abort_pagein(self, pairs: list[tuple[int, int]]) -> None:
        """The copies failed: free the device blocks (their content never
        materialised) and unpin the host blocks — content intact, still
        registered, a retry can page them in again."""
        for hb, dev in pairs:
            self.release(dev)
            self._host_cached[hb] = None

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
