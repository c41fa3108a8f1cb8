"""The port's block allocator against the JAX package's, call for call: one
seeded random sequence of ``alloc``/``share``/``release``/
``register_prompt``/``match_prefix``/``reset`` replayed on both
``BlockPool``s (the JAX one without a host tier), with identical return
values, exceptions, refcounts and free/used/shared counts after every call.
Plus ``validate_block_size``, ``blocks_per_seq``, the pool geometry and the
block-pool byte formula. Host-only bookkeeping: exact equality throughout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.runtime import hbm as jax_hbm
from dllama_tpu.runtime import kvblocks as jkb
from dllama_tpu_torch.runtime import kvblocks as tkb

N_BLOCKS, BS = 12, 4


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raise", exception class name, message)``."""
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError) as e:
        return ("raise", type(e).__name__, str(e))


def _state(pool) -> tuple:
    return (tuple(pool.refcount(b) for b in range(pool.n_blocks)),
            pool.free_blocks(), pool.used_blocks(), pool.shared_blocks())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replayed_op_sequence_matches_jax_pool(seed):
    rng = np.random.default_rng(seed)
    jp, tp = jkb.BlockPool(N_BLOCKS, BS), tkb.BlockPool(N_BLOCKS, BS)
    held: list[int] = []      # live references taken through alloc/share
    # a small alphabet of prompts with common prefixes, so matches, shares
    # and copy-on-write candidates happen
    stems = [list(rng.integers(0, 5, 12)) for _ in range(3)]
    n_raise = n_match = 0
    for step in range(600):
        op = rng.choice(["alloc", "share", "release", "register", "match", "bad",
                         "reset"], p=[0.3, 0.15, 0.25, 0.1, 0.15, 0.04, 0.01])
        if op == "alloc":
            calls = [("alloc",)]
        elif op == "share":
            cands = held + list(range(N_BLOCKS))  # live, cached or free
            calls = [("share", int(rng.choice(cands)))]
        elif op == "release":
            if held and rng.random() < 0.9:
                b = held.pop(int(rng.integers(len(held))))
            else:
                b = int(rng.integers(0, N_BLOCKS))  # maybe a double free
            calls = [("release", b)]
        elif op == "register":
            stem = stems[int(rng.integers(3))]
            toks = [int(t) for t in stem[:int(rng.integers(1, 13))]]
            n = -(-len(toks) // BS)
            live = [b for b in dict.fromkeys(held)]
            if len(live) < n:
                continue
            calls = [("register_prompt", live[:n], toks)]
        elif op == "match":
            stem = stems[int(rng.integers(3))]
            toks = [int(t) for t in stem[:int(rng.integers(0, 13))]]
            toks += [int(t) for t in rng.integers(0, 5, int(rng.integers(0, 3)))]
            calls = [("match_prefix", toks)]
        elif op == "bad":
            calls = [("share", 0), ("release", 0)]
        else:
            calls = [("reset",)]
            held.clear()
        for name, *args in calls:
            want = _outcome(getattr(jp, name), *args)
            got = _outcome(getattr(tp, name), *args)
            assert got == want, (step, name, args)
            if want[0] == "raise":
                n_raise += 1
            elif name == "alloc" or name == "share":
                held.append(args[0] if args else want[1])
            elif name == "match_prefix" and want[1][1]:
                n_match += 1
            assert _state(tp) == _state(jp), (step, name, args)
    # the sequence really exercised exhaustion/double frees and prefix hits
    assert n_raise > 5 and n_match > 5


def test_copy_on_write_candidate_and_lru_eviction_match_jax():
    """A partial tail registers as a CoW candidate; released registered
    blocks park in the LRU and are evicted oldest first — the same ids on
    both pools."""
    jp, tp = jkb.BlockPool(5, BS), tkb.BlockPool(5, BS)
    for pool in (jp, tp):
        a, b = pool.alloc(), pool.alloc()
        pool.register_prompt([a, b], [1, 2, 3, 4, 5, 6])
        pool.release(a)
        pool.release(b)
    assert tp.match_prefix([1, 2, 3, 4, 5, 9]) == jp.match_prefix([1, 2, 3, 4, 5, 9])
    assert tp.match_prefix([1, 2, 3, 4, 5, 9])[2] is not None  # a CoW source
    got = [tp.alloc() for _ in range(4)]
    assert got == [jp.alloc() for _ in range(4)]
    with pytest.raises(tkb.BlockPoolExhausted):
        tp.alloc()
    with pytest.raises(jkb.BlockPoolExhausted):
        jp.alloc()
    assert tp.match_prefix([1, 2, 3, 4]) == jp.match_prefix([1, 2, 3, 4]) == ([], 0, None, 0)


@pytest.mark.parametrize("seq_len,bs", [(96, 16), (96, 32), (96, 128), (2048, 16),
                                        (2048, 256), (100, 8), (96, 24), (96, 512),
                                        (96, 0), (2048, 3)])
def test_validate_block_size_and_blocks_per_seq_match_jax(seq_len, bs):
    assert _outcome(tkb.validate_block_size, seq_len, bs) == \
        _outcome(jkb.validate_block_size, seq_len, bs)
    if _outcome(jkb.validate_block_size, seq_len, bs)[0] == "ok":
        assert tkb.blocks_per_seq(seq_len, bs) == jkb.blocks_per_seq(seq_len, bs)


def test_pool_geometry_and_bytes():
    """``PagedKVCache`` is ``[L, n_blocks, n_kv, bs, hd]`` zeros at the
    asked dtype, and its size is the JAX package's block-pool formula."""
    from dllama_tpu_torch.formats import mfile
    from dllama_tpu_torch.models.config import ModelConfig

    kw = dict(dim=64, hidden_dim=128, n_layers=3, n_heads=4, n_kv_heads=2,
              head_dim=16, vocab_size=96, seq_len=64, norm_epsilon=1e-5,
              rope_theta=1e4)
    cfg = ModelConfig(arch=mfile.ArchType.LLAMA, rope_type=mfile.RopeType.LLAMA, **kw)
    jcfg = JaxConfig(arch=jax_mfile.ArchType.LLAMA, rope_type=jax_mfile.RopeType.LLAMA,
                     **kw)
    pkv = tkb.PagedKVCache.create(cfg, 9, 16, dtype=torch.bfloat16)
    assert pkv.k.shape == (3, 9, 2, 16, 16) and pkv.k.dtype == torch.bfloat16
    assert pkv.n_blocks == 9 and pkv.block_size == 16
    assert not pkv.v.any()
    from dllama_tpu_torch.runtime.hbm import estimate_block_pool_bytes

    nbytes = pkv.k.numel() * 2 * pkv.k.element_size()
    assert estimate_block_pool_bytes(cfg, 9, 16, 2) == nbytes
    assert estimate_block_pool_bytes(cfg, 9, 16, 2) == jax_hbm.estimate_block_pool_bytes(
        jcfg, 9, 16, 2)


# -- the host tier: the same scripts with n_host_blocks > 0 -------------------

N_HOST = 8


class _ChunkStub:
    """The mirror's bookkeeping without tensors, one per pool: spills land in
    chunks of ``SPILL_BATCH`` lanes, a chunk dies with its last live lane,
    and ``has_room`` caps the resident chunks (``max_chunks``). ``fail``
    makes the next spill refuse (a failed copy)."""

    def __init__(self, max_chunks: int):
        self.max_chunks = max_chunks
        self.chunks: dict[int, set] = {}
        self.where: dict[int, int] = {}
        self.next = 0
        self.fail = False
        self.log: list = []

    def spill(self, devs, hosts) -> bool:
        self.log.append(("spill", list(devs), list(hosts)))
        if self.fail:
            self.fail = False
            return False
        self.chunks[self.next] = set(hosts)
        for h in hosts:
            self.where[h] = self.next
        self.next += 1
        return True

    def _forget(self, h) -> None:
        cid = self.where.pop(h, None)
        if cid is not None:
            self.chunks[cid].discard(h)
            if not self.chunks[cid]:
                del self.chunks[cid]

    def drop(self, hosts) -> None:
        self.log.append(("drop", list(hosts)))
        for h in hosts:
            self._forget(h)

    def load(self, pairs) -> None:
        for h, _ in pairs:
            self._forget(h)

    def has_room(self) -> bool:
        return len(self.chunks) < self.max_chunks


def _tiered(mod, max_chunks: int):
    pool = mod.BlockPool(N_BLOCKS, BS, n_host_blocks=N_HOST)
    stub = _ChunkStub(max_chunks)
    pool.spill_fn, pool.host_drop_fn, pool.host_room_fn = stub.spill, stub.drop, stub.has_room
    return pool, stub


def _tier_state(pool, stub) -> tuple:
    return (_state(pool), tuple(pool.refcount(b) for b in range(pool.n_blocks + N_HOST)),
            pool.host_used_blocks(), tuple(pool._host_cached), tuple(pool._cached),
            sorted(map(sorted, stub.chunks.values())), tuple(map(str, stub.log)))


from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), max_chunks=st.sampled_from([1, 2, 3]))
def test_tiered_op_script_matches_jax_pool(seed, max_chunks):
    """A seeded alloc/free/share/CoW/spill/page-in script on both pools
    with a host tier and stub hooks: the same return values and
    exceptions, ids, refcounts, device and host residency, ``match_prefix``
    answers, spill and drop calls, and resident chunks under the cap."""
    rng = np.random.default_rng(seed)
    (jp, js), (tp, ts) = _tiered(jkb, max_chunks), _tiered(tkb, max_chunks)
    held: list[int] = []
    pending: list = []  # staged page-ins: (pairs, commit?)
    stems = [list(rng.integers(0, 4, 14)) for _ in range(3)]
    for step in range(300):
        op = rng.choice(["alloc", "share", "release", "register", "match", "pagein",
                         "spillfail", "reset"],
                        p=[0.36, 0.06, 0.2, 0.14, 0.08, 0.12, 0.03, 0.01])
        if op == "alloc":
            calls = [("alloc",)]
        elif op == "share":
            calls = [("share", int(rng.integers(0, N_BLOCKS + N_HOST)))]
        elif op == "release":
            b = (held.pop(int(rng.integers(len(held)))) if held and rng.random() < 0.9
                 else int(rng.integers(0, N_BLOCKS + N_HOST)))
            calls = [("release", b)]
        elif op == "register":
            stem = stems[int(rng.integers(3))]
            toks = [int(t) for t in stem[:int(rng.integers(1, 15))]]
            live = list(dict.fromkeys(held))
            if len(live) < -(-len(toks) // BS):
                continue
            calls = [("register_prompt", live[:-(-len(toks) // BS)], toks)]
        elif op == "match":
            stem = stems[int(rng.integers(3))]
            calls = [("match_prefix", [int(t) for t in stem[:int(rng.integers(0, 15))]])]
        elif op == "pagein":
            stem = stems[int(rng.integers(3))]
            shared = jp.match_prefix([int(t) for t in stem])[0]
            hosts = [b for b in shared if jp.is_host(b)]
            if not hosts:
                continue
            calls = [("begin_pagein", hosts)]
        elif op == "spillfail":
            js.fail = ts.fail = True
            continue
        else:
            calls = [("reset",)]
            held.clear()
            for s in (js, ts):
                s.chunks.clear()
                s.where.clear()
        for name, *args in calls:
            want = _outcome(getattr(jp, name), *args)
            got = _outcome(getattr(tp, name), *args)
            assert got == want, (step, name, args)
            if want[0] == "ok" and name in ("alloc", "share"):
                held.append(args[0] if args else want[1])
            if want[0] == "ok" and name == "begin_pagein":
                pairs = want[1]
                if rng.random() < 0.7:  # the copies landed
                    for pool, stub in ((jp, js), (tp, ts)):
                        stub.load(pairs)
                        pool.commit_pagein(pairs)
                    held.extend(dev for _, dev in pairs)
                else:
                    for pool in (jp, tp):
                        pool.abort_pagein(pairs)
            assert _tier_state(tp, ts) == _tier_state(jp, js), (step, name, args)
            assert len(ts.chunks) <= max_chunks
    # the script really spilled, dropped at the chunk cap and paged back in
    assert any(e[0] == "spill" for e in js.log)


def test_host_tier_spill_rebinds_and_pages_back_like_jax():
    """One hand-made scenario on both pools: a registered prompt spills
    under pressure (its trie node rebinds to host ids), a match returns
    the host ids, a page-in restores device ids in the same order, and a
    failed spill drops the LRU block instead."""
    for fail in (False, True):
        out = []
        for mod in (jkb, tkb):
            pool, stub = _tiered(mod, 4)
            a, b = pool.alloc(), pool.alloc()
            pool.register_prompt([a, b], [1, 2, 3, 4, 5, 6, 7, 8])
            pool.release(a)
            pool.release(b)
            stub.fail = fail
            taken = [pool.alloc() for _ in range(N_BLOCKS - 1)]
            m = pool.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 9])
            rec = [taken, m, pool.host_used_blocks()]
            if m[0] and all(pool.is_host(x) for x in m[0]):
                pool.release(taken[0])
                pool.release(taken[1])
                pairs = pool.begin_pagein(m[0])
                pool.commit_pagein(pairs)
                rec += [pairs, pool.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 9]),
                        pool.host_used_blocks()]
            out.append(rec)
        assert out[0] == out[1]
        assert (out[0][2] == 2) is (not fail)
