"""The port's numerics observatory (``dllama_tpu_torch.runtime.numerics``:
activation taps, the non-finite tripwire with its ``logits`` poison and
fail-fast, the canary, the quant audit and ``/debug/numerics``) on the CPU,
mirroring ``tests/test_numerics.py`` and held against the JAX package on
the same files.

Tapped logits equal untapped ones bit for bit; the taps equal the JAX
engine's within rtol 1e-5 (f32; the frameworks sum in other orders); the
poisoned steps' non-finite counts equal the JAX package's guarded steps'
exactly (NaN and Inf modes, decode, chunk, verify, ragged and paged
steps); the audit's numbers equal JAX's ``audit_model`` on the same file
(the same numpy codecs: exactly, but for float sums within 1e-12)."""

from __future__ import annotations

import json
import math
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile, tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.runtime import numerics as jax_numerics
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import numerics
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import KVCache
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_torch_model import _configs, _pair

TAP_RTOL = 1e-5
VOCAB = 268


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.registry().clear()
    yield
    fp.registry().clear()


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_numerics")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=VOCAB, seq_len=96),
                     np.random.default_rng(17))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


def _engine(model_files, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("seed", 3)
    return InferenceEngine(*model_files, device="cpu", **kw)


def _nf(site: str) -> int:
    return tm.registry().counter(tm.NONFINITE).total(site=site)


# -- activation taps --------------------------------------------------------------


def test_tapped_forward_is_bit_identical_and_stats_shaped(model_files):
    plain = _engine(model_files)
    tapped = _engine(model_files, numerics_taps=True)
    try:
        ids = plain.tokenizer.encode("hello world", is_start=True)
        lp, _ = plain.prefill(ids)
        lt, _ = tapped.prefill(ids)
        np.testing.assert_array_equal(lp, lt)
        taps = numerics.debug_snapshot(tapped)["taps"]
        assert sorted(taps) == sorted(numerics.TAP_SITES)
        for site in ("attn_out", "mlp_out"):
            assert len(taps[site]["rms"]) == tapped.cfg.n_layers
            assert taps[site]["nonfinite"] == 0
            assert all(v > 0 for v in taps[site]["rms"])
            assert all(v > 0 for v in taps[site]["q80_err"])
        assert taps["logits"]["nonfinite"] == 0
        reg = tm.registry()
        assert reg.gauge(tm.ACTIVATION_RMS).value(site="mlp_out") > 0
        assert reg.gauge(tm.ACTIVATION_ABSMAX).value(site="logits") > 0
        assert reg.gauge(tm.Q80_ROUNDTRIP_ERROR).value(site="attn_out") > 0
        assert numerics.debug_snapshot(tapped)["taps_enabled"] is True
    finally:
        plain.close()
        tapped.close()


@pytest.mark.parametrize("sync", ["f32", "q80"])
def test_taps_match_jax(model_files, sync):
    """The same prompt's per-layer taps, port against the JAX engine."""
    from dllama_tpu.formats.quants import F32, Q80

    st = F32 if sync == "f32" else Q80
    jeng = JaxEngine(*model_files, tp=1, numerics_taps=True, sync_type=st)
    eng = _engine(model_files, numerics_taps=True, sync_type=st)
    try:
        ids = eng.tokenizer.encode("hello there world, taps", is_start=True)
        jeng.prefill(ids)
        want = jax_numerics.debug_snapshot(jeng)["taps"]
        eng.prefill(ids)
        got = numerics.debug_snapshot(eng)["taps"]
        assert sorted(got) == sorted(want)
        for site in numerics.TAP_SITES:
            assert got[site]["nonfinite"] == want[site]["nonfinite"], site
            for stat in ("rms", "absmax", "q80_err"):
                np.testing.assert_allclose(got[site][stat], want[site][stat], rtol=TAP_RTOL,
                                           err_msg=f"{site}.{stat}")
    finally:
        jeng.close()
        eng.close()


def test_paged_forward_refuses_taps(model_files):
    cfg, _ = _configs("llama", "float32", True)
    with numerics.collecting_taps(), pytest.raises(ValueError, match="paged KV"):
        llama.paged_forward(None, cfg, torch.zeros((1, 1), dtype=torch.long),
                            torch.zeros(1), None, torch.zeros((1, 1)))


# -- the poisoned steps against the JAX guarded steps ----------------------------

PROMPT = [3, 17, 42, 7, 90, 1, 50, 64]


def _pair_kv(cfg, jcfg, B=1):
    return KVCache.create(cfg, batch_size=B), JaxKVCache.create(jcfg, batch_size=B)


@pytest.mark.parametrize("mode", ["nan", "inf", "clean"])
def test_single_sequence_step_counts_equal_jax(mode):
    """greedy_step / sampled_step / greedy_steps / verify_step with the poison
    selector: the per-row non-finite counts equal the JAX guarded steps'."""
    code = {"nan": 1.0, "inf": 2.0, "clean": 0.0}[mode]
    cfg, jcfg = _configs("llama", "float32", True)
    jparams, params = _pair(cfg, jcfg, seed=5)
    kv, jkv = _pair_kv(cfg, jcfg)
    tok, nf, kv = llama.greedy_step(params, cfg, torch.tensor([PROMPT]), 0, kv, poison=code)
    (jtok, jnf), jkv = jax_llama.greedy_step_guarded(
        jparams, jcfg, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), jkv, jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [cfg.vocab_size if code else 0]
    if not code:
        assert tok.tolist() == np.asarray(jtok).tolist()
    p = len(PROMPT)
    _, nf, kv = llama.sampled_step(params, cfg, torch.tensor([[5]]), p, kv, 0.9, 0.9, 0.4,
                                   poison=code)
    (_, jnf), jkv = jax_llama.sampled_step_guarded(
        jparams, jcfg, jnp.asarray([[5]], jnp.int32), jnp.int32(p), jkv, jnp.float32(0.9),
        jnp.float32(0.9), jnp.float32(0.4), jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist()
    toks, nf, kv = llama.greedy_steps(params, cfg, torch.tensor([5]), p + 1, kv, 3,
                                      poison=code)
    (jtoks, jnf), jkv = jax_llama.greedy_steps_guarded(
        jparams, jcfg, jnp.asarray([5], jnp.int32), jnp.int32(p + 1), jkv, 3,
        jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [3 * cfg.vocab_size if code else 0]
    n_acc, preds, nf, kv = llama.verify_step(params, cfg, torch.tensor([[5, 6, 7]]), p + 4, kv,
                                             poison=code)
    (jn, jp, jnf), jkv = jax_llama.verify_step_guarded(
        jparams, jcfg, jnp.asarray([[5, 6, 7]], jnp.int32), jnp.int32(p + 4), jkv,
        jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [3 * cfg.vocab_size if code else 0]


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_ragged_and_paged_step_counts_equal_jax(mode):
    """The dense pool's ragged steps and the paged step with the poison
    selector as a device scalar (the captured steps' form): every row's
    count equals the JAX guarded steps'."""
    from dllama_tpu.runtime.kvblocks import PagedKVCache as JaxPagedKVCache
    from dllama_tpu_torch.runtime.kvblocks import PagedKVCache

    code = {"nan": 1.0, "inf": 2.0}[mode]
    cfg, jcfg = _configs("llama", "float32", True)
    jparams, params = _pair(cfg, jcfg, seed=5)
    B = 3
    kv, jkv = _pair_kv(cfg, jcfg, B)
    toks = np.array([[4], [9], [77]])
    pos = np.array([0, 5, 11])
    temps = np.array([0.0, 0.8, 0.0], np.float32)
    topps = np.full(B, 0.9, np.float32)
    coins = np.array([0.1, 0.5, 0.9], np.float32)
    poison = torch.tensor([code])
    _, nf = llama.ragged_sampled_step(params, cfg, torch.from_numpy(toks),
                                      torch.from_numpy(pos), kv, torch.from_numpy(temps),
                                      torch.from_numpy(topps), torch.from_numpy(coins), poison)
    (_, jnf), _ = jax_llama.sampled_step_guarded(
        jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32), jkv,
        jnp.asarray(temps), jnp.asarray(topps), jnp.asarray(coins), jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [cfg.vocab_size] * B
    vt = np.array([[4, 5, 6], [9, 9, 9], [77, 1, 2]])
    _, _, nf = llama.ragged_verify_step(params, cfg, torch.from_numpy(vt),
                                        torch.from_numpy(pos), kv, torch.from_numpy(temps),
                                        torch.from_numpy(topps), torch.from_numpy(coins), poison)
    (_, _, jnf), _ = jax_llama.ragged_verify_step_guarded(
        jparams, jcfg, jnp.asarray(vt, jnp.int32), jnp.asarray(pos, jnp.int32), jkv,
        jnp.asarray(temps), jnp.asarray(topps), jnp.asarray(coins), jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [3 * cfg.vocab_size] * B
    bs, n_blocks = 16, 1 + B * (cfg.seq_len // 16)
    pkv = PagedKVCache.create(cfg, n_blocks, bs)
    jpkv = JaxPagedKVCache.create(jcfg, n_blocks, bs)
    tables = np.zeros((B, cfg.seq_len // bs), np.int64)
    tables[:, 0] = [1, 2, 3]
    _, nf = llama.paged_sampled_step(params, cfg, torch.from_numpy(toks),
                                     torch.from_numpy(pos), pkv, torch.from_numpy(tables),
                                     torch.from_numpy(temps), torch.from_numpy(topps),
                                     torch.from_numpy(coins), poison)
    (_, jnf), _ = jax_llama.paged_sampled_step_guarded(
        jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32), jpkv,
        jnp.asarray(tables, jnp.int32), jnp.asarray(temps), jnp.asarray(topps),
        jnp.asarray(coins), jnp.float32(code))
    assert nf.tolist() == np.asarray(jnf).tolist() == [cfg.vocab_size] * B


def test_poison_codes_at_and_past_three_pass_clean():
    """Codes >= 3 belong to the JAX package's wire failpoint: the logits
    pass through untouched (``_poison_logits``), as in JAX."""
    x = torch.randn(2, 5)
    for code in (3.0, 4.0, torch.tensor([3.0])):
        assert torch.equal(llama._poison_logits(x, code), x)
    assert torch.isnan(llama._poison_logits(x, torch.tensor([1.0]))).all()
    assert torch.isinf(llama._poison_logits(x, 2.0)).all()


# -- the engine's tripwire ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["nan", "inf"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_logits_failpoint_poisons_decode_and_counts(model_files, mode, temperature):
    """Armed ``logits:nonfinite`` → the decode step counts the poisoned
    dispatch (site=decode) while the default mode still emits a token; the
    failpoint's fire is counted; clean steps don't count."""
    eng = _engine(model_files, temperature=temperature)
    fired = tm.registry().counter(tm.FAILPOINTS_FIRED)
    before, f0 = _nf("decode"), fired.total(name="logits")
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        fp.arm("logits", "nonfinite", times=1, mode=mode)
        tok = eng.next_token(ids[-1])
        assert 0 <= tok < eng.cfg.vocab_size
        assert _nf("decode") == before + 1
        assert fired.total(name="logits") == f0 + 1
        eng.next_token(tok)
        assert _nf("decode") == before + 1
        assert numerics.debug_snapshot(eng)["last_nonfinite_lanes"]["decode"] == VOCAB
    finally:
        eng.close()


def test_failfast_raises_numerics_error_naming_site(model_files):
    eng = _engine(model_files, numerics_failfast=True)
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        fp.arm("logits", "nonfinite", times=1)
        with pytest.raises(numerics.NumericsError, match="site=decode"):
            eng.next_token(ids[-1])
        tok = eng.next_token(ids[-1])  # the failpoint consumed itself
        assert 0 <= tok < eng.cfg.vocab_size
    finally:
        eng.close()


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_tripwire_covers_chunked_and_verify_dispatches(model_files, mode):
    eng = _engine(model_files, decode_chunk=4)
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        d0 = _nf("decode")
        fp.arm("logits", "nonfinite", times=1, mode=mode)
        assert len(eng.decode_chunk_tokens(ids[-1], 4)) == 4
        assert _nf("decode") == d0 + 1
        assert numerics.debug_snapshot(eng)["last_nonfinite_lanes"]["decode"] == 4 * VOCAB
    finally:
        eng.close()
    eng = _engine(model_files, spec_lookup=2)
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        v0 = _nf("verify")
        fp.arm("logits", "nonfinite", times=1, mode=mode)
        run = eng.speculative_tokens(ids[-1], [1, 2])
        assert 1 <= len(run) <= 3
        assert _nf("verify") == v0 + 1
    finally:
        eng.close()
    eng = _engine(model_files, spec_lookup=2, numerics_failfast=True)
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        fp.arm("logits", "nonfinite", times=1, mode=mode)
        with pytest.raises(numerics.NumericsError, match="site=verify"):
            eng.speculative_tokens(ids[-1], [1, 2])
    finally:
        eng.close()


def test_sp_chunk_carries_the_tripwire(model_files):
    """At sp = 2 the chunked decode runs eagerly (``greedy_steps``) with the
    same count."""
    eng = _engine(model_files, sp=2, decode_chunk=2)
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        eng.prefill(ids[:-1])
        d0 = _nf("decode")
        fp.arm("logits", "nonfinite", times=1)
        eng.decode_chunk_tokens(ids[-1], 2)
        assert _nf("decode") == d0 + 1
    finally:
        eng.close()


# -- the generators' tripwire ---------------------------------------------------------


def _enc(eng, text="hello world"):
    return eng.tokenizer.encode(text, is_start=True)


@pytest.mark.parametrize("shape", [{}, {"kv_block_size": 16},
                                   {"kv_block_size": 16, "spec_lookup": 2},
                                   {"spec_lookup": 2}, {"decode_chunk": 2}])
def test_batched_logits_failpoint_counts_without_failfast(model_files, shape):
    """One poisoned batched dispatch counts at site=batch and still emits the
    (garbage) tokens: observable, not behavior-changing."""
    eng = _engine(model_files, **shape)
    sched = BatchScheduler(eng, n_slots=2)
    b0 = _nf("batch")
    try:
        fp.arm("logits", "nonfinite", times=1)
        req = sched.submit(_enc(eng), 4, stop_on_eos=False)
        assert req.done.wait(timeout=60)
        assert req.error is None and len(req.tokens) == 4
        assert _nf("batch") == b0 + 1
    finally:
        sched.close()
        eng.close()


@pytest.mark.parametrize("mode", ["nan", "inf"])
@pytest.mark.parametrize("shape", [{}, {"kv_block_size": 16},
                                   {"kv_block_size": 16, "spec_lookup": 2}])
def test_batched_failfast_fails_the_poisoned_request_alone(model_files, mode, shape):
    """Fail-fast armed → the poisoned request dies with the explicit numerics
    error (server_error: HTTP 503-shaped) naming site=batch, its slot is
    reclaimed, and the next requests serve."""
    eng = _engine(model_files, numerics_failfast=True, **shape)
    sched = BatchScheduler(eng, n_slots=2)
    b0 = _nf("batch")
    try:
        fp.arm("logits", "nonfinite", times=1, mode=mode)
        req = sched.submit(_enc(eng), 8, stop_on_eos=False)
        assert req.done.wait(timeout=60)
        assert req.error is not None and "site=batch" in req.error and req.server_error
        assert _nf("batch") == b0 + 1
        oks = [sched.submit(_enc(eng, t), 4, stop_on_eos=False) for t in ("abc", "xyz")]
        for ok in oks:
            assert ok.done.wait(timeout=60)
            assert ok.error is None and len(ok.tokens) == 4
    finally:
        sched.close()
        eng.close()


# -- captured steps: the poison is a device scalar written per replay -----------------


def test_decode_and_verify_graphs_carry_poison_and_counts(model_files):
    from dllama_tpu_torch.runtime.graphs import DecodeGraph, VerifyGraph

    eng = _engine(model_files)
    try:
        eng.prefill(PROMPT)
        g = DecodeGraph(eng.params, eng.cfg, eng.kv, eng.device, sampled=False, pos=eng.pos)
        g.launch(5, eng.pos, 3, poison=1.0)
        assert len(g.tokens()) == 3 and g.nonfinite == 3 * VOCAB
        g.launch(5, eng.pos, 2)
        g.tokens()
        assert g.nonfinite == 0
        v = VerifyGraph(eng.params, eng.cfg, eng.kv, eng.device, width=3, pos=eng.pos)
        n_acc, preds, nf = v.run([5, 6, 7], eng.pos, poison=2.0)
        assert len(preds) == 3 and nf == 3 * VOCAB
        assert v.run([5, 6, 7], eng.pos)[2] == 0
    finally:
        eng.close()


# -- golden canary drift sentinel ---------------------------------------------------


def test_canary_clean_replay_does_not_drift(model_files):
    eng = _engine(model_files, numerics_taps=True)
    try:
        c = numerics.CanarySentinel(eng, interval_s=0.0)
        c.ensure_golden()
        drift0 = tm.registry().counter(tm.CANARY_DRIFT).total()
        for _ in range(3):
            assert c.run()["drift"] is False
        assert tm.registry().counter(tm.CANARY_DRIFT).total() == drift0
        st = c.status()
        assert st["golden_recorded"] and st["runs"] >= 3 and st["drifts"] == 0
        assert st["canary_width"] == eng.prefill_buckets[-1] == 32
        assert eng.pos == 0  # the replay leaves the engine's sequence alone
    finally:
        eng.close()


@pytest.mark.parametrize("layer", [0, 1])
def test_canary_detects_patched_weight_and_names_layer(model_files, capsys, layer):
    eng = _engine(model_files, numerics_taps=True)
    try:
        c = numerics.CanarySentinel(eng, interval_s=0.0)
        c.ensure_golden()
        assert c.run()["drift"] is False
        eng.params.layers[layer].norm_ffn.mul_(3.0)  # patched in place
        drift0 = tm.registry().counter(tm.CANARY_DRIFT).total()
        res = c.run()
        assert res["drift"] is True
        assert res["divergent_layer"] == f"layer {layer} (mlp_out)"
        assert tm.registry().counter(tm.CANARY_DRIFT).total() == drift0 + 1
        out = capsys.readouterr().out
        assert "canary drift" in out and f"layer {layer} (mlp_out)" in out
    finally:
        eng.close()


def test_canary_without_taps_detects_but_cannot_name(model_files):
    eng = _engine(model_files)
    try:
        c = numerics.CanarySentinel(eng, interval_s=0.0)
        c.ensure_golden()
        eng.params.final_norm.mul_(1.5)
        res = c.run()
        assert res["drift"] is True and res["divergent_layer"] is None
    finally:
        eng.close()


def test_canary_maybe_run_respects_interval(model_files):
    eng = _engine(model_files)
    try:
        c = numerics.CanarySentinel(eng, interval_s=3600.0)
        c.ensure_golden()
        runs0 = c.runs
        assert c.maybe_run() is None
        assert c.runs == runs0
    finally:
        eng.close()


def test_canary_rejected_under_multihost(model_files):
    eng = _engine(model_files)
    try:
        eng.multihost = True
        with pytest.raises(ValueError, match="single-host"):
            numerics.CanarySentinel(eng)
    finally:
        eng.close()


def test_scheduler_tick_replays_the_canary(model_files):
    eng = _engine(model_files, kv_block_size=16)
    eng.canary = numerics.CanarySentinel(eng, interval_s=0.0)
    eng.canary.ensure_golden()
    sched = BatchScheduler(eng, n_slots=2)
    try:
        req = sched.submit(_enc(eng), 6, stop_on_eos=False)
        assert req.done.wait(timeout=60) and req.error is None
        st = eng.canary.status()
        assert st["runs"] >= 2 and st["drifts"] == 0
    finally:
        sched.close()
        eng.close()


# -- offline quant-error audit ---------------------------------------------------------


def _audit_rows_equal(got: dict, want: dict) -> None:
    assert got["tensors"] == want["tensors"]
    assert got["nonfinite_tensors"] == want["nonfinite_tensors"]
    assert got["min_snr_db"] == pytest.approx(want["min_snr_db"], rel=1e-12)
    for g, w in zip(got["rows"], want["rows"]):
        assert sorted(g) == sorted(w), g["tensor"]
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-12, abs=1e-30), (g["tensor"], k)
            else:
                assert g[k] == v, (g["tensor"], k)


def test_audit_scores_healthy_model_equal_to_jax(model_files):
    res = numerics.audit_model(model_files[0], emit=None)
    _audit_rows_equal(res, jax_numerics.audit_model(model_files[0], emit=None))
    assert res["tensors"] > 0 and res["nonfinite_tensors"] == []
    by_name = {r["tensor"]: r for r in res["rows"]}
    w1 = by_name["block_matmul_w1.0"]
    assert w1["type"] == "q40" and w1["scale_nonfinite"] == 0
    assert w1["q40_exact"] is True and w1["q40_mse"] == 0.0
    emb = by_name["embedding"]
    assert emb["type"] == "f32" and emb["q40_snr_db"] > 0
    assert res["min_snr_db"] is not None and res["min_snr_db"] > 0
    assert tm.registry().gauge(tm.QUANT_AUDIT_MIN_SNR).value() == pytest.approx(
        res["min_snr_db"])


def test_audit_flags_nonfinite_scale_naming_tensor(model_files, tmp_path):
    import shutil

    broken = tmp_path / "broken.m"
    shutil.copy(model_files[0], broken)
    with mfile.ModelFile.open(str(broken)) as mf:
        rec = mf.tensors["block_matmul_w2.1"]
    with open(broken, "r+b") as f:
        f.seek(rec.offset)  # the first block's f16 scale → +Inf (0x7C00)
        f.write(bytes([0x00, 0x7C]))
    audit_nf = tm.registry().counter(tm.QUANT_AUDIT_NONFINITE)
    before = audit_nf.total()
    res = numerics.audit_model(str(broken), emit=None)
    _audit_rows_equal(res, jax_numerics.audit_model(str(broken), emit=None))
    assert "block_matmul_w2.1" in res["nonfinite_tensors"]
    row = {r["tensor"]: r for r in res["rows"]}["block_matmul_w2.1"]
    assert row["nonfinite"] > 0 and row["scale_nonfinite"] == 1
    assert audit_nf.total() > before
    assert cli.main(["audit", "--model", str(broken), "--audit-json"]) == 1


@pytest.mark.parametrize("kind", ["q40", "q80", "f32", "f32_nonfinite"])
def test_audit_tensor_over_several_slices_equals_jax(kind):
    """A tensor longer than the port's audit slice: the sliced float64 sums
    equal the JAX module's whole-tensor sums to rel 1e-12."""
    from dllama_tpu_torch.formats import quants as q

    n = 2 * numerics._AUDIT_SLICE + 4096
    x = np.random.default_rng(29).standard_normal(n).astype(np.float32) * 0.05
    if kind == "f32_nonfinite":
        x[[7, numerics._AUDIT_SLICE + 3]] = [np.nan, np.inf]
    ftype = {"q40": q.Q40, "q80": q.Q80}.get(kind, q.F32)
    buf = q.encode_tensor(x, ftype)
    dense = {"q40": lambda: q.dequantize_q40(buf, n),
             "q80": lambda: q.dequantize_q80(buf, n)}.get(kind, lambda: x)()
    rec = type("Rec", (), {"float_type": ftype})()
    got = numerics.audit_tensor("w", rec, buf, dense=dense)
    want = jax_numerics.audit_tensor("w", rec, buf, dense=dense)
    _audit_rows_equal({"tensors": 1, "nonfinite_tensors": [], "min_snr_db": 1.0,
                       "rows": [got]},
                      {"tensors": 1, "nonfinite_tensors": [], "min_snr_db": 1.0,
                       "rows": [want]})
    assert got["nonfinite"] == (2 if kind == "f32_nonfinite" else 0)


def test_audit_cli_mode(model_files, capsys):
    rc = cli.main(["audit", "--model", model_files[0], "--audit-json"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert data["tensors"] > 0 and data["nonfinite_tensors"] == []
    rc = cli.main(["audit", "--model", model_files[0]])
    out = capsys.readouterr().out
    assert rc == 0 and "quant audit" in out and "block_matmul_w1.0" in out


# -- the API: /debug/numerics, fail-fast, the canary at startup ---------------------------


def _serve(files, *extra):
    m, t = files
    started = threading.Event()
    box = {}

    def on_listening(srv, state):
        box["server"], box["state"] = srv, state
        started.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0",
         "--temperature", "0", "--seed", "3", *extra], on_listening=on_listening)),
        daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    return box, th, f"http://127.0.0.1:{box['server'].server_address[1]}"


def _stop(box, th):
    box["server"].shutdown()
    th.join(timeout=60)
    assert box.get("rc") == 0


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


BODY = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}


def test_debug_numerics_endpoint_canary_and_stats_markers(model_files):
    box, th, url = _serve(model_files, "--canary-interval", "0.001", "--numerics-taps")
    try:
        assert _post(url, BODY)[0] == 200
        with urllib.request.urlopen(url + "/debug/numerics", timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["canary"]["golden_recorded"] is True
        assert snap["canary"]["runs"] >= 2  # the golden, then the piggyback replay
        assert snap["canary"]["drifts"] == 0
        assert snap["taps_enabled"] is True and sorted(snap["taps"]) == sorted(
            numerics.TAP_SITES)
        assert tm.registry().counter(tm.HTTP_REQUESTS).total(route="/debug/numerics",
                                                             status="200") >= 1
    finally:
        _stop(box, th)
    reg = tm.registry()
    reg.counter(tm.NONFINITE).inc(site="decode")
    reg.counter(tm.CANARY_DRIFT).inc()
    line = tm.stats_line(reg)
    assert "nonfinite=" in line and line.split("nonfinite=")[1][0].isdigit()
    assert "!" in line.split("drift=")[1][:4]


def test_single_api_failfast_answers_500_naming_the_site(model_files):
    box, th, url = _serve(model_files, "--numerics-failfast")
    try:
        fp.arm("logits", "nonfinite", times=1)
        code, body = _post(url, BODY)
        assert code == 500 and "site=decode" in body["error"]
        assert _post(url, BODY)[0] == 200
    finally:
        _stop(box, th)


@pytest.mark.parametrize("extra", [["--batch-slots", "2"],
                                   ["--batch-slots", "2", "--kv-block-size", "16"]])
def test_batched_api_failfast_answers_503_for_the_poisoned_request(model_files, extra):
    box, th, url = _serve(model_files, "--numerics-failfast", "--canary-interval", "0.001",
                          *extra)
    try:
        fp.arm("logits", "nonfinite", times=1, mode="inf")
        code, body = _post(url, BODY)
        assert code == 503 and "site=batch" in body["error"]
        assert _post(url, BODY)[0] == 200
        assert box["state"].engine.canary.status()["drifts"] == 0
    finally:
        _stop(box, th)


def test_first_divergent_layer_ordering():
    def mk(rms):
        return {"rms": list(rms), "absmax": [0.0] * len(rms), "nonfinite": 0,
                "q80_err": [0.0] * len(rms)}

    golden = {"attn_out": mk([1.0, 1.0]), "mlp_out": mk([2.0, 2.0]),
              "final_norm": mk([3.0]), "logits": mk([4.0])}
    drifted = {"attn_out": mk([1.0, 1.5]), "mlp_out": mk([2.0, 9.0]),
               "final_norm": mk([3.0]), "logits": mk([4.0])}
    assert numerics.first_divergent_layer(drifted, golden) == "layer 1 (attn_out)"
    assert numerics.first_divergent_layer(golden, golden) is None
    head_only = {k: (mk([3.0]) if k == "final_norm" else golden[k]) for k in golden}
    head_only["logits"] = mk([9.0])
    assert numerics.first_divergent_layer(head_only, golden) == "logits"
    assert math.isfinite(numerics.check_nonfinite(np.zeros(3), "decode"))
