"""The port's device-memory guard (``dllama_tpu_torch.runtime.hbm``, the
engine's pre-staging check, the pools' fit and the submit-time admission
guard) on the CPU, mirroring ``tests/test_hbm.py`` and the HBM cases of
``tests/test_chaos.py``: the estimates equal the JAX package's for the same
configurations (byte for byte: the same shape algebra), the fits equal its
fits, and under ``DLLAMA_HBM_BYTES`` a model is refused before staging, a
pool shrinks, and a prompt is refused at submit with the JAX status (503,
code ``queue_full``) and ``dllama_hbm_admission_rejects_total``."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from dllama_tpu.formats import mfile, tfile
from dllama_tpu.models import ModelConfig as JaxModelConfig
from dllama_tpu.runtime import hbm as jax_hbm
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.runtime import hbm
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import (BatchedGenerator, BatchScheduler,
                                              HbmAdmissionError, PagedGenerator)
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

GB = 1024 ** 3


def _base(**kw):
    base = dict(arch=mfile.ArchType.LLAMA, dim=4096, hidden_dim=14336, n_layers=32,
                n_heads=32, n_kv_heads=8, head_dim=128, vocab_size=128256, seq_len=1024,
                norm_epsilon=1e-5, rope_theta=500000.0, rope_type=mfile.RopeType.LLAMA)
    base.update(kw)
    return base


def _cfgs(**kw):
    """The same configuration as the port's and the JAX package's config."""
    from dllama_tpu_torch.formats import mfile as tmfile

    jax = JaxModelConfig(**_base(**kw))
    port_kw = _base(**kw)
    port_kw["arch"] = tmfile.ArchType(int(port_kw["arch"]))
    port_kw["rope_type"] = tmfile.RopeType(int(port_kw["rope_type"]))
    return ModelConfig(**port_kw), jax


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("DLLAMA_HBM_BYTES", raising=False)
    monkeypatch.delenv("DLLAMA_SKIP_HBM_CHECK", raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_hbm")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(23))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


# -- the estimates against the JAX package's ----------------------------------------


@pytest.mark.parametrize("repr_", ["q40", "q80", "bf16", "f32"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bytes,batch", [(4, 1), (2, 9), (1, 3), (2, 1)])
def test_estimate_equals_jax(repr_, compute, kv_bytes, batch):
    port, jax = _cfgs(compute_dtype=compute)
    kw = dict(weight_repr=repr_, kv_dtype_bytes=kv_bytes, batch=batch)
    assert hbm.estimate_device_bytes(port, **kw) == jax_hbm.estimate_device_bytes(jax, **kw)


def test_weight_count_and_small_estimates_equal_jax():
    port, jax = _cfgs()
    assert hbm.matmul_weight_count(port) == jax_hbm.matmul_weight_count(jax)
    assert 7e9 < hbm.matmul_weight_count(port) < 9e9
    for t in (32, 64, 128, 256, 2048):
        assert hbm.estimate_prefill_temp_bytes(port, t) == \
            jax_hbm.estimate_prefill_temp_bytes(jax, t)
    assert hbm.estimate_prefill_temp_bytes(port, 256) == \
        8 * hbm.estimate_prefill_temp_bytes(port, 32)
    assert hbm.estimate_block_pool_bytes(port, 1000, 16, 2) == \
        jax_hbm.estimate_block_pool_bytes(jax, 1000, 16, 2)


def test_8b_q40_fits_16gb_and_f32_refuses(monkeypatch):
    port, _ = _cfgs()
    est = hbm.estimate_device_bytes(port, weight_repr="q40", kv_dtype_bytes=2)
    assert est["need_per_device"] < 16 * GB and est["weights_bytes"] > 8e9
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(16 * GB))
    est = hbm.estimate_device_bytes(port, weight_repr="f32", kv_dtype_bytes=2)
    with pytest.raises(RuntimeError, match="refusing to stage"):
        hbm.check_budget(est["need_per_device"], "test model")
    monkeypatch.setenv("DLLAMA_SKIP_HBM_CHECK", "1")
    assert hbm.check_budget(est["need_per_device"], "test model") is None


def test_70b_q40_refuses_one_80gb_card(monkeypatch):
    # the planes hold int8 codes (1.125 B a weight): 70B needs ~90 GB
    port, _ = _cfgs(dim=8192, hidden_dim=28672, n_layers=80, n_heads=64)
    est = hbm.estimate_device_bytes(port, weight_repr="q40", kv_dtype_bytes=2)
    for limit_gb in (16, 80):
        monkeypatch.setenv("DLLAMA_HBM_BYTES", str(limit_gb * GB))
        with pytest.raises(RuntimeError, match="refusing to stage"):
            hbm.check_budget(est["need_per_device"], "70B")
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(128 * GB))
    assert hbm.check_budget(est["need_per_device"], "70B") == 128 * GB


def test_device_memory_limit_sources(monkeypatch):
    assert hbm.device_memory_bytes("cpu") is None  # a CPU device: unknown
    monkeypatch.setenv("DLLAMA_HBM_BYTES", "123456")
    assert hbm.device_memory_bytes() == hbm.device_memory_bytes("cpu") == 123456


# -- the fits against the JAX package's ------------------------------------------------


@pytest.mark.parametrize("limit_gb", [12, 14, 20, 40])
def test_fit_batch_slots_equal_jax(monkeypatch, limit_gb):
    port, jax = _cfgs(seq_len=2048)
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(limit_gb * GB))
    for want in (64, 7):
        kw = dict(weight_repr="q40", kv_dtype_bytes=4)
        got = hbm.fit_batch_slots(port, want, **kw)
        assert got == jax_hbm.fit_batch_slots(jax, want, **kw)
        if got[0]:
            assert got[1]["need_per_device"] <= limit_gb * GB and got[0] <= want


def test_fit_batch_slots_degrades_slot_by_slot(monkeypatch):
    port, _ = _cfgs(dim=512, hidden_dim=1024, n_layers=4, vocab_size=2048, n_heads=8,
                    n_kv_heads=4, head_dim=64, seq_len=512)
    kw = dict(weight_repr="q40", kv_dtype_bytes=4)
    # 5 slots charge a batch of 6 (the engine's own cache stays beside the pool)
    need = [hbm.estimate_device_bytes(port, batch=b, **kw)["need_per_device"]
            for b in (6, 7)]
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(sum(need) // 2))
    n, est = hbm.fit_batch_slots(port, 8, **kw)
    assert n == 5 and est["need_per_device"] <= sum(need) // 2
    monkeypatch.setenv("DLLAMA_HBM_BYTES", "1000")
    assert hbm.fit_batch_slots(port, 8, **kw)[0] == 0
    monkeypatch.delenv("DLLAMA_HBM_BYTES")
    assert hbm.fit_batch_slots(port, 8, **kw)[0] == 8
    monkeypatch.setenv("DLLAMA_HBM_BYTES", "1000")
    monkeypatch.setenv("DLLAMA_SKIP_HBM_CHECK", "1")
    assert hbm.fit_batch_slots(port, 8, **kw)[0] == 8


@pytest.mark.parametrize("limit_gb", [11, 13, 30, 200])
def test_fit_block_pool_equal_jax(monkeypatch, limit_gb):
    port, jax = _cfgs(seq_len=2048)
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(limit_gb * GB))
    kw = dict(block_size=16, min_blocks=129, weight_repr="q40", kv_dtype_bytes=2)
    got = hbm.fit_block_pool(port, 8 * 128 + 1, **kw)
    assert got == jax_hbm.fit_block_pool(jax, 8 * 128 + 1, **kw)


def test_admission_check_uses_measured_bytes_and_extra(monkeypatch):
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(1_000_000))
    assert hbm.admission_check(need_bytes=400_000, measured_bytes={}, extra_bytes=0,
                               what="x")[0]
    ok, reason = hbm.admission_check(need_bytes=400_000,
                                     measured_bytes={"prefill:32": 1_200_000},
                                     extra_bytes=0, what="x")
    assert not ok and "measured" in reason
    ok, reason = hbm.admission_check(need_bytes=900_000, measured_bytes={},
                                     extra_bytes=200_000, what="x")
    assert not ok and "not run yet" in reason
    monkeypatch.delenv("DLLAMA_HBM_BYTES")
    assert hbm.admission_check(need_bytes=10**15, measured_bytes={}, extra_bytes=0,
                               what="x")[0]


# -- the engine and the pools --------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(), dict(compute_dtype="bfloat16"),
                                   dict(weight_mode="f32"), dict(weight_mode="bf16"),
                                   dict(kv_dtype="f8")])
def test_engine_estimate_equals_jax_engine(files, flags):
    eng = InferenceEngine(*files, device="cpu", **flags)
    jeng = JaxEngine(*files, tp=1, **flags)
    try:
        assert eng.hbm_weight_repr == jeng.hbm_weight_repr
        assert eng.hbm_estimate == jeng.hbm_estimate
        assert tm.registry().gauge(tm.HBM_NEED_BYTES).value() == \
            eng.hbm_estimate["need_per_device"]
    finally:
        eng.close()
        jeng.close()


def test_engine_refuses_before_staging(files, monkeypatch):
    import dllama_tpu_torch.runtime.engine as engine_mod

    staged = []
    monkeypatch.setattr(engine_mod, "load_params",
                        lambda *a, **k: staged.append(1))  # must never be reached
    monkeypatch.setenv("DLLAMA_HBM_BYTES", "1000000")
    with pytest.raises(RuntimeError, match="refusing to stage"):
        InferenceEngine(*files, device="cpu")
    assert staged == []
    rc = None
    with pytest.raises(SystemExit) as ei:
        rc = cli.main(["inference", "--model", files[0], "--tokenizer", files[1],
                       "--device", "cpu", "--prompt", "hi", "--steps", "4"])
    assert rc is None and "refusing to stage" in str(ei.value)


def test_dense_pool_degrades_to_the_fitting_slot_count(files, monkeypatch):
    eng = InferenceEngine(*files, device="cpu", temperature=0.0, seed=3)
    try:
        def need(batch):
            return hbm.estimate_device_bytes(eng.cfg, weight_repr=eng.hbm_weight_repr,
                                             kv_dtype_bytes=eng.kv_dtype.itemsize,
                                             batch=batch)["need_per_device"]

        monkeypatch.setenv("DLLAMA_HBM_BYTES", str((need(3) + need(5)) // 2))
        gen = BatchedGenerator(eng, n_slots=4)
        assert gen.n_slots == 2 and gen.kv.k.shape[1] == 2
        monkeypatch.setenv("DLLAMA_HBM_BYTES", "1000")
        with pytest.raises(RuntimeError, match="refusing to stage"):
            BatchedGenerator(eng, n_slots=4)
    finally:
        eng.close()


def test_paged_pool_degrades_block_by_block(files, monkeypatch):
    eng = InferenceEngine(*files, device="cpu", kv_block_size=16, temperature=0.0, seed=3)
    try:
        width = eng.cfg.seq_len // 16  # 96-row context: 6 blocks a sequence
        base = hbm.estimate_device_bytes(eng.cfg, weight_repr=eng.hbm_weight_repr,
                                         kv_dtype_bytes=eng.kv_dtype.itemsize)
        pool20 = hbm.estimate_block_pool_bytes(eng.cfg, 20, 16, eng.kv_dtype.itemsize)
        monkeypatch.setenv("DLLAMA_HBM_BYTES",
                           str(base["need_per_device"] + int(pool20 * 1.15)))
        gen = PagedGenerator(eng, n_slots=8)
        assert gen.pool.n_blocks == 20 < 8 * width + 1
        sched = BatchScheduler(eng, n_slots=8)
        assert sched.gen.pool.n_blocks == 20
        # the limit is the pool's own need: the admission guard would refuse
        # a width not run yet, so it stands down for the serving check
        monkeypatch.delenv("DLLAMA_HBM_BYTES")
        try:  # a shrunk pool still serves, block-priced
            req = sched.submit(eng.tokenizer.encode("hello", is_start=True), 4,
                               stop_on_eos=False)
            assert req.done.wait(timeout=60) and len(req.tokens) == 4
        finally:
            sched.close()
    finally:
        eng.close()


def test_admission_guard_rejects_over_budget_submit(files, monkeypatch):
    rejects = tm.registry().counter(tm.HBM_ADMISSION_REJECTS)
    r0 = rejects.total()
    eng = InferenceEngine(*files, device="cpu", temperature=0.0, seed=3)
    sched = BatchScheduler(eng, n_slots=2, _start_thread=False)
    try:
        monkeypatch.setenv("DLLAMA_HBM_BYTES", "10000000")  # far below the pool's need
        with pytest.raises(HbmAdmissionError, match="HBM admission guard"):
            sched.submit([1, 2, 3], 4)
        assert rejects.total() == r0 + 1
        monkeypatch.delenv("DLLAMA_HBM_BYTES")
        assert sched.submit([1, 2, 3], 4) in sched._queue
    finally:
        sched.close()
        eng.close()


def test_admission_charges_a_width_not_run_yet(files, monkeypatch):
    """A limit between the estimate and the estimate plus a 32-row chunk's
    temporaries refuses a prompt until that width has run once."""
    eng = InferenceEngine(*files, device="cpu", temperature=0.0, seed=3)
    sched = BatchScheduler(eng, n_slots=2, _start_thread=False)
    try:
        need = sched.gen.hbm_need
        extra = hbm.estimate_prefill_temp_bytes(eng.cfg, 32)
        monkeypatch.setenv("DLLAMA_HBM_BYTES", str(need + extra // 2))
        with pytest.raises(HbmAdmissionError, match="not run yet"):
            sched.submit([1, 2, 3], 4)
        eng._note_bucket(32)
        sched.submit([1, 2, 3], 4)
    finally:
        sched.close()
        eng.close()


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


@pytest.mark.parametrize("extra", [[], ["--batch-slots", "2"],
                                   ["--batch-slots", "2", "--kv-block-size", "16"]])
def test_api_answers_503_queue_full_on_an_admission_refusal(files, monkeypatch, extra):
    box, th, url = _serve(files, *extra)
    rejects = tm.registry().counter(tm.HBM_ADMISSION_REJECTS)
    r0 = rejects.total()
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3}
    try:
        monkeypatch.setenv("DLLAMA_HBM_BYTES", "10000000")
        req = urllib.request.Request(url + "/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503 and ei.value.headers["Retry-After"]
        err = json.loads(ei.value.read())
        assert err["code"] == "queue_full" and "HBM admission guard" in err["error"]
        assert rejects.total() == r0 + 1
        monkeypatch.delenv("DLLAMA_HBM_BYTES")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
    finally:
        box["server"].shutdown()
        th.join(timeout=60)
