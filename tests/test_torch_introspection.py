"""The port's compile ledger (``dllama_tpu_torch/runtime/introspection.py``)
against the JAX package's: the snapshot schema, the retrace sentinel's
``register`` / ``mark_steady`` / ``record`` rules on one synthetic event
sequence fed to both, and ``_sig_diff``; then the port's own counterparts of
compiles: every kernel wrapper's bytes and operations of a call equal the
shared count (``ops/cost.py``), a tiny model's decode step counts the weight
bytes reckoned from the ``.m`` file's tensors, a tiny paged ``api`` marks its
scope steady after two quiet ticks and files one retrace with its diff for a
prefill width it had not run, the three device-observability routes answer
on both API states with the JAX package's keys, and a forced watchdog stall
prints the ledger block."""

from __future__ import annotations

import io
import json
import threading
import time
import types
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import introspection as jintro
from dllama_tpu.runtime import roofline as jroof
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu_torch.formats.quants import Q40
from dllama_tpu_torch.ops import cost, flash_attention as fa, moe_matmul as mm
from dllama_tpu_torch.ops import paged_attention as pa, quant_matmul as qm, turbo
from dllama_tpu_torch.ops.linear import QuantizedWeight
from dllama_tpu_torch.runtime import introspection, telemetry as tm
from dllama_tpu_torch.runtime import watchdog as wd
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model


@pytest.fixture(autouse=True)
def _fresh():
    for tel in (tm, jtm):
        tel.registry().reset()
    introspection.ledger().reset()
    yield
    introspection.ledger().reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny Q40 model (seq_len 256: the chat template's tokens) and a
    tokenizer with a llama3 chat template."""
    d = tmp_path_factory.mktemp("torch_introspection")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(21))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


# -- the ledger against the JAX package's --------------------------------------


def _sequence(led) -> None:
    """One synthetic event sequence: two programs of one scope, steady
    marked, a retrace with a changed leaf and a changed plan, a
    registration re-opening the scope, a second scope."""
    a = led.register("engine-1", "prefill")
    b = led.register("engine-1", "decode")
    led.record(a, 0.25, {"tokens": "int64[1,32]"}, "none", {"hbm_total_bytes": 100,
                                                            "flops": 8.0})
    led.record(b, 0.5, {"tok": "int64[1,1]", "pos": "int32[1]"}, "none", None)
    led.mark_steady("engine-1")
    led.record(a, 0.125, {"tokens": "int64[1,64]"}, "tp=2", {"hbm_total_bytes": 200,
                                                             "flops": 16.0})
    led.record(b, 0.0625, {"tok": "int64[1,1]", "pos": "int32[1]"}, "none", None)
    c = led.register("engine-1", "verify")  # re-opens the scope
    led.record(c, 0.03125, {"tok": "int64[1,5]"}, "none", None)
    led.mark_steady("engine-1")
    d = led.register("engine-2", "prefill")
    led.record(d, 1.0, {"tokens": "int64[1,32]"}, "none", None)


def _without_time(snap: dict) -> dict:
    return dict(snap, events=[{k: v for k, v in e.items() if k not in ("time", "kind")}
                              for e in snap["events"]])


def test_sentinel_rules_and_snapshot_equal_jax(capsys):
    mine, theirs = introspection.CompileLedger(), jintro.CompileLedger()
    theirs.analyze = True  # the port's analysis is always on
    for led in (mine, theirs):
        _sequence(led)
    got, want = mine.snapshot(), theirs.snapshot()
    assert set(got) == set(want)
    assert _without_time(got) == _without_time(want)
    assert [e["unexpected"] for e in got["events"]] == [False, False, True, True, False, False]
    assert got["events"][2]["diff"] == ["~ mesh plan: none -> tp=2",
                                        "~ tokens: int64[1,32] -> int64[1,64]"]
    for led in (mine, theirs):
        assert led.compile_count("engine-1") == 5 and led.steady("engine-1")
        assert not led.steady("engine-2")
    out = capsys.readouterr().out
    assert "unexpected capture after steady state: engine-1/prefill" in out


@pytest.mark.parametrize("old,new", [
    (None, {"a": "int64[1,1]"}),
    ({"a": "int64[1,32]", "b": "float32[4]", "gone": "int32[2]"},
     {"a": "int64[1,1]", "b": "float32[4]", "new": "float32[8]"}),
    ({"a": "int64[1,1]"}, {"a": "int64[1,1]"})])
def test_sig_diff_equals_jax(old, new):
    assert introspection._sig_diff(old, new) == jintro._sig_diff(old, new)


def _jax_events() -> list[dict]:
    led = jintro.CompileLedger()
    led.record(led.register("s", "p"), 0.1, {}, "none", None)
    return led.snapshot()["events"]


def test_build_events_and_measured_bytes():
    led = introspection.CompileLedger()
    led.record_build("quant_matmul", 12.5, reused=False)
    led.record_build("flash_attention", 0.0, reused=True)
    ev = led.snapshot()["events"]
    assert [(e["scope"], e["program"], e["kind"], e["reused"]) for e in ev] == [
        ("kernels", "quant_matmul", "build", False), ("kernels", "flash_attention", "build",
                                                      True)]
    assert set(ev[0]) - {"kind", "reused"} == set(_jax_events()[0])
    # a build counts as a compile of the kernels scope; a reused library does not
    assert tm.registry().counter(tm.COMPILE_TOTAL).total(scope="kernels") == 1
    e = led.register("engine-9", "paged_step")
    led.record(e, 0.1, {}, "none", {"hbm_total_bytes": 5, "peak_bytes": 123})
    assert led.measured_hbm_bytes("engine-9") == {"paged_step": 123}
    assert led.measured_hbm_bytes("engine-1") == {}


# -- the wrappers' counts -------------------------------------------------------


def _planes(K: int, N: int, g, kind: str = "q40", fast: bool = False, G: int | None = None):
    lo, hi = (-127, 128) if kind == "q80" else (-7, 8)
    shape = (K, N) if G is None else (G, K, N)
    codes = torch.randint(lo, hi, shape, generator=g, dtype=torch.int8)
    scales = torch.rand(shape[:-2] + (K // 32, N), generator=g) * 0.01 + 0.002
    return QuantizedWeight(scales=scales.to(torch.bfloat16 if fast else torch.float32),
                           codes=codes, kind=kind)


def _call_counted(fn, call):
    b0, o0 = fn.moved_bytes, fn.ops
    call()
    return fn.moved_bytes - b0, fn.ops - o0


@pytest.mark.parametrize("M,fast", [(1, False), (4, False), (8, True), (40, False),
                                    (40, True)])
def test_quant_matmul_counts_equal_cost(M, fast):
    g = torch.Generator().manual_seed(M)
    K, N = 128, 96
    w = _planes(K, N, g, fast=fast)
    x = torch.randn((M, K), generator=g)
    fn = qm.q40_gemv if M <= qm.FUSED_MAX_M else qm.q40_matmul
    got = _call_counted(fn, lambda: qm.quant_matmul(x, w, fast=fast))
    elt = 2 if fast else 4
    n_bytes = K * N + K // 32 * N * elt + M * K * elt + M * N * 4
    mult = 3 if (not fast and fn is qm.q40_gemv and M > 1) else 1  # exact tc: 3 parts
    assert got == (n_bytes, mult * 2.0 * M * K * N)
    c = cost.launch_cost("K2" if fn is qm.q40_gemv else "K1", M=M, K=K, N=N, fast=fast,
                         path=qm._gemv_path(M) if fn is qm.q40_gemv else "simt")
    assert got == (c.bytes, c.ops)


@pytest.mark.parametrize("T,start", [(1, 37), (5, 10), (1, "tensor")])
def test_flash_attention_counts_equal_cost(T, start):
    g = torch.Generator().manual_seed(T)
    B, H, KV, D, S = 2, 4, 2, 64, 128
    q = torch.randn((B, T, H, D), generator=g)
    k, v = (torch.randn((B, KV, S, D), generator=g) for _ in range(2))
    pos = torch.tensor([3, 50]) if start == "tensor" else start
    got = _call_counted(fa.flash_attention, lambda: fa.flash_attention(q, k, v, pos, D))
    depths = [S - T] * B if start == "tensor" else [start] * B  # device positions: capacity
    keys = sum(min(d + T, S) for d in depths)
    visible = sum(min(d + t + 1, S) for d in depths for t in range(T))
    assert got == (2 * B * T * H * D * 4 + 2 * keys * KV * D * 4, 4.0 * D * H * visible)


def test_block_stats_paged_and_moe_counts_equal_cost():
    g = torch.Generator().manual_seed(7)
    B, KV, D, t, S = 1, 2, 64, 4, 64
    q_g = torch.randn((B, KV, t * 2, D), generator=g)
    k, v = (torch.randn((B, KV, S, D), generator=g) for _ in range(2))
    got = _call_counted(fa.flash_block_stats,
                        lambda: fa.flash_block_stats(q_g, k, v, 40, 20, D, t))
    seen = [max(0, min(S, 40 + i - 20 + 1)) for i in range(t)]
    want = cost.launch_cost("K3s", T=t, heads=4, kv_heads=KV, head_dim=D, q_elt=4, kv_elt=4,
                            seen=seen, path="simt")
    assert got == (want.bytes, want.ops)
    assert got[1] == 4.0 * D * 4 * sum(seen)

    q = torch.randn((3, 2, 4, D), generator=g)
    pool = torch.randn((6, KV, 16, D), generator=g)
    tables = torch.tensor([[1, 2, 0], [3, 0, 0], [4, 5, 0]])
    positions = torch.tensor([[20, 21], [5, 6], [30, 31]])
    got = _call_counted(pa.paged_attention,
                        lambda: pa.paged_attention(q, pool, pool, tables, positions, D))
    rows = 3 * 16  # the table's reach: positions stay on the device
    assert got == (2 * 3 * rows * KV * D * 4 + 2 * 3 * 2 * 4 * D * 4,
                   4.0 * D * 4 * 3 * sum(min(rows - 2 + i + 1, rows) for i in range(2)))

    we = _planes(64, 32, g, G=4)
    x = torch.randn((6, 64), generator=g)
    offsets = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32)
    got = _call_counted(mm.moe_matmul, lambda: mm.moe_matmul(x, we, offsets, decoder="q"))
    used = 4  # min(G, R): the offsets stay on the device
    assert got == (used * (64 * 32 + 2 * 32 * 4) + 6 * 64 * 4 + 6 * 32 * 4, 3 * 2.0 * 6 * 64 * 32)
    tw = turbo.derive_turbo(_planes(64, 32, g), a8=True)
    tw1 = turbo.TurboWeight(tw.w8[None], tw.scale[None], True)
    got = _call_counted(mm.moe_matmul, lambda: mm.moe_matmul(x, tw1, None, decoder="a8"))
    assert got == (64 * 32 + 4 * 32 + 6 * 64 + 6 * 32 * 4, 2.0 * 6 * 64 * 32)


def test_decode_step_counts_the_files_weight_bytes(files):
    """The decode program's analysis (its first run on the CPU) holds K2's
    bytes: every Q40 tensor of the ``.m`` file once (int8 codes, an f32 scale
    per 32 rows) plus its one-row activation in and output out."""
    eng = InferenceEngine(files[0], files[1], device="cpu", temperature=0.0)
    try:
        eng.generate([1, 2, 3, 4, 5], 3, stop_on_eos=False)
        want = 0
        for rec in eng.model_file.tensors.values():
            if rec.float_type == Q40:
                N, K = rec.shape
                want += K * N + K // 32 * N * 4 + K * 4 + N * 4
        snap = introspection.ledger().snapshot()
        prog = next(p for p in snap["programs"]
                    if p["scope"] == eng.introspection_scope and p["program"] == "decode")
    finally:
        eng.close()
    assert want > 0
    assert prog["analysis"]["kernels"]["q40_gemv"]["bytes"] == want
    assert prog["analysis"]["hbm_total_bytes"] == want  # attention runs its oracle here
    assert prog["compiles"] == 1 and prog["hits"] >= 1
    assert prog["analysis"]["source"] == cost.CAPACITY_NOTE


# -- the sentinel on a tiny paged api ------------------------------------------


def _serve(files, *extra):
    m, t = files
    box, ready = {}, threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        ready.set()

    out = io.StringIO()

    def run():
        with redirect_stdout(out):
            box["rc"] = cli.main(["api", "--model", m, "--tokenizer", t, "--device", "cpu",
                                  "--port", "0", "--temperature", "0", "--seed", "3", *extra],
                                 on_listening=on_listening)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    while not ready.wait(timeout=1.0):
        assert th.is_alive(), "the api server exited before listening"
    return f"http://127.0.0.1:{box['server'].server_address[1]}", box, th, out


def _stop(box, th):
    box["server"].shutdown()
    th.join(timeout=120)
    assert box.get("rc") == 0


def _request(url, path, body=None):
    req = urllib.request.Request(url + path, data=None if body is None else
                                 json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _chat(url, text, n=4):
    return _request(url, "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": text}], "max_tokens": n})


def test_paged_api_goes_steady_then_files_one_retrace(files):
    url, box, th, out = _serve(files, "--batch-slots", "2", "--kv-block-size", "16")
    try:
        scope = box["state"].engine.introspection_scope
        led = introspection.ledger()
        _chat(url, "hi", n=8)  # one 32-wide prefill chunk, then decode ticks
        deadline = time.monotonic() + 60
        while not led.steady(scope):
            assert time.monotonic() < deadline, "the scope never went steady"
            time.sleep(0.01)
        _chat(url, "hi")  # the same width: nothing new
        assert tm.registry().counter(tm.RETRACE_UNEXPECTED).total() == 0
        _chat(url, "w" * 120)  # a 128-wide chunk this scope has not run
        _, snap = _request(url, "/debug/compiles")
    finally:
        _stop(box, th)
    assert tm.registry().counter(tm.RETRACE_UNEXPECTED).total(program="paged_prefill") == 1
    bad = [e for e in snap["events"] if e["unexpected"]]
    assert len(bad) == 1 and bad[0]["program"] == "paged_prefill"
    # "hi" prefilled 64 + 32 rows (the template's tokens), then the longer
    # prompt's first chunk is 128 wide
    assert bad[0]["diff"] == ["~ tokens: int64[1,32] -> int64[1,128]"]
    assert "unexpected first run after steady state" in out.getvalue()
    assert "🧮 HBM budget/device" in out.getvalue()


# -- the routes on both API states -----------------------------------------------


def _jax_profile_keys() -> set:
    """The keys of the JAX package's live profile summary (an idle window
    on an engine without collectives), ops included."""
    from dllama_tpu.runtime import profiling as jprof

    eng = types.SimpleNamespace(collect_traffic=lambda: jprof.TrafficStats(0.0, 0.0, 0, {}))
    return set(jprof.live_split_summary(eng, 0.01, include_ops=True))


@pytest.mark.parametrize("extra", [[], ["--batch-slots", "2", "--kv-block-size", "16"]],
                         ids=["single", "paged"])
def test_routes_answer_with_jax_keys_on_both_states(files, extra):
    url, box, th, _ = _serve(files, *extra)
    try:
        _chat(url, "hello")
        status_c, compiles = _request(url, "/debug/compiles")
        status_r, roof = _request(url, "/debug/roofline")
        status_p, prof = _request(url, "/debug/profile?ms=50&ops=1", {})
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(url, "/debug/profile?ms=5", {})
        assert e.value.code == 400
        _, index = _request(url, "/debug")
    finally:
        _stop(box, th)
    assert (status_c, status_r, status_p) == (200, 200, 200)
    assert set(compiles) == set(jintro.CompileLedger().snapshot())
    jled = jintro.CompileLedger()
    jled.register("s", "p")
    jprog = set(jled.snapshot()["programs"][0])
    assert compiles["programs"] and all(set(p) == jprog for p in compiles["programs"])
    assert all(set(e) - {"kind", "reused"} == set(_jax_events()[0])
               for e in compiles["events"])
    assert set(roof) == set(jroof.snapshot(ceilings=jroof.nameplate_ceilings("cpu"),
                                           publish=False)) | {"summary"}
    assert set(prof) == _jax_profile_keys()
    assert {"/debug/compiles", "/debug/profile", "/debug/roofline"} <= set(index["endpoints"])


# -- the watchdog's stall dump -------------------------------------------------------


def test_forced_stall_prints_the_ledger_block():
    led = introspection.ledger()
    e = led.register("engine-7", "paged_step")
    led.record(e, 0.2, {"inp": "int64[2,3]"}, "none", None)
    w = wd.StepWatchdog("stall", min_samples=1, min_budget_s=0.05, margin=1.0, enabled=True)
    w.observe(1.0)
    seen: list = []
    w.on_stall.append(seen.append)
    out = io.StringIO()
    try:
        with redirect_stdout(out), w.guard("wedged"):
            deadline = time.monotonic() + 60
            while not seen:
                assert time.monotonic() < deadline
                time.sleep(0.01)
    finally:
        w.close()
    text = out.getvalue()
    assert "🛑 watchdog: compile-ledger state" in text
    assert "engine-7/paged_step: 1 compiles, 0 hits, last 0.20s" in text
