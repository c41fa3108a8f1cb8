"""The port's profiler layer (``dllama_tpu_torch/runtime/profiling.py``)
against the JAX package's: ``union_span`` on seeded interval sets,
``classify_op`` on the JAX package's own op names, and ``op_attribution`` and
the Eval/Sync split on one synthetic event set (the JAX side a duck-typed
xspace or an xplane file, the port a Chrome-trace dict of the same events);
every kernel of the port lands in its class; then a real ``torch.profiler``
capture through ``python -m dllama_tpu_torch inference --device cpu
--profile DIR`` that ``op_attribution`` reads, the one-session rule, and the
tp merges' traffic and split at ``--tp 2`` on the CPU."""

from __future__ import annotations

import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import profiling as jprof
from dllama_tpu_torch.ops import linear
from dllama_tpu_torch.runtime import profiling
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_profiling")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(55))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


@pytest.mark.parametrize("seed", range(6))
def test_union_span_equals_jax(seed):
    rng = np.random.default_rng(seed)
    iv = []
    for _ in range(int(rng.integers(0, 60))):
        s = int(rng.integers(0, 10_000))
        iv.append((s, s + int(rng.integers(0, 800))))
    assert profiling.union_span(list(iv)) == jprof.union_span(list(iv))


# the JAX package's op names (its tests' and XLA's) and the port's kernels
JAX_NAMES = ("all-reduce.3", "ppermute.1", "psum.7", "all-gather-start.2", "wait:rendezvous",
             "dot_general.7", "dot.12", "fusion.12", "convert_element_type.2",
             "top_k.1", "sort.4", "argmax.1", "cumsum.3", "rng_bit_generator",
             "flash_attention_kernel", "softmax.2", "ragged_dot.1", "einsum.5",
             "copy.9", "dynamic-update-slice.3", "gather.2", "reduce.8")
PORT_KERNELS = {
    "q40_gemv_kernel": "gemv/matmul", "q40_gemv_tc_kernel": "gemv/matmul",
    "q40_matmul_f32_kernel": "gemv/matmul", "q40_matmul_bf16_kernel": "gemv/matmul",
    "sum_splits_kernel": "gemv/matmul", "moe_matmul_kernel": "gemv/matmul",
    "moe_tc_kernel": "gemv/matmul", "moe_reduce_kernel": "gemv/matmul",
    "flash_attention_kernel": "attention", "flash_attention_tc_kernel": "attention",
    "paged_attention_kernel": "attention", "combine_splits_kernel": "attention",
    # PyTorch's kernels of the sampler: the top-p sort and the CDF scan
    "void at::native::bitonicSortKVInPlace<float, long, 2>(...)": "sampling",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>": "sampling",
    "void at::native::tensor_kernel_scan_innermost_dim<float, std::plus<float> >(...)":
        "sampling",
    "nvjet_tst_384x8_64x4_2x1_v_bz_TNT": "gemv/matmul",  # cuBLAS: the dense bf16 head
}


def test_classify_op_equals_jax_and_names_the_ports_kernels():
    for name in JAX_NAMES:
        assert profiling.classify_op(name) == jprof.classify_op(name), name
    for name, cls in PORT_KERNELS.items():
        assert profiling.classify_op(f"void {name}<4>(float const*, int)") == cls, name
        assert profiling.classify_op(name) == cls, name


# names both packages classify alike (the port's extra classes are held
# by the test above)
NAMES = ("q40_gemv_kernel", "flash_attention_kernel", "fusion.12", "sort.4", "dot.3",
         "all-reduce.1", "paged_attention_kernel", "copy.9")


def _events(seed: int):
    """Two lanes (streams 7 and 9 of device 0) of (name, start_ns, dur_ns)
    events, overlaps and nesting included."""
    rng = np.random.default_rng(seed)
    lanes = {}
    for tid in (7, 9):
        evs, t = [], int(rng.integers(0, 1000))
        for _ in range(int(rng.integers(5, 40))):
            dur = int(rng.integers(1, 5000))
            evs.append((NAMES[int(rng.integers(0, len(NAMES)))], t, dur))
            t += int(rng.integers(-dur, 3000))  # negative: overlap with the last
            t = max(t, 0)
        lanes[tid] = evs
    return lanes


def _xspace(lanes):
    planes = []
    for tid, evs in sorted(lanes.items()):
        meta = {i: types.SimpleNamespace(id=i, name=n) for i, (n, _, _) in enumerate(evs)}
        line = types.SimpleNamespace(
            name=f"stream {tid}", timestamp_ns=0,
            events=[types.SimpleNamespace(metadata_id=i, offset_ps=s * 1000,
                                          duration_ps=d * 1000)
                    for i, (_, s, d) in enumerate(evs)])
        planes.append(types.SimpleNamespace(name="/device:GPU:0", lines=[line],
                                            event_metadata=meta))
    return types.SimpleNamespace(planes=planes)


def _chrome(lanes, offset_us: float = 0.0):
    """The same events as a torch.profiler Chrome trace: kernel events on
    (pid 0, tid stream); the collective-named ones launched inside a
    ``tp_merge`` range on the host thread (their sync mark)."""
    out, corr = [], 0
    for tid, evs in lanes.items():
        for name, s, d in evs:
            corr += 1
            out.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": tid,
                        "ts": offset_us + s / 1000, "dur": d / 1000,
                        "args": {"correlation": corr}})
            launch = offset_us + corr * 100.0
            if jprof._SYNC_RE.search(name):
                out.append({"ph": "X", "cat": "user_annotation", "name": linear.MERGE_SPAN,
                            "pid": 1, "tid": 2, "ts": launch - 1.0, "dur": 3.0})
            out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                        "pid": 1, "tid": 2, "ts": launch, "dur": 0.5,
                        "args": {"correlation": corr}})
    return {"traceEvents": out}


def _close(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=0, abs_tol=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed,n_steps,top", [(0, 1, 25), (1, 3, 5), (2, 7, 3), (3, 1, 50)])
def test_op_attribution_equals_jax(seed, n_steps, top):
    lanes = _events(seed)
    want = jprof.op_attribution(xspace=_xspace(lanes), n_steps=n_steps, top=top)
    got = profiling.op_attribution(trace=_chrome(lanes, offset_us=1.7e6), n_steps=n_steps,
                                   top=top)
    _close(got, want)
    assert got["n_lanes"] == 2 and got["classes"]


def _write_xplane(path, lanes) -> None:
    jprof._load_xplane(os.devnull)  # loads the proto module
    xs = jprof._xplane_pb2.XSpace()
    mid = 0
    for tid, evs in sorted(lanes.items()):
        plane = xs.planes.add()
        plane.name = "/device:GPU:0"
        line = plane.lines.add()
        line.name = f"stream {tid}"
        for name, s, d in evs:
            mid += 1
            plane.event_metadata[mid].id = mid
            plane.event_metadata[mid].name = name
            ev = line.events.add()
            ev.metadata_id, ev.offset_ps, ev.duration_ps = mid, s * 1000, d * 1000
    with open(path, "wb") as f:
        f.write(xs.SerializeToString())


@pytest.mark.parametrize("seed", [4, 5])
def test_split_equals_jax(tmp_path, seed):
    """The split of the same events: the JAX package's sync events are the
    collective-named ones, the port's the kernels launched inside a
    ``tp_merge`` range (the same events here)."""
    lanes = _events(seed)
    _write_xplane(tmp_path / "t.xplane.pb", lanes)
    want = jprof.split_from_trace(str(tmp_path), 2)
    got = profiling.split_from_trace(None, 2, trace=_chrome(lanes))
    for k in ("eval_ms", "sync_ms", "exposed_ms"):
        assert math.isclose(getattr(got, k), getattr(want, k), abs_tol=1e-9), k
    assert (got.n_steps, got.n_lanes) == (want.n_steps, want.n_lanes)
    assert got.sync_ms > 0 and math.isclose(got.sync_frac, want.sync_frac, abs_tol=1e-12)


def test_cli_profile_trace_reads_back(files, tmp_path):
    """``--profile DIR --profile-split`` at ``--tp 2``: the trace, then the
    per-token 🔶 lines, the split and the traffic after the capture closed."""
    d = tmp_path / "prof"
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "inference", "--device",
                        "cpu", "--model", files[0], "--tokenizer", files[1], "--prompt",
                        "hello world", "--steps", "20", "--temperature", "0", "--profile",
                        str(d), "--profile-split", "--tp", "2"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert f"🔬 profiler trace written to {d}" in r.stdout
    assert any(ln.strip().startswith("roofline:") and "[nameplate:cpu]" in ln for ln in lines)
    n_pred = int(next(ln for ln in lines[lines.index("Prediction"):]
                      if "nTokens:" in ln).split()[-1])
    assert sum(ln.startswith("🔶 P ") for ln in lines) == n_pred > 0
    assert any(ln.strip().startswith("eval/sync:") for ln in lines)
    assert any(ln.strip().startswith("traffic:") and "concat=" in ln for ln in lines)
    att = profiling.op_attribution(str(d), n_steps=1)
    assert att["n_lanes"] >= 1 and att["total_ms_per_step"] > 0
    assert "gemv/matmul" in att["classes"]  # the CPU lanes' aten::matmul


def test_one_capture_at_a_time(tmp_path):
    with profiling.capture(str(tmp_path / "a")):
        assert profiling.capture_active()
        with pytest.raises(profiling.CaptureBusyError):
            with profiling.capture(str(tmp_path / "b")):
                pass
    assert not profiling.capture_active()
    assert list((tmp_path / "a").glob("*.json"))


def test_tp2_traffic_and_split_on_the_cpu(files):
    """At tp = 2 every sharded matmul of a decode step is one merge: the
    traffic counts what rank 0 sends (a row split: all of x; a col split:
    x's other half) and receives (the other rank's output or f32 partial),
    and the split finds the merges' time; at tp = 1 nothing runs."""
    eng = InferenceEngine(files[0], files[1], device="cpu", temperature=0.0, tp=2)
    try:
        eng.generate([1, 2, 3, 4], 2, stop_on_eos=False)
        tr = eng.collect_traffic()
        # reckoned from the shards' shapes: one decode row of f32 activations
        sent = recv = n = 0
        weights = [getattr(lp, k) for lp in eng.params.layers
                   for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")] + [eng.params.logits]
        for w in weights:
            if getattr(w, "split", "") in ("out", "in"):
                other = w.shards[1]  # rank 1's planes [K_1, N_1]
                K = other.in_features * (2 if w.split == "in" else 1)
                sent += (K if w.split == "out" else other.in_features) * 4
                recv += other.out_features * 4  # its output, or its f32 partial
                n += 1
        split = eng.measure_split(n_steps=2)
    finally:
        eng.close()
    assert tr.n_collectives == n > 0
    assert (tr.sent_kb, tr.recv_kb) == (sent / 1024, recv / 1024)
    assert set(tr.by_kind) == {"concat", "sum"}
    assert split.n_lanes >= 1 and split.sync_ms > 0 and 0 < split.sync_frac < 1
    one = InferenceEngine(files[0], files[1], device="cpu", temperature=0.0, tp=1)
    try:
        assert not one.collect_traffic()
        assert one.measure_split().sync_ms == 0.0 and one.split.n_lanes == 0
    finally:
        one.close()


def test_live_profile_runs_its_session_on_the_loop_thread(files):
    """``POST /debug/profile``'s window on batched serving starts and stops
    its session on the scheduler's loop thread (``run_on_loop``), so the
    loop's own host ops land in the trace while a request decodes; a loop
    call's error comes back to the caller."""
    import threading

    from dllama_tpu_torch.runtime.serving import BatchScheduler

    eng = InferenceEngine(files[0], files[1], device="cpu", temperature=0.0,
                          kv_block_size=16)
    sched = BatchScheduler(eng, 2)
    try:
        names = []
        sched.run_on_loop(lambda: names.append(threading.current_thread().name))
        assert names and names[0] != threading.current_thread().name
        with pytest.raises(ZeroDivisionError):
            sched.run_on_loop(lambda: 1 / 0)
        req = sched.submit([1, 2, 3, 4, 5], 60, stop_on_eos=False)
        while not req.tokens:
            assert not req.done.wait(0.01), req.error
        got = profiling.live_split_summary(eng, 0.3, include_ops=True,
                                           on_loop=sched.run_on_loop)
        assert req.done.wait(300) and not req.error
    finally:
        sched.close()
        eng.close()
    assert got["n_steps"] > 0 and got["op_attribution"]["n_lanes"] >= 1
    assert got["op_attribution"]["classes"] and got["sync_frac"] == 0.0
