"""The port's telemetry (``dllama_tpu_torch/runtime/telemetry.py``) against
the JAX package's: the metric-name vocabulary letter for letter, the
Prometheus text of one observation sequence byte for byte, the integer
counters of one serving workload (6 requests through 2 slots, paged and
dense, with and without ``--spec-lookup``; both schedulers driven tick by
tick so both see the same ticks), ``/metrics`` and the debug routes on both
port API states, the ``--stats`` line, and the ``--trace-out`` spans.
Integer counters and structure compare exactly; no wall-clock bound is
held."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import flightrec as jflight
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.serving import BatchScheduler as JaxScheduler
from dllama_tpu_torch.runtime import flightrec, telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

PROMPTS = ["hello world", "hello there", "abc", "hello world how are you", "xyzzy",
           "hello hello hello"]
SPECS = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
         dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
         dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]


def _reset_all() -> None:
    """Both packages' process-wide registries, span rings and recorders."""
    for reg, tracer, rec in ((tm.registry(), tm.tracer(), flightrec.recorder()),
                             (jtm.registry(), jtm.tracer(), jflight.recorder())):
        reg.reset()
        tracer._ring.clear()
        rec.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("DLLAMA_FLIGHT_DIR", str(tmp_path))
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_telemetry")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(41))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


# -- the vocabulary and the text format ---------------------------------------


def test_name_constants_and_specs_equal_jax():
    names = {k: v for k, v in vars(jtm).items() if k.isupper() and isinstance(v, str)}
    assert len(names) > 100
    for k, v in names.items():
        assert getattr(tm, k) == v, k
    assert {k for k, v in vars(tm).items() if k.isupper() and isinstance(v, str)} == set(names)
    assert list(tm.SPECS) == list(jtm.SPECS)
    for name, spec in jtm.SPECS.items():
        got = tm.SPECS[name]
        assert (got.name, got.kind, got.help, got.buckets) == \
            (spec.name, spec.kind, spec.help, spec.buckets)
    assert (tm.PHASES, tm.EVAL_CONFIGS, tm.EVAL_PARITY, tm.ROUTER_PHASES) == \
        (jtm.PHASES, jtm.EVAL_CONFIGS, jtm.EVAL_PARITY, jtm.ROUTER_PHASES)


def _observe(mod, reg, seed: int) -> None:
    """One seeded sequence of observations: counters (labelled and not),
    gauges (set and add), histograms over every bucket edge."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        kind = rng.integers(4)
        if kind == 0:
            reg.counter(mod.BATCH_TOKENS).inc(int(rng.integers(1, 9)))
        elif kind == 1:
            reg.counter(mod.HTTP_REQUESTS).inc(
                route=str(rng.choice(["/v1/chat/completions", "/metrics", "other"])),
                status=str(rng.choice([200, 429, 503])))
        elif kind == 2:
            g = reg.gauge(mod.KV_BLOCKS_USED)
            g.set(float(rng.integers(0, 40))) if rng.random() < 0.5 else g.add(1.5)
        else:
            v = float(rng.choice([0.5, 2.5, 30000.0, 1e6])) if rng.random() < 0.3 \
                else float(rng.exponential(40.0))
            reg.histogram(mod.BATCH_STEP_MS).record(v)
            reg.histogram(mod.TTFT_ATTRIB_MS).record(v, phase=str(rng.choice(
                ["queue", "prefill"])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_byte_equal(seed):
    mine, theirs = tm.Registry(), jtm.Registry()
    assert mine.render() == theirs.render()  # the empty schema
    _observe(tm, mine, seed)
    _observe(jtm, theirs, seed)
    text = mine.render()
    assert text == theirs.render()
    assert "dllama_batch_step_ms_bucket{le=\"+Inf\"}" in text


def test_stats_line_equals_jax():
    """The ``--stats`` line over the same values (the port leaves out only
    the roofline fragment, which a private registry never shows)."""
    mine, theirs = tm.Registry(), jtm.Registry()
    for mod, reg in ((tm, mine), (jtm, theirs)):
        reg.counter(mod.HTTP_REQUESTS).inc(3, route="/v1/chat/completions", status="200")
        reg.gauge(mod.BATCH_SLOTS).set(8)
        reg.gauge(mod.BATCH_OCCUPANCY).set(5)
        reg.gauge(mod.KV_BLOCKS_TOTAL).set(1024)
        reg.gauge(mod.KV_BLOCKS_USED).set(77)
        reg.counter(mod.SPEC_DRAFT_TOKENS).inc(40, generator="paged")
        reg.counter(mod.SPEC_ACCEPTED_TOKENS).inc(10, generator="paged")
        for v in (3.0, 7.0, 40.0):
            reg.histogram(mod.TTFT_MS).record(v)
            for ph in ("queue", "admission", "prefill", "first_decode"):
                reg.histogram(mod.TTFT_ATTRIB_MS).record(v, phase=ph)
    got = tm.stats_line(mine, window_tokens=120, window_s=2.0)
    assert got == jtm.stats_line(theirs, window_tokens=120, window_s=2.0)
    assert got.startswith("📈 reqs=3 ") and "blocks=77/1024" in got and "tok/s=60.0" in got


def test_stats_reporter_prints_the_line(capsys):
    t = cli.start_stats_reporter(0.02)
    try:
        for _ in range(1500):
            if "📈 reqs=" in capsys.readouterr().out:
                break
            t.stop.wait(0.02)
        else:
            pytest.fail("no --stats line printed")
    finally:
        t.stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


# -- one serving workload, both packages ---------------------------------------

INT_COUNTERS = ["BATCH_TOKENS", "ADMISSIONS", "RETIRES", "PREFIX_REUSE_TOKENS",
                "SPEC_DRAFT_TOKENS", "SPEC_ACCEPTED_TOKENS", "SPEC_DEGRADED",
                "KV_BLOCK_EXHAUSTION", "REQUESTS_SHED", "REQUEST_TIMEOUTS",
                "SCHEDULER_CRASHES", "SCHEDULER_RESTARTS", "FLIGHT_TICKS"]
GAUGES = ["BATCH_SLOTS", "KV_BLOCKS_TOTAL", "KV_BLOCKS_USED", "KV_BLOCKS_SHARED",
          "QUEUE_DEPTH", "BATCH_OCCUPANCY"]
HISTOGRAM_COUNTS = ["BATCH_STEP_MS", "QUEUE_WAIT_MS"]


def drive(sched, ids_list, max_tokens=8, specs=SPECS):
    """Submit every request, then tick the scheduler on this thread until
    all are done (the same tick sequence on both packages)."""
    reqs = [sched.submit(ids, max_tokens, stop_on_eos=False, **s)
            for ids, s in zip(ids_list, specs)]
    for _ in range(5000):
        if all(r.done.is_set() for r in reqs):
            break
        sched._tick()
    sched.close()
    return reqs


def counters(mod) -> dict:
    reg = mod.registry()
    out = {k: reg.counter(getattr(mod, k)).total() for k in INT_COUNTERS}
    out.update({k: reg.gauge(getattr(mod, k)).value() for k in GAUGES})
    out.update({k: reg.histogram(getattr(mod, k)).count() for k in HISTOGRAM_COUNTS})
    for ph in ("queue", "admission", "prefill", "first_decode"):
        out[f"ttft_{ph}"] = reg.histogram(mod.TTFT_ATTRIB_MS).count(phase=ph)
    for cause in ("step", "preempt", "verify"):
        out[f"itl_{cause}"] = reg.histogram(mod.ITL_ATTRIB_MS).count(cause=cause)
    return out


def decisions(rec) -> list:
    """Each recorded tick's decisions as (event, rid, reason) — what the
    scheduler decided and why, without its clocks."""
    return [[(d["event"], d["rid"], d.get("reason", "")) for d in t["decisions"]]
            for t in rec.snapshot()["ticks"]]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("spec", [0, 4], ids=["plain", "spec4"])
def test_serving_counters_equal_jax(files, paged, spec):
    m, t = files
    block = dict(kv_block_size=16) if paged else {}
    eng = InferenceEngine(m, t, device="cpu", spec_lookup=spec, **block)
    jeng = JaxEngine(m, t, tp=1, spec_lookup=spec, **block)
    try:
        ids = [eng.tokenizer.encode(p, is_start=True) for p in PROMPTS]
        mine = drive(BatchScheduler(eng, n_slots=2, _start_thread=False), ids)
        got, got_ticks = counters(tm), decisions(flightrec.recorder())
        theirs = drive(JaxScheduler(jeng, n_slots=2, _start_thread=False), ids)
        want, want_ticks = counters(jtm), decisions(jflight.recorder())
    finally:
        eng.close()
        jeng.close()
    assert [r.tokens for r in mine] == [r.tokens for r in theirs]
    assert got == want
    assert got["BATCH_TOKENS"] == 6 * 8 and got["ADMISSIONS"] == got["RETIRES"] == 6
    assert got["PREFIX_REUSE_TOKENS"] > 0 and got["BATCH_STEP_MS"] > 0
    assert got["FLIGHT_TICKS"] == len(got_ticks)
    assert got_ticks == want_ticks
    if spec:
        assert got["SPEC_DRAFT_TOKENS"] > 0
    if paged:
        assert got["KV_BLOCKS_USED"] == 0 and got["KV_BLOCKS_TOTAL"] > 0


def test_engine_counters_equal_jax(files):
    """The single-sequence engine's counters: prefill tokens and chunks,
    decode tokens and steps, the spec counters, over one greedy generation
    with and without ``--spec-lookup``."""
    m, t = files
    for spec in (0, 3):
        eng = InferenceEngine(m, t, device="cpu", spec_lookup=spec, temperature=0.0)
        jeng = JaxEngine(m, t, tp=1, spec_lookup=spec, temperature=0.0)
        try:
            ids = eng.tokenizer.encode("hello hello hello world", is_start=True)
            got_toks = eng.generate(ids, 20, stop_on_eos=False).tokens
            jeng_toks = jeng.generate(ids, 20, stop_on_eos=False).tokens
        finally:
            eng.close()
            jeng.close()
        assert got_toks == jeng_toks
        for name in ("PREFILL_TOKENS", "DECODE_TOKENS", "SPEC_DRAFT_TOKENS",
                     "SPEC_ACCEPTED_TOKENS"):
            assert tm.registry().counter(getattr(tm, name)).total() == \
                jtm.registry().counter(getattr(jtm, name)).total(), (spec, name)
        for name in ("PREFILL_CHUNK_MS", "DECODE_STEP_MS"):
            assert tm.registry().histogram(getattr(tm, name)).count() == \
                jtm.registry().histogram(getattr(jtm, name)).count(), (spec, name)
        assert tm.registry().gauge(tm.KV_OCCUPANCY).value() == \
            jtm.registry().gauge(jtm.KV_OCCUPANCY).value()
        _reset_all()


# -- /metrics and the debug routes on both API states --------------------------


@pytest.fixture(scope="module")
def api_files(tmp_path_factory):
    """The API tests' model (seq_len 256: the chat template's tokens) and a
    tokenizer with a llama3 chat template."""
    d = tmp_path_factory.mktemp("torch_telemetry_api")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(9))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


def _serve(files, *extra):
    m, t = files
    box, ready = {}, threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        ready.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0",
         "--temperature", "0", "--seed", "3", *extra], on_listening=on_listening)),
        daemon=True)
    th.start()
    while not ready.wait(timeout=1.0):
        assert th.is_alive(), "the api server exited before listening"
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    return url, box, th


def _stop(box, th):
    box["server"].shutdown()
    th.join(timeout=120)
    assert box.get("rc") == 0


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _complete(url, body):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _metric(text: str, line_prefix: str) -> float:
    for line in text.splitlines():
        if line.startswith(line_prefix + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{line_prefix} not in /metrics")


@pytest.mark.parametrize("extra", [[], ["--batch-slots", "2", "--kv-block-size", "16"],
                                   ["--batch-slots", "2"]],
                         ids=["single", "paged", "dense"])
def test_metrics_and_debug_routes_on_both_api_states(api_files, extra):
    url, box, th = _serve(api_files, *extra)
    try:
        outs = [_complete(url, {"messages": [{"role": "user", "content": f"hi {i}"}],
                                "max_tokens": 5}) for i in range(2)]
        status, ctype, text = _get(url, "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        n_completion = sum(o["usage"]["completion_tokens"] for o in outs)
        n_prompt = sum(o["usage"]["prompt_tokens"] for o in outs)
        assert _metric(text, "dllama_completion_tokens_total") == n_completion
        assert _metric(text, "dllama_prompt_tokens_total") == n_prompt
        assert _metric(text, 'dllama_http_requests_total{route="/v1/chat/completions",'
                             'status="200"}') == 2
        assert _metric(text, "dllama_ttft_ms_count") == 2
        if extra:
            assert _metric(text, "dllama_batch_tokens_total") == n_completion
            assert _metric(text, "dllama_admissions_total") == 2
        else:
            assert _metric(text, "dllama_decode_tokens_total") == n_completion
        assert _metric(text, "dllama_requests_in_flight") == 0
        status, _, body = _get(url, "/debug")
        assert status == 200 and set(json.loads(body)["endpoints"]) == {
            "/debug/requests", "/debug/flight", "/debug/timeline", "/debug/numerics",
            "/debug/eval", "/debug/tenants", "/debug/compiles", "/debug/profile",
            "/debug/roofline"}
        reqs = json.loads(_get(url, "/debug/requests")[2])["requests"]
        assert len(reqs) == 2 and all(r["phases"] for r in reqs)
        flight = json.loads(_get(url, "/debug/flight")[2])
        assert {"ticks", "events", "spans"} <= set(flight)
        trace = json.loads(_get(url, "/debug/timeline")[2])
        assert flightrec.validate_chrome_trace(
            trace, expect_rids={r["request_id"] for r in reqs}) == []
        # the device-observability routes answer (their keys against the JAX
        # package's: tests/test_torch_introspection.py)
        for route, keys in (("/debug/compiles", {"steady", "programs", "events"}),
                            ("/debug/roofline", {"ceilings", "programs"})):
            status, _, body = _get(url, route)
            assert status == 200 and keys <= set(json.loads(body))
        # the scrape itself counts
        assert _metric(_get(url, "/metrics")[2],
                       'dllama_http_requests_total{route="/metrics",status="200"}') == 2
    finally:
        _stop(box, th)


# -- --trace-out -------------------------------------------------------------


def test_trace_out_spans_batched_api(api_files, tmp_path):
    path = tmp_path / "spans.jsonl"
    url, box, th = _serve(api_files, "--batch-slots", "2", "--kv-block-size", "16",
                          "--trace-out", str(path))
    try:
        for i in range(3):
            _complete(url, {"messages": [{"role": "user", "content": f"trace {i}"}],
                            "max_tokens": 4})
    finally:
        _stop(box, th)
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    by_rid: dict = {}
    for s in spans:
        by_rid.setdefault(s["request_id"], []).append(s["phase"])
        assert s["end_ns"] >= s["start_ns"]
    assert len(by_rid) == 3
    for phases in by_rid.values():
        for ph in ("queue", "admit", "prefill", "decode"):
            assert phases.count(ph) == 1, phases
        assert phases.count("prefill_chunk") >= 1
    assert not tm.tracer().enabled  # the server closed its sink


def test_trace_out_spans_inference_cli(files, tmp_path, capsys):
    m, t = files
    path = tmp_path / "spans.jsonl"
    assert cli.main(["inference", "--model", m, "--tokenizer", t, "--device", "cpu",
                     "--prompt", "hello world", "--steps", "20", "--temperature", "0",
                     "--spec-lookup", "2", "--trace-out", str(path)]) == 0
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    phases = [s["phase"] for s in spans]
    assert phases.count("prefill") == 1 and phases.count("verify") >= 1
    assert {s["request_id"] for s in spans} == {-1}
    assert next(s["n_tokens"] for s in spans if s["phase"] == "prefill") > 0
    assert not tm.tracer().enabled
