"""The port's flight recorder (``dllama_tpu_torch/runtime/flightrec.py``)
against the JAX package's: the Chrome trace and its validation of the
golden dump (``tests/goldens/flight_dump.json``), the validator's findings
on broken traces, the TTFT phase formula, the recorder's rings under one
injected clock, the rings a serving run leaves (one tick per work-carrying
tick, a complete flow per request, the same decisions as the JAX
scheduler's), and the ``timeline`` mode's exit codes. Structure and
integers compare exactly; the TTFT phases sum to the TTFT by construction,
and no wall-clock bound is held."""

from __future__ import annotations

import copy
import json
import pathlib

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import flightrec as jflight
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.serving import BatchScheduler as JaxScheduler
from dllama_tpu.serve.cli import main as jax_main
from dllama_tpu_torch.runtime import flightrec, telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "flight_dump.json"
PROMPTS = ["hello world", "hello there", "abc", "hello world how are you", "xyzzy",
           "hello hello hello"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("DLLAMA_FLIGHT_DIR", str(tmp_path))
    for tel, rec in ((tm, flightrec), (jtm, jflight)):
        tel.registry().reset()
        tel.tracer()._ring.clear()
        rec.recorder().reset()
    yield


def test_golden_trace_equals_jax():
    data = json.loads(GOLDEN.read_text())
    got = flightrec.to_chrome_trace(copy.deepcopy(data))
    assert got == jflight.to_chrome_trace(copy.deepcopy(data))
    rids = {s["request_id"] for s in data["spans"]}
    assert flightrec.validate_chrome_trace(got, expect_rids=rids) == []
    assert jflight.validate_chrome_trace(got, expect_rids=rids) == []


def _broken(trace: dict, how: str) -> dict:
    bad = copy.deepcopy(trace)
    ev = bad["traceEvents"]
    if how == "ts":
        [e for e in ev if e["ph"] == "X"][-1]["ts"] = 0.0
    elif how == "flow":
        next(e for e in ev if e["ph"] == "f")["ph"] = "t"
    elif how == "dur":
        next(e for e in ev if e["ph"] == "X")["dur"] = -1.0
    elif how == "events":
        bad["traceEvents"] = {}
    elif how == "ts_type":
        next(e for e in ev if e["ph"] == "C")["ts"] = "soon"
    return bad


@pytest.mark.parametrize("how", ["ts", "flow", "dur", "events", "ts_type"])
def test_validator_findings_equal_jax(how):
    trace = _broken(flightrec.to_chrome_trace(json.loads(GOLDEN.read_text())), how)
    got = flightrec.validate_chrome_trace(trace, expect_rids=[1, 2, 99])
    assert got and got == jflight.validate_chrome_trace(trace, expect_rids=[1, 2, 99])


@pytest.mark.parametrize("seed", range(5))
def test_ttft_phases_equal_jax(seed):
    rng = np.random.default_rng(seed)
    t_submit = int(rng.integers(1, 10**12))
    t_admit = t_submit + int(rng.integers(0, 5 * 10**8))
    t_decode = t_admit + int(rng.integers(0, 5 * 10**8))
    t_first = t_decode + int(rng.integers(0, 10**8))
    walls = [float(x) for x in rng.exponential(100.0, size=3)]
    bd = flightrec.ttft_phases(t_submit, t_admit, t_decode, t_first, *walls)
    assert bd == jflight.ttft_phases(t_submit, t_admit, t_decode, t_first, *walls)
    parts = sum(v for k, v in bd.items() if k != "ttft_ms")
    assert abs(parts - bd["ttft_ms"]) <= 1e-9 * max(1.0, bd["ttft_ms"])
    mine, theirs = tm.Registry(), jtm.Registry()
    flightrec.record_ttft(mine.histogram(tm.TTFT_ATTRIB_MS), bd)
    jflight.record_ttft(theirs.histogram(jtm.TTFT_ATTRIB_MS), bd)
    assert mine.render() == theirs.render()


def _script(rec) -> dict:
    """One scripted sequence of ticks and events on a recorder."""
    for i in range(flightrec.RING_TICKS + 10):
        rec.begin_tick(queue_depth=i % 3, n_admissions=i % 2)
        if i % 4:
            rec.note("admit", i, reason="r" if i % 3 else "", slot=i % 2)
            rec.note_dispatch(1.5, 2, 3)
            rec.note_prefill(i, 0.5, 16)
            rec.note_spec(4, i % 5)
        rec.end_tick(blocks={"used": i, "shared": 1}, slots=[i, None])
    rec.begin_tick(queue_depth=9)
    rec.note("crash", reason="Boom")
    return rec.snapshot()


def test_recorder_rings_equal_jax():
    clock = iter(range(0, 10**9, 7))
    theirs = iter(range(0, 10**9, 7))
    got = _script(flightrec.FlightRecorder(clock=lambda: next(clock)))
    want = _script(jflight.FlightRecorder(clock=lambda: next(theirs)))
    assert got == want
    # every fourth tick carried no work and was dropped: 199 kept, then the open one
    assert len(got["ticks"]) == 200 and got["ticks"][-1]["open"]
    assert all(t["decisions"] or t.get("open") for t in got["ticks"])


def test_dump_is_rate_limited_and_loadable(tmp_path):
    rec = flightrec.FlightRecorder()
    rec.begin_tick()
    rec.note("admit", 3)
    rec.end_tick()
    path = rec.dump("scheduler_crash", victims=[3], info={"error": "x"})
    assert path and pathlib.Path(path).parent == tmp_path
    assert rec.dump("scheduler_crash") is None  # the same reason within the window
    assert rec.dump("watchdog_stall") is not None
    doc = json.loads(pathlib.Path(path).read_text())
    assert doc["reason"] == "scheduler_crash" and doc["victims"] == [3]
    assert {"ticks", "events", "spans", "requests", "pid"} <= set(doc)
    assert tm.registry().counter(tm.FLIGHT_DUMPS).total() == 2


# -- the rings of a serving run ------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_flightrec")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(31))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


def _run(sched, enc):
    reqs = [sched.submit(ids, 8, stop_on_eos=False, temperature=0.7 * (i % 2), seed=i)
            for i, ids in enumerate(enc)]
    for _ in range(5000):
        if all(r.done.is_set() for r in reqs):
            break
        sched._tick()
    sched.close()
    return reqs


def _events(rec) -> list:
    return [(e["event"], e["rid"], e.get("reason", ""), e["tick"])
            for e in rec.snapshot()["events"]]


def test_serving_rings_one_tick_per_work_tick_and_complete_flows(files):
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", kv_block_size=16)
    jeng = JaxEngine(m, t, tp=1, kv_block_size=16)
    try:
        enc = [eng.tokenizer.encode(p, is_start=True) for p in PROMPTS]
        reqs = _run(BatchScheduler(eng, n_slots=2, _start_thread=False), enc)
        snap = flightrec.recorder().snapshot()
        spans = tm.tracer().raw_spans()
        events = _events(flightrec.recorder())
        _run(JaxScheduler(jeng, n_slots=2, _start_thread=False), enc)
        want_events = _events(jflight.recorder())
    finally:
        eng.close()
        jeng.close()
    ticks = snap["ticks"]
    assert len(ticks) == tm.registry().counter(tm.FLIGHT_TICKS).total()
    assert all(tk["decisions"] or tk["dispatch_ms"] or tk["prefill_ms"] for tk in ticks)
    assert sum(tk["decode_tokens"] for tk in ticks) == sum(len(r.tokens) for r in reqs)
    # every prompt position is prefilled once, or skipped by prefix reuse
    assert sum(tk["prefill_tokens"] for tk in ticks) == sum(
        len(r.prompt_ids) - 1 for r in reqs) - tm.registry().counter(
            tm.PREFIX_REUSE_TOKENS).total()
    assert events == want_events  # the same lifecycle, tick for tick
    for r in reqs:
        bd = r.ttft_breakdown()
        parts = sum(v for k, v in bd.items() if k != "ttft_ms")
        assert abs(parts - bd["ttft_ms"]) <= 1e-6 * max(1.0, bd["ttft_ms"])
        assert [e[0] for e in events if e[1] == r.rid][:2] == ["submit", "admit"]
    trace = flightrec.to_chrome_trace({**snap, "spans": spans})
    assert flightrec.validate_chrome_trace(trace, expect_rids={r.rid for r in reqs}) == []
    for r in reqs:
        phases = [s["phase"] for s in spans if s["request_id"] == r.rid]
        for ph in ("queue", "admit", "prefill", "decode"):
            assert phases.count(ph) == 1, (r.rid, phases)


# -- the timeline mode ---------------------------------------------------------


def _dumps(tmp_path) -> dict:
    good = json.loads(GOLDEN.read_text())
    negative = copy.deepcopy(good)
    for s in negative["spans"]:
        s["end_ns"] = s["start_ns"] - 10**6  # spans that end before they start
    string_ts = copy.deepcopy(good)
    string_ts["spans"][0]["start_ns"] = "soon"
    cases = {"good": json.dumps(good), "not_json": "{ticks:", "a_list": "[1, 2]",
             "missing_field": json.dumps({"ticks": [{"tick": 1}]}),
             "bad_spans": json.dumps({"spans": [{"request_id": 1}]}),
             "empty_object": "{}", "negative_durations": json.dumps(negative),
             "string_ts": json.dumps(string_ts)}
    paths = {}
    for name, text in cases.items():
        p = tmp_path / f"{name}.json"
        p.write_text(text)
        paths[name] = str(p)
    paths["missing_file"] = str(tmp_path / "nope.json")
    return paths


# a converted dump is valid (0) or the converter names the fault (1);
# negative span durations are clamped to 0 by the converter
TIMELINE_RC = {"good": 0, "not_json": 1, "a_list": 1, "missing_field": 1, "bad_spans": 1,
               "empty_object": 0, "negative_durations": 0, "string_ts": 1,
               "missing_file": 1}


@pytest.mark.parametrize("case", sorted(TIMELINE_RC))
def test_timeline_exit_codes_equal_jax(tmp_path, case, capsys):
    path = _dumps(tmp_path)[case]
    out_mine, out_theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    rc = cli.main(["timeline", "--dump", path, "--out", str(out_mine)])
    assert rc == jax_main(["timeline", "--dump", path, "--out", str(out_theirs)])
    assert rc == TIMELINE_RC[case]
    if out_theirs.exists():
        assert json.loads(out_mine.read_text()) == json.loads(out_theirs.read_text())
    with pytest.raises(SystemExit, match="--dump"):
        cli.main(["timeline"])
