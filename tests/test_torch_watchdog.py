"""The port's step watchdog (``dllama_tpu_torch/runtime/watchdog.py``)
against the JAX package's: the EWMA budget for the same observed step
times, no deadline armed before ``min_samples``, exactly one trip per
stalled guard with the ``on_stall`` callbacks called, ``DLLAMA_WATCHDOG=0``
and the budget knobs; then the serving path: a ``step_hang`` past the
budget fails every in-flight request as the JAX scheduler fails them,
flips ``/readyz`` and leaves a flight dump. The stalls sleep several
budgets long and nothing asserts a wall-clock bound, so a loaded machine
cannot turn a pass into a failure."""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime import watchdog as jwd
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import flightrec, telemetry as tm
from dllama_tpu_torch.runtime import watchdog as wd
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

BOTH = pytest.mark.parametrize("mod,tel", [(wd, tm), (jwd, jtm)], ids=["port", "jax"])


def wait_until(cond, timeout_s: float = 60.0) -> None:
    """Poll ``cond`` (a stalled guard stays inside its dispatch until the
    monitor has tripped and called back, however loaded the machine)."""
    t_end = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < t_end, "timed out waiting"
        time.sleep(0.01)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("DLLAMA_FLIGHT_DIR", str(tmp_path))
    for k in ("DLLAMA_WATCHDOG", "DLLAMA_WATCHDOG_MARGIN", "DLLAMA_WATCHDOG_FLOOR_S"):
        monkeypatch.delenv(k, raising=False)
    for tel in (tm, jtm):
        tel.registry().reset()
    flightrec.recorder().reset()
    fp.registry().clear()
    yield
    fp.registry().clear()


@pytest.mark.parametrize("seq", [[5.0, 6.0, 4.0, 100.0, 5.0],
                                 [3000.0, 12.0, 11.5, 13.0, 12.2, 12.0, 900.0],
                                 [0.2] * 8])
@pytest.mark.parametrize("kw", [{}, dict(margin=3.0, min_budget_s=0.01, min_samples=2,
                                          alpha=0.5)])
def test_budget_equals_jax(seq, kw):
    mine = wd.StepWatchdog("a", enabled=True, **kw)
    theirs = jwd.StepWatchdog("a", enabled=True, **kw)
    for ms in seq:
        assert mine.budget_s() == theirs.budget_s()
        mine.observe(ms)
        theirs.observe(ms)
        assert mine.ewma_ms == theirs.ewma_ms
    assert mine.budget_s() == theirs.budget_s() is not None
    assert (wd.DEFAULT_MARGIN, wd.DEFAULT_FLOOR_S, wd.DEFAULT_MIN_SAMPLES,
            wd.DEFAULT_ALPHA) == (jwd.DEFAULT_MARGIN, jwd.DEFAULT_FLOOR_S,
                                  jwd.DEFAULT_MIN_SAMPLES, jwd.DEFAULT_ALPHA)


@BOTH
def test_nothing_arms_before_min_samples(mod, tel):
    w = mod.StepWatchdog("warm", min_samples=3, min_budget_s=30.0, enabled=True)
    try:
        for i in range(3):
            assert w.budget_s() is None
            with w.guard("step"):
                pass
            assert w._thread is None and w.n_samples == i + 1  # no deadline, no monitor
        with w.guard("step"):
            assert w._deadline is not None
        assert w._thread is not None and w._deadline is None
        assert not w.stalled and w.stall_count == 0
    finally:
        w.close()


@BOTH
def test_one_trip_per_stall_with_callbacks(mod, tel):
    w = mod.StepWatchdog("stall", min_samples=1, min_budget_s=0.05, margin=1.0, enabled=True)
    w.observe(1.0)
    seen: list = []
    w.on_stall.append(seen.append)
    w.on_stall.append(lambda info: 1 / 0)  # a failing callback is reported, not fatal
    w.on_stall.append(lambda info: seen.append("after"))
    try:
        with w.guard("first"):
            wait_until(lambda: len(seen) == 2)  # the dispatch stays wedged
            time.sleep(0.2)  # still wedged: no second trip for this guard
        assert w.stalled and w.stall_count == 1
        assert [s if isinstance(s, str) else s["label"] for s in seen] == ["first", "after"]
        assert seen[0]["name"] == "stall" and seen[0]["waited_s"] >= seen[0]["budget_s"] > 0
        with w.guard("second"):
            wait_until(lambda: len(seen) == 4)
        assert w.stall_count == 2 and len(seen) == 4
    finally:
        w.close()
    assert tel.registry().counter(tel.WATCHDOG_STALLS).total(name="stall") == 2


@BOTH
def test_env_knobs(mod, tel, monkeypatch):
    monkeypatch.setenv("DLLAMA_WATCHDOG", "0")
    off = mod.StepWatchdog("off", min_samples=1)
    for _ in range(5):
        with off.guard("x"):
            pass
    assert not off.enabled and off.budget_s() is None and off._thread is None
    monkeypatch.setenv("DLLAMA_WATCHDOG", "1")
    monkeypatch.setenv("DLLAMA_WATCHDOG_MARGIN", "4")
    monkeypatch.setenv("DLLAMA_WATCHDOG_FLOOR_S", "0.5")
    on = mod.StepWatchdog("on", min_samples=1)
    on.observe(1000.0)
    assert on.enabled and on.budget_s() == 4.0
    on.observe(1.0)
    assert on.budget_s() == 0.5 or on.budget_s() == max(0.5, on.ewma_ms / 1000 * 4)


# -- the serving path --------------------------------------------------------


@pytest.fixture
def stall_engine(tmp_path, monkeypatch):
    """A paged engine whose watchdog has a 3 s floor and margin 2 (set
    before the engine is built, as the knobs are read there): a normal
    step of the tiny model stays far below it even on a loaded machine."""
    monkeypatch.setenv("DLLAMA_WATCHDOG_FLOOR_S", "3.0")
    monkeypatch.setenv("DLLAMA_WATCHDOG_MARGIN", "2")
    mpath, tpath = tmp_path / "m.m", tmp_path / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(47))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"
    tfile.write_tfile(tpath, td)
    eng = InferenceEngine(str(mpath), str(tpath), device="cpu", kv_block_size=16)
    yield eng, str(mpath), str(tpath)
    eng.close()


def test_step_hang_stall_fails_in_flight_and_dumps(stall_engine, tmp_path):
    eng, _, _ = stall_engine
    sched = BatchScheduler(eng, n_slots=2)
    try:
        ids = eng.tokenizer.encode("hello world", is_start=True)
        warm = sched.submit(ids, 6, stop_on_eos=False)
        assert warm.done.wait(timeout=300) and warm.error is None
        assert eng.watchdog.budget_s() is not None  # trained: armed from here on
        fp.arm("step_hang", "sleep", times=1, delay_s=15.0)
        victims = [sched.submit(ids, 6, stop_on_eos=False) for _ in range(3)]
        for r in victims:
            assert r.done.wait(timeout=300)
        # the JAX scheduler's failure semantics: every request fails
        # 503-shaped naming the stalled dispatch, the server goes unready
        for r in victims:
            assert r.server_error and "step watchdog" in r.error and "batch_" in r.error
        assert sched.readiness() == (False, "step watchdog tripped (wedged device dispatch)",
                                     "crashed")
        assert not sched.is_alive()
        assert tm.registry().counter(tm.WATCHDOG_STALLS).total() == 1
        # the monitor writes the postmortem right after failing the requests
        dumped = tm.registry().counter(tm.FLIGHT_DUMPS)
        for _ in range(600):
            if dumped.total(reason="watchdog_stall"):
                break
            time.sleep(0.05)
        assert dumped.total(reason="watchdog_stall") == 1
        dumps = glob.glob(os.path.join(str(tmp_path), "dllama-flight-*-watchdog_stall.json"))
        assert len(dumps) == 1
        doc = json.loads(open(dumps[0]).read())
        assert sorted(doc["victims"]) == sorted(r.rid for r in victims)
        assert doc["info"]["label"].startswith("batch_")
        assert cli.main(["timeline", "--dump", dumps[0],
                         "--out", str(tmp_path / "t.json")]) == 0
    finally:
        sched.close()


def test_single_sequence_readyz_after_a_stall(stall_engine):
    """The single-sequence API state flips ``/readyz`` on a stalled
    engine too (no scheduler to supervise)."""
    from dllama_tpu_torch.serve.api import ApiState

    eng, _, _ = stall_engine
    state = ApiState(eng)
    assert state.readiness() == (True, "ok", "ok")
    eng.watchdog.stalled = True
    assert state.readiness()[2] == "crashed"
