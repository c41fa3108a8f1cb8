"""The port's failpoints (``dllama_tpu_torch/runtime/failpoints.py``) against
the JAX package's: the ``DLLAMA_FAILPOINTS`` spec grammar, ``times`` and
every action; then each wired site behaves as the JAX package's does —
``load_read`` (the loader's retries), ``kv_alloc`` (exhaustion degrades to
queueing), ``step:raise`` (crash, fail-all, restart), ``admit`` (one
request rejected), ``draft`` (the slot degrades to plain decode) — with the
schedulers of both packages driven tick by tick over the same requests,
and ``emit:broken_pipe`` on the port's API (a client disconnect)."""

from __future__ import annotations

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import failpoints as jfp
from dllama_tpu.runtime import flightrec as jflight
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.serving import BatchScheduler as JaxScheduler
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import flightrec, telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

PROMPTS = ["hello world", "hello there", "abc", "hello world how are you"]


def _reset_all() -> None:
    for mod, tel, rec in ((fp, tm, flightrec), (jfp, jtm, jflight)):
        mod.registry().clear()
        tel.registry().reset()
        tel.tracer()._ring.clear()
        rec.recorder().reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("DLLAMA_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv("DLLAMA_FAILPOINTS", raising=False)
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_failpoints")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(43))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3 (the API test)
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


@pytest.fixture(scope="module")
def engines(files):
    """Paged engines of both packages, without and with ``--spec-lookup 3``."""
    m, t = files
    built = {spec: (InferenceEngine(m, t, device="cpu", kv_block_size=16, spec_lookup=spec),
                    JaxEngine(m, t, tp=1, kv_block_size=16, spec_lookup=spec))
             for spec in (0, 3)}
    yield built
    for a, b in built.values():
        a.close()
        b.close()


# -- the registry ------------------------------------------------------------


def _armed(mod) -> dict:
    reg = mod.registry()
    return {k: (a.action, a.times, a.delay_s, a.mode) for k, a in reg._armed.items()}


@pytest.mark.parametrize("spec", [
    "step:raise", "step:raise:2,emit:broken_pipe", " admit:oserror:1 , draft:short_read ",
    "step_hang:sleep:3,kv_alloc:raise", "logits:nonfinite,load_read:conn_reset:5", ""])
def test_spec_parsing_equals_jax(spec):
    fp.registry().configure(spec)
    jfp.registry().configure(spec)
    assert _armed(fp) == _armed(jfp)
    assert bool(_armed(fp)) == bool(spec.strip())


@pytest.mark.parametrize("spec", ["step", "step:explode", "step:raise:0", "a:raise:1:2",
                                  "step:raise:x"])
def test_bad_specs_raise_like_jax(spec):
    with pytest.raises(ValueError) as mine:
        fp.registry().configure(spec)
    with pytest.raises(ValueError) as theirs:
        jfp.registry().configure(spec)
    assert str(mine.value) == str(theirs.value)


def _outcomes(mod, action: str) -> list:
    mod.arm("site", action, times=2, delay_s=0.01, mode="inf")
    out = []
    for _ in range(3):
        try:
            out.append(("returned", mod.fire("site")))
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append(("raised", type(e).__name__, isinstance(e, OSError), str(e)))
    return out + [mod.registry().fired("site"), mod.registry().armed("site")]


@pytest.mark.parametrize("action", sorted(fp._ACTIONS))
def test_times_and_actions_equal_jax(action):
    got, want = _outcomes(fp, action), _outcomes(jfp, action)
    assert got == want
    assert got[2] == ("returned", None) and got[3] == 2 and got[4] is False
    assert tm.registry().counter(tm.FAILPOINTS_FIRED).total(name="site") == 2
    assert jtm.registry().counter(jtm.FAILPOINTS_FIRED).total(name="site") == 2
    assert fp.fire("never-armed") is None


def test_configure_from_env_equals_jax(monkeypatch):
    assert fp.configure_from_env() is jfp.configure_from_env() is False
    monkeypatch.setenv("DLLAMA_FAILPOINTS", "step:raise:1,emit:broken_pipe")
    assert fp.configure_from_env() is jfp.configure_from_env() is True
    assert _armed(fp) == _armed(jfp) and set(_armed(fp)) == {"step", "emit"}


# -- the wired sites, both packages -------------------------------------------


def run_ticks(sched, reqs, max_ticks=5000):
    """Tick the scheduler on this thread as its loop does (a raise goes to
    the crash supervisor) until every request is done."""
    for _ in range(max_ticks):
        if all(r.done.is_set() for r in reqs):
            return
        try:
            sched._tick()
        except Exception as e:  # noqa: BLE001 — the loop's supervision
            sched._on_crash(e)
    raise AssertionError("requests never finished")


def serve_both(engines, spec, arm, prompts=PROMPTS, max_tokens=6, more=()):
    """The same requests through a port and a JAX paged scheduler (2
    slots, tick-driven), each after ``arm(failpoints module)``; ``more``
    prompts are submitted after the first wave is done. Returns per package
    the requests' (tokens, error, server_error) and the telemetry counters."""
    out = []
    for eng, Sched, fmod, tel in ((engines[spec][0], BatchScheduler, fp, tm),
                                  (engines[spec][1], JaxScheduler, jfp, jtm)):
        arm(fmod)
        sched = Sched(eng, n_slots=2, _start_thread=False)
        enc = [eng.tokenizer.encode(p, is_start=True) for p in prompts]
        reqs = [sched.submit(ids, max_tokens, stop_on_eos=False) for ids in enc]
        run_ticks(sched, reqs)
        late = [sched.submit(eng.tokenizer.encode(p, is_start=True), max_tokens,
                             stop_on_eos=False) for p in more]
        run_ticks(sched, late)
        assert sched.readiness()[0]
        sched.close()
        fmod.registry().clear()
        reg = tel.registry()
        names = ("BATCH_TOKENS", "ADMISSIONS", "RETIRES", "KV_BLOCK_EXHAUSTION",
                 "SCHEDULER_CRASHES", "SCHEDULER_RESTARTS", "SPEC_DEGRADED",
                 "SPEC_DRAFT_TOKENS", "FAILPOINTS_FIRED")
        out.append(([(r.tokens, r.error, r.server_error) for r in reqs + late],
                    {n: reg.counter(getattr(tel, n)).total() for n in names}))
    return out


def test_kv_alloc_exhaustion_requeues_like_jax(engines):
    (mine, got), (theirs, want) = serve_both(
        engines, 0, lambda mod: mod.arm("kv_alloc", "raise", times=1))
    assert mine == theirs and got == want
    assert got["KV_BLOCK_EXHAUSTION"] == 1 and got["FAILPOINTS_FIRED"] == 1
    assert all(err is None and len(toks) == 6 for toks, err, _ in mine)


def test_step_raise_crashes_fails_all_and_restarts_like_jax(engines):
    (mine, got), (theirs, want) = serve_both(
        engines, 0, lambda mod: mod.arm("step", "raise", times=1), more=["xyzzy", "abc"])
    assert mine == theirs and got == want
    assert got["SCHEDULER_CRASHES"] == 1 and got["SCHEDULER_RESTARTS"] == 1
    first, late = mine[:len(PROMPTS)], mine[len(PROMPTS):]
    assert all(srv and "scheduler crashed: FailpointError" in err for _, err, srv in first)
    assert all(err is None and len(toks) == 6 for toks, err, _ in late)


def test_admit_raise_rejects_one_request_like_jax(engines):
    (mine, got), (theirs, want) = serve_both(
        engines, 0, lambda mod: mod.arm("admit", "raise", times=1))
    assert mine == theirs and got == want
    assert mine[0][1] == "FailpointError: failpoint 'admit' fired" and not mine[0][2]
    assert all(err is None for _, err, _ in mine[1:])
    assert got["ADMISSIONS"] == got["RETIRES"] == len(PROMPTS) - 1


def test_draft_raise_degrades_to_plain_decode_like_jax(engines):
    (clean, _), _ = serve_both(engines, 3, lambda mod: None)
    _reset_all()
    (mine, got), (theirs, want) = serve_both(
        engines, 3, lambda mod: mod.arm("draft", "raise", times=5))
    assert mine == theirs and got == want
    assert got["SPEC_DEGRADED"] == 5
    assert [t for t, _, _ in mine] == [t for t, _, _ in clean]  # greedy: same tokens


@pytest.mark.parametrize("action,retries", [("oserror", 2), ("short_read", 1)])
def test_load_read_retries_like_jax(files, action, retries):
    m, t = files
    for mod, tel, build in ((fp, tm, lambda: InferenceEngine(m, t, device="cpu")),
                            (jfp, jtm, lambda: JaxEngine(m, t, tp=1))):
        mod.arm("load_read", action, times=retries)
        eng = build()
        eng.close()
        assert tel.registry().counter(tel.WEIGHT_IO_RETRIES).total() == retries
        assert mod.registry().fired("load_read") == retries


def test_load_read_raise_fails_the_load_like_jax(files):
    m, t = files
    for mod, build in ((fp, lambda: InferenceEngine(m, t, device="cpu")),
                       (jfp, lambda: JaxEngine(m, t, tp=1))):
        mod.arm("load_read", "raise", times=1)
        with pytest.raises(mod.FailpointError):
            build()
    assert tm.registry().counter(tm.WEIGHT_IO_RETRIES).total() == 0


# -- emit: the SSE write on the port's API -------------------------------------


def test_emit_broken_pipe_is_a_client_disconnect(files):
    m, t = files
    box, ready = {}, threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        ready.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0",
         "--batch-slots", "2", "--kv-block-size", "16", "--temperature", "0"],
        on_listening=on_listening)), daemon=True)
    th.start()
    while not ready.wait(timeout=1.0):
        assert th.is_alive(), "the api server exited before listening"
    host, port = box["server"].server_address[:2]
    try:
        fp.arm("emit", "broken_pipe", times=1)
        body = json.dumps({"messages": [{"role": "user", "content": "hi"}],
                           "max_tokens": 4, "stream": True}).encode()
        with socket.create_connection((host, port), timeout=60) as sk:
            sk.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Type: application/json\r\nContent-Length: "
                       + str(len(body)).encode() + b"\r\n\r\n" + body)
            got = b""
            while chunk := sk.recv(65536):
                got += chunk
        assert b"[DONE]" not in got  # the stream ended at the injected failure
        reg = tm.registry()
        for _ in range(1200):  # the handler counts after the socket closes
            if reg.counter(tm.HTTP_REQUESTS).total(status="client_disconnect"):
                break
            threading.Event().wait(0.05)
        assert reg.counter(tm.HTTP_REQUESTS).total(
            route="/v1/chat/completions", status="client_disconnect") == 1
        # the cancelled slot is free again: the next request completes
        req = urllib.request.Request(f"http://{host}:{port}/v1/chat/completions",
                                     data=json.dumps({"messages": [{"role": "user",
                                                                    "content": "again"}],
                                                      "max_tokens": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] >= 1
    finally:
        box["server"].shutdown()
        th.join(timeout=120)
    assert box.get("rc") == 0
