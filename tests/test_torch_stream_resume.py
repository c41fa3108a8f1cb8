"""Durable streams on the port (``dllama_tpu_torch/serve/router.py`` +
``serve/api.py`` + ``runtime/serving.py``): a streaming request survives the
death of its serving replica with a gapless, duplicate-free transcript, the
one an unbroken run gives.

Fleets of two or three port replicas on the CPU behind the port's router,
over the paged pool and the dense one. The kill is the one
``tests/test_stream_resume.py`` makes: ``BatchedApiState.close(drain_s=0)``
fails the scheduler mid-generation, the handler writes the terminal
``finish_reason: "error"`` chunk over a cleanly closed socket, and the router
must splice a continuation on a healthy replica. Greedy, sampled, and
speculation on: each transcript equals the port's unbroken solo run token
for token; the greedy one equals the JAX solo replica's, and the sampled one
equals it or parts at the top-p boundary signature of ROADMAP C6. Past the
resume budget the stream ends with the terminal 502 event (``exhausted``
with ``--max-stream-resumes 0``, ``no_budget`` past the request deadline)."""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.serve.api import BatchedApiState, make_handler
from dllama_tpu_torch.serve.router import FleetRouter, make_router_handler

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_router import _sse_events, _wait
from test_stream_resume import _body, _open_stream, _post_json, _read_until_stamped, _transcript
from test_torch_spec_serving import _assert_topp_boundary_departure

BLOCK = 16


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.registry().clear()
    yield
    fp.registry().clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream_resume")
    mpath, tpath = d / "m.m", d / "t.t"
    # seq_len 256: the ~130-token templated prompt plus a generation long
    # enough that the kill always lands mid-stream (the JAX test's model)
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(23))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


def _state(files, paged=True, spec=0):
    m, t = files
    engine = InferenceEngine(m, t, device="cpu", kv_block_size=BLOCK if paged else 0,
                             temperature=0.0, seed=3, spec_lookup=spec)
    return BatchedApiState(engine, n_slots=2)


def _serve(state):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


class _Fleet:
    """N port replicas behind the port's FleetRouter, name → state."""

    def __init__(self, files, n, paged=True, spec=0, **router_kw):
        self.by_name: dict = {}
        self.httpds = []
        urls = []
        for _ in range(n):
            st = _state(files, paged, spec)
            httpd, port = _serve(st)
            self.httpds.append(httpd)
            self.by_name[f"127.0.0.1:{port}"] = st
            urls.append(f"127.0.0.1:{port}")
        router_kw.setdefault("probe_interval_s", 0.05)
        self.fleet = FleetRouter(urls, **router_kw)
        self.r_httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_router_handler(self.fleet))
        self.url = f"http://127.0.0.1:{self.r_httpd.server_address[1]}"
        threading.Thread(target=self.r_httpd.serve_forever, daemon=True).start()
        _wait(lambda: all(r.state == "up" for r in self.fleet.replicas), timeout=60,
              what="replicas probed up")

    def sticky(self, key) -> str:
        with self.fleet._lock:
            return self.fleet._affinity[key].name

    def close(self):
        self.r_httpd.shutdown()
        self.r_httpd.server_close()
        self.fleet.close()
        for h in self.httpds:
            h.shutdown()
            h.server_close()
        for st in self.by_name.values():
            st.close()
            st.engine.close()


@pytest.fixture(scope="module", params=["paged", "dense"])
def oracle(request, files):
    """The unkilled solo baseline of one pool: one port replica, no router,
    never killed."""
    state = _state(files, paged=request.param == "paged")
    httpd, port = _serve(state)
    yield request.param, f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()
    state.close()
    state.engine.close()


def _oracle_run(url, body):
    with _open_stream(url, body) as r:
        return _transcript(_sse_events(r.read()))


def _resumes(outcome):
    return tm.registry().counter(tm.ROUTER_STREAM_RESUMES).total(outcome=outcome)


def _kill_mid_stream(fl, body, after=2, before_kill=None):
    """Warm the session (binds affinity), open the stream, kill the serving
    replica after ``after`` stamped chunks; return (raw bytes, victim)."""
    _post_json(fl.url, dict(body, stream=False, max_tokens=4))
    victim = fl.sticky(f"sid:{body['session_id']}")
    resp = _open_stream(fl.url, body)
    raw = _read_until_stamped(resp, after)
    if before_kill is not None:
        before_kill()
    fl.by_name[victim].close(drain_s=0.0)  # the replica dies NOW
    raw += resp.read()
    return raw, victim


def _jax_tokens(files, body, paged):
    """The JAX solo replica's streamed token ids for ``body``."""
    from dllama_tpu.serve.api import BatchedApiState as JaxState

    m, t = files
    eng = JaxEngine(m, t, tp=1, kv_block_size=BLOCK if paged else 0, temperature=0.0,
                    seed=3)
    state = JaxState(eng, n_slots=2)
    toks: list[int] = []
    try:
        state.complete(dict(body), emit=lambda d, meta: toks.extend(meta["tokens"]))
        prompt = eng.tokenizer.encode(
            state.template.generate([_chat_item(body)], append_generation_prompt=True).content,
            is_start=True, add_special_tokens=True)
    finally:
        state.close()
        eng.close()
    return toks, prompt


def _chat_item(body):
    from dllama_tpu.tokenizer.chat import ChatItem

    m = body["messages"][0]
    return ChatItem(m["role"], m["content"])


def test_greedy_midstream_kill_token_exact(files, oracle):
    """Three replicas, the serving one killed mid-stream: the transcript is
    gapless, duplicate-free and equal to the unbroken solo run and to the
    JAX solo replica's, with a normal finish, the resume on the counter and
    the ``rt_resume`` span in the fleet timeline. A second cycle, resumed on
    the warmed survivor, runs the same path again."""
    pool, url = oracle
    fl = _Fleet(files, 3, paged=pool == "paged")
    try:
        for tag in ("dur-a", "dur-b"):
            body = _body(f"{tag}-{pool}")
            want = _oracle_run(url, body)
            r0 = _resumes("resumed")
            raw, _ = _kill_mid_stream(fl, body)
            events = _sse_events(raw)
            got = _transcript(events)
            assert b'"upstream_error"' not in raw and events[-1] == "[DONE]"
            assert got == want, "spliced transcript diverged from the solo run"
            assert got[3] in ("length", "stop") and got[0] > 4
            assert _resumes("resumed") == r0 + 1
        spans = [s for s in fl.fleet.fleet_snapshot()["spans"] if s["phase"] == "rt_resume"]
        assert len(spans) >= 2 and spans[-1]["resume_from"] >= 2
        jax_toks, _ = _jax_tokens(files, body, pool == "paged")
        assert got[1] == jax_toks, "greedy transcript differs from the JAX solo replica's"
    finally:
        fl.close()


def test_sampled_resume_token_exact(files, oracle):
    """Temperature 0.9, a fixed seed: the coin stream is fast-forwarded by
    the emitted-token count at the splice, so the resumed transcript equals
    the unbroken solo run; against the JAX solo replica it is equal or parts
    at the C6 top-p boundary."""
    pool, url = oracle
    fl = _Fleet(files, 2, paged=pool == "paged")
    try:
        body = _body(f"dur-s-{pool}", temperature=0.9, seed=7)
        want = _oracle_run(url, body)
        assert want[0] > 4
        r0 = _resumes("resumed")
        raw, _ = _kill_mid_stream(fl, body)
        got = _transcript(_sse_events(raw))
        assert got == want, "sampled splice diverged from the solo run"
        assert _resumes("resumed") == r0 + 1
    finally:
        fl.close()
    jax_toks, prompt = _jax_tokens(files, body, pool == "paged")
    m, t = files
    jeng = JaxEngine(m, t, tp=1, temperature=0.0, seed=3)
    try:
        _assert_topp_boundary_departure(jeng, prompt, got[1], jax_toks, 0.9, 0.9, 7)
    finally:
        jeng.close()


def test_spec_on_sampled_resume_equals_spec_off_solo(files):
    """Speculation on (paged pool): exact-match verify keeps sampled spec
    output equal to spec-off, and coins consumed == tokens emitted makes the
    resume fast-forward land on the same coin — so a spec-on fleet's spliced
    transcript equals the spec-off unbroken run, with drafting live."""
    state = _state(files)
    httpd, port = _serve(state)
    fl = _Fleet(files, 2, spec=4)
    try:
        body = _body("dur-v", temperature=0.9, seed=11)
        want = _oracle_run(f"http://127.0.0.1:{port}", body)
        drafted = tm.registry().counter(tm.SPEC_DRAFT_TOKENS)
        d0 = drafted.total(generator="paged")
        r0 = _resumes("resumed")
        raw, _ = _kill_mid_stream(fl, body)
        assert _transcript(_sse_events(raw)) == want, "spec-on splice diverged"
        assert _resumes("resumed") == r0 + 1
        assert drafted.total(generator="paged") > d0
    finally:
        fl.close()
        httpd.shutdown()
        httpd.server_close()
        state.close()
        state.engine.close()


def _slow(state, s=0.05):
    """Slow one replica's decode steps so a kill lands past a deadline."""
    gen = state.sched.gen
    step = gen.step

    def slow_step():
        time.sleep(s)
        return step()

    gen.step = slow_step


def test_resume_budget_exhausted_and_no_budget(files):
    """``--max-stream-resumes 0``: the first death is the terminal SSE 502
    event plus [DONE] (outcome ``exhausted``). With resumes allowed but the
    request deadline spent when the replica dies, the outcome is
    ``no_budget`` and the stream ends the same way — never a hang."""
    fl = _Fleet(files, 2, max_stream_resumes=0)
    try:
        e0 = _resumes("exhausted")
        raw, _ = _kill_mid_stream(fl, _body("dur-x"))
        events = _sse_events(raw)
        assert b'"upstream_error"' in raw and events[-1] == "[DONE]"
        assert _resumes("exhausted") == e0 + 1
    finally:
        fl.close()
    fl = _Fleet(files, 2, request_timeout_s=0.5)
    try:
        for st in fl.by_name.values():
            _slow(st)
        n0 = _resumes("no_budget")
        raw, _ = _kill_mid_stream(fl, _body("dur-y", n=120),
                                  before_kill=lambda: time.sleep(0.7))
        assert b'"upstream_error"' in raw and _sse_events(raw)[-1] == "[DONE]"
        assert _resumes("no_budget") == n0 + 1
    finally:
        fl.close()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_resume_body_admission_on_the_replica(files, paged):
    """A resume body straight to one replica: its continuation is the
    unbroken run's tail, stamped from ``resume_from`` on, with no prompt
    echo; ``max_tokens`` counts the delivered history. Malformed resume
    bodies, and history ids past the vocabulary, are 400s."""
    import json
    import urllib.error

    state = _state(files, paged=paged)
    httpd, port = _serve(state)
    url = f"http://127.0.0.1:{port}"
    try:
        for body in (_body("direct-g", n=40), _body("direct-s", n=40, temperature=0.9, seed=5)):
            n, toks, _, finish = _oracle_run(url, body)
            assert n == 40 and finish == "length"
            for k in (1, 17):
                resumed = dict(body, resume_from=k, resume_tokens=toks[:k])
                with _open_stream(url, resumed) as r:
                    events = _sse_events(r.read())
                stamps = [e["dllama"] for e in events if e != "[DONE]" and "dllama" in e]
                assert stamps and all(s["index"] > k for s in stamps)  # no echo, no replay
                got = [t for s in stamps for t in s["tokens"]]
                assert got == toks[k:], (body["session_id"], k)
        ok = _body("bad", n=4)
        for extra in ({"resume_from": 2}, {"resume_from": 2, "resume_tokens": [5]},
                      {"resume_from": 0, "resume_tokens": []},
                      {"resume_from": True, "resume_tokens": [5]},
                      {"resume_from": 1, "resume_tokens": [-1]},
                      {"resume_from": 1, "resume_tokens": [268]}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_json(url, dict(ok, stream=False, **extra))
            assert e.value.code == 400 and "resume" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.close()
        state.engine.close()
