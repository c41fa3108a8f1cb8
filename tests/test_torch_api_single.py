"""The port's single-sequence API server (``python -m dllama_tpu_torch api``
without ``--batch-slots``: ``ApiState`` with its ``NaiveCache`` on a plain
``HTTPServer``) on the CPU, started in process through the CLI's ``main``
on port 0 and held against the JAX package's ``ApiState.complete`` on the
same files (``tp=1``, temperature 0): completion text, the message-prefix
cache (a body that extends the last conversation prefills only its new
messages, as the JAX state does), request ``stop`` strings and the no-push
rule after a custom stop, SSE against JSON, the in-line deadline, 400 on
malformed bodies, and ``--spec-lookup`` against spec-off. Texts compare
exactly: both packages decode the same greedy tokens."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.serve.api import ApiState as JaxApiState
from dllama_tpu_torch.serve import cli
from dllama_tpu_torch.serve.api import ApiState

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

SYSTEM = {"role": "system", "content": "be brief"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_api_single")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(9))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


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
    return box, th


def _stop(box, th):
    box["server"].shutdown()
    th.join(timeout=60)
    assert not th.is_alive() and box["rc"] == 0


@pytest.fixture(scope="module")
def server(files):
    box, th = _serve(files)
    port = box["server"].server_address[1]
    yield f"http://127.0.0.1:{port}", box["state"]
    _stop(box, th)


@pytest.fixture()
def jax_state(files):
    """A fresh JAX single-sequence state (empty cache) per test."""
    eng = JaxEngine(*files, temperature=0.0, seed=3, tp=1)
    yield JaxApiState(eng)
    eng.close()


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/chat/completions",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _complete(url, body) -> dict:
    with _post(url, body) as r:
        data = json.loads(r.read())
    return {"text": data["choices"][0]["message"]["content"],
            "finish_reason": data["choices"][0]["finish_reason"],
            "prompt_tokens": data["usage"]["prompt_tokens"],
            "completion_tokens": data["usage"]["completion_tokens"]}


def _prefilled(state: ApiState) -> list[int]:
    """Record the token count of every prefill the state's engine runs."""
    seen: list[int] = []
    inner = state.engine.prefill

    def prefill(ids):
        seen.append(len(ids))
        return inner(ids)

    state.engine.prefill = prefill
    return seen


def test_server_is_single_sequence(server):
    url, state = server
    assert isinstance(state, ApiState)
    with urllib.request.urlopen(url + "/readyz", timeout=30) as r:
        assert json.loads(r.read())["code"] == "ok"


def test_greedy_completion_matches_jax(server, jax_state):
    url, _ = server
    body = {"messages": [SYSTEM, {"role": "user", "content": "hello there"}],
            "max_tokens": 10, "temperature": 0}
    got = _complete(url, dict(body))
    want = jax_state.complete(dict(body))
    assert got == {k: want[k] for k in got}
    assert got["completion_tokens"] == 10


def test_naive_cache_reuse_matches_jax_and_prefills_less(server, jax_state):
    """Three turns, each body the last one plus the answer and a new user
    message: from the second turn on both states resume at the cached end
    and prefill only the new messages; every answer equals the JAX state's
    on the same bodies, and a cold state (empty cache) given the last body
    answers as a cold JAX state does."""
    url, state = server
    seen = _prefilled(state)
    convo = [SYSTEM, {"role": "user", "content": "hi"}]
    full_lens = []
    for turn in ("tell me more", "and then?", None):
        body = {"messages": list(convo), "max_tokens": 6, "temperature": 0}
        got = _complete(url, dict(body))
        want = jax_state.complete(dict(body))
        assert got["text"] == want["text"] and got["prompt_tokens"] == want["prompt_tokens"]
        full_lens.append(got["prompt_tokens"])
        if turn is None:
            break
        convo += [{"role": "assistant", "content": got["text"]},
                  {"role": "user", "content": turn}]
    # turn 1 prefills its whole prompt; turns 2-3 only their new messages
    assert seen[0] == full_lens[0] - 1
    assert all(0 < n < seen[0] for n in seen[1:])
    assert len(state.cache.items) == len(jax_state.cache.items) == len(convo) + 1
    del state.engine.prefill  # the recording wrapper
    cold = ApiState(state.engine)
    body = {"messages": convo, "max_tokens": 6, "temperature": 0}
    jcold = JaxApiState(jax_state.engine)
    assert cold.complete(dict(body))["text"] == jcold.complete(dict(body))["text"]


def test_stop_strings_and_no_push_after_custom_stop(server, jax_state):
    url, state = server
    base = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 12,
            "temperature": 0}
    full = _complete(url, dict(base))["text"]
    assert len(full) >= 4, full
    stop = full[2:4]
    got = _complete(url, {**base, "stop": stop})
    assert got["finish_reason"] == "stop"
    assert got["text"] == full[:full.index(stop)]
    # the custom-stop finish leaves no assistant entry in the cache
    assert [it.role for it in state.cache.items] == ["user"]
    want = jax_state.complete({**base, "stop": stop})
    assert want["text"] == got["text"]
    assert [it.role for it in jax_state.cache.items] == ["user"]


def test_sse_stream_equals_json_text(server):
    url, _ = server
    body = {"messages": [{"role": "user", "content": "stream it"}], "max_tokens": 8,
            "temperature": 0}
    full = _complete(url, body)["text"]
    with _post(url, {**body, "stream": True}) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        raw = r.read().decode()
    events = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert parsed[-1]["choices"][0]["finish_reason"] == "length"
    assert "".join(p["choices"][0]["delta"].get("content", "") for p in parsed) == full


def test_deadline_stops_the_decode_loop(server):
    """The body ``timeout`` is checked between decode dispatches: with each
    token slowed to 20 ms a 0.1 s deadline ends the completion early with
    ``finish_reason: timeout``; a deadline that passes before the first
    token answers 408."""
    url, state = server
    eng = state.engine
    inner = eng.next_token

    def slow(token):
        time.sleep(0.02)
        return inner(token)

    eng.next_token = slow
    try:
        got = _complete(url, {"messages": [{"role": "user", "content": "slow"}],
                              "max_tokens": 60, "timeout": 0.1})
        assert got["finish_reason"] == "timeout" and 0 < got["completion_tokens"] < 60
        inner_prefill = eng.prefill

        def slow_prefill(ids):
            time.sleep(0.2)
            return inner_prefill(ids)

        eng.prefill = slow_prefill
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"messages": [{"role": "user", "content": "slower"}],
                        "max_tokens": 20, "timeout": 0.05})
        assert e.value.code == 408
    finally:
        del eng.next_token  # the slowed wrappers
        eng.__dict__.pop("prefill", None)


def test_malformed_bodies_return_400(server):
    url, _ = server
    ok = [{"role": "user", "content": "hi"}]
    for body in [{"max_tokens": 3}, {"messages": []}, {"messages": ["loose"]},
                 {"messages": ok, "max_tokens": -4}, {"messages": ok, "temperature": "hot"},
                 {"messages": ok, "top_p": 40}, {"messages": ok, "timeout": -3},
                 {"messages": ok, "stop": [42]}, {"messages": ok, "resume_from": 2},
                 [1, 2, 3]]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body)
        assert e.value.code == 400, body
        assert "error" in json.loads(e.value.read()), body


def test_spec_lookup_text_equals_spec_off(server, files):
    """``api --spec-lookup 4``: the same greedy text as the server without
    spec, on a repetitive prompt (its n-grams feed the drafts)."""
    url, _ = server
    body = {"messages": [{"role": "user", "content": "abc abc abc abc abc abc"}],
            "max_tokens": 24, "temperature": 0}
    want = _complete(url, dict(body))
    box, th = _serve(files, "--spec-lookup", "4")
    try:
        spec_url = f"http://127.0.0.1:{box['server'].server_address[1]}"
        got = _complete(spec_url, dict(body))
        assert box["state"].engine.spec_active
    finally:
        _stop(box, th)
    assert got == want
