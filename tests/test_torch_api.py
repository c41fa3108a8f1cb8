"""The port's OpenAI-style server (``python -m dllama_tpu_torch api
--batch-slots N --kv-block-size B``) on the CPU, started in process through
the CLI's ``main`` on port 0: ``/v1/models``, the health routes, JSON and
SSE completions, stop strings, the malformed-body list of
``tests/test_api.py`` (400, never 500), 404, deterministic concurrent
requests, and the completion text against the JAX package's
``BatchedApiState.complete`` on the same tiny model at temperature 0
(exact string equality: both decode the same greedy tokens)."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

MSGS = [{"role": "user", "content": "hello"}]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_api")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(9))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


@pytest.fixture(scope="module")
def server(files):
    m, t = files
    started = threading.Event()
    box = {}

    def on_listening(srv, state):
        box["server"], box["state"] = srv, state
        started.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu",
         "--batch-slots", "2", "--kv-block-size", "16", "--port", "0",
         "--temperature", "0", "--seed", "3"], on_listening=on_listening)),
        daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    port = box["server"].server_address[1]
    yield f"http://127.0.0.1:{port}", box["state"]
    box["server"].shutdown()
    th.join(timeout=60)
    assert not th.is_alive() and box["rc"] == 0


def _post(url, payload, path="/v1/chat/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _text(url, body) -> str:
    with _post(url, body) as r:
        return json.loads(r.read())["choices"][0]["message"]["content"]


def test_models_and_health_routes(server):
    url, _ = server
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        data = json.loads(r.read())
    assert data["object"] == "list" and data["data"][0]["id"] == "dllama-tpu"
    for path in ("/health", "/healthz", "/readyz"):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            body = json.loads(r.read())
            assert r.status == 200 and body["status"] == "ok"
    with urllib.request.urlopen(url + "/readyz", timeout=30) as r:
        assert json.loads(r.read())["code"] == "ok"


def test_completion_matches_jax_batched_state(server, files):
    """The port's completion text equals the JAX package's batched API
    state on the same files and body (greedy)."""
    from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
    from dllama_tpu.serve.api import BatchedApiState

    url, _ = server
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hello there"}],
            "max_tokens": 10, "temperature": 0}
    with _post(url, dict(body)) as r:
        data = json.loads(r.read())
    assert data["object"] == "chat.completion"
    usage = data["usage"]
    assert usage["completion_tokens"] == 10
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
    jeng = JaxEngine(*files, temperature=0.0, seed=3)
    jstate = BatchedApiState(jeng, n_slots=2)
    try:
        want = jstate.complete(dict(body))
    finally:
        jstate.close()
        jeng.close()
    assert data["choices"][0]["message"]["content"] == want["text"]
    assert data["choices"][0]["finish_reason"] == want["finish_reason"]
    assert usage["prompt_tokens"] == want["prompt_tokens"]


def test_sse_stream_equals_json_text(server):
    url, _ = server
    body = {"messages": MSGS, "max_tokens": 8, "temperature": 0}
    full = _text(url, body)
    with _post(url, {**body, "stream": True}) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        raw = r.read().decode()
    events = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert all(p["object"] == "chat.completion.chunk" for p in parsed)
    assert parsed[-1]["choices"][0]["finish_reason"] == "length"
    assert "".join(p["choices"][0]["delta"].get("content", "") for p in parsed) == full


def test_request_stop_strings(server):
    url, _ = server
    base = {"messages": MSGS, "max_tokens": 12, "temperature": 0}
    full = _text(url, base)
    assert len(full) >= 4, full
    stop = full[2:4]
    with _post(url, {**base, "stop": stop}) as r:
        choice = json.loads(r.read())["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["message"]["content"] == full[:full.index(stop)]


def test_malformed_bodies_return_400_never_500(server):
    url, _ = server
    ok = [{"role": "user", "content": "hi"}]
    bad_bodies = [
        {"max_tokens": 3}, {"messages": "not a list", "max_tokens": 3},
        {"messages": [], "max_tokens": 3}, {"messages": ["loose string"]},
        {"messages": [{"role": 5, "content": "hi"}]},
        {"messages": [{"role": "user", "content": 7}]},
        {"messages": ok, "max_tokens": -4}, {"messages": ok, "max_tokens": 2.5},
        {"messages": ok, "max_tokens": True}, {"messages": ok, "temperature": "hot"},
        {"messages": ok, "temperature": -1}, {"messages": ok, "top_p": 40},
        {"messages": ok, "seed": "lucky"}, {"messages": ok, "timeout": "soon"},
        {"messages": ok, "timeout": -3}, {"messages": ok, "timeout": 1e9},
        {"messages": ok, "stop": 42}, {"messages": ok, "stop": [42]},
        {"messages": ok, "stop": ["x", None]}, [1, 2, 3],
    ]
    for body in bad_bodies:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body)
        assert e.value.code == 400, body
        assert "error" in json.loads(e.value.read()), body
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"messages": ok, "max_tokens": -1, "stream": True})
    assert e.value.code == 400
    req = urllib.request.Request(url + "/v1/chat/completions", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    # explicit JSON null means "absent", never a 500
    with _post(url, {"messages": ok, "max_tokens": 3, "temperature": None,
                     "top_p": None, "seed": None, "timeout": None, "stop": None}) as r:
        assert json.loads(r.read())["usage"]["completion_tokens"] >= 1


def test_unknown_routes_404(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404 and "routes" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"messages": MSGS}, path="/v1/completions")
    assert e.value.code == 404


def test_concurrent_requests_are_deterministic(server):
    """Six concurrent requests (greedy and seeded sampled) through two slots
    return what each returns alone: a request's output does not depend on
    what shares the batch."""
    url, state = server
    bodies = [{"messages": [{"role": "user", "content": f"tell me {i}"}],
               "max_tokens": 6, "temperature": 0.0 if i % 2 else 0.9, "seed": 10 + i}
              for i in range(6)]
    alone = [_text(url, b) for b in bodies]
    with ThreadPoolExecutor(max_workers=6) as ex:
        together = list(ex.map(lambda b: _text(url, b), bodies))
    assert together == alone
    assert state.sched.gen.reused_tokens > 0  # the shared template prefix


@pytest.mark.parametrize("argv,err", [
    (["--batch-slots", "2", "--sp", "2"], "--sp"),
    (["--kv-block-size", "16"], "--batch-slots"),
])
def test_unported_api_shapes_fail_loudly(files, argv, err):
    m, t = files
    with pytest.raises(SystemExit, match=err):
        cli.main(["api", "--model", m, "--tokenizer", t, "--device", "cpu", *argv])


def test_block_size_validation(files):
    m, t = files
    with pytest.raises(ValueError, match="power of two"):
        cli.main(["api", "--model", m, "--tokenizer", t, "--device", "cpu",
                  "--batch-slots", "2", "--kv-block-size", "24"])
