"""The port's KV migration (``runtime/kvwire.py`` + ``PagedGenerator``'s
``export_prefix``/``ingest_prefix`` + the scheduler's park-and-fetch + ``POST
/v1/kv/export`` + the ``X-Dllama-KV-Peer`` hint + ``--role`` behind the
router), porting ``tests/test_kvmigrate.py``'s engine-level and chaos cases
onto port replicas (the tiny model, vocab 268, seq_len 256, block 16):

* a migrated prefix decodes token-exact to the never-migrated run, with the
  migration on the counters and the ``kvmigrate`` TTFT phase;
* ``/v1/kv/export`` answers 404 for a prefix not resident and 400 for a
  malformed body;
* every wire failure — a dead peer, a source killed mid-transfer, an
  injected short read, a stalled stream, an exhausted destination — falls
  back to recompute with its reason counted, token-exact, no user error;
* the disaggregated path: the port router warms the ``prefill`` replica,
  the decode replica pulls the prefix and serves the completion;
* interop both ways: a JAX source into a port destination and a port source
  into a JAX destination, each token-exact to the never-migrated run (the
  two packages' frames are the same bytes);
* ``--role`` and ``--kv-host-blocks`` on the CLI, ``/readyz``'s ``role``
  and ``kv_prefixes``."""

from __future__ import annotations

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.serve.api import BatchedApiState as JaxBatchedApiState
from dllama_tpu.serve.api import make_handler as jax_make_handler
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import kvwire
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvblocks import BlockPoolExhausted
from dllama_tpu_torch.serve import cli
from dllama_tpu_torch.serve.api import BatchedApiState, make_handler
from dllama_tpu_torch.tokenizer.chat import ChatItem

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_kvmigrate import _StubPeer

BLOCK = 16
PATHS: dict[str, str] = {}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.registry().clear()
    yield
    fp.registry().clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_kvmigrate")
    mpath, tpath = d / "m.m", d / "t.t"
    # seq_len 256: the llama3 chat template alone is ~90 byte tokens, and the
    # migrations want several full 16-row blocks of prompt KV
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(41))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(tpath, td)
    PATHS["m"], PATHS["t"] = str(mpath), str(tpath)
    return PATHS


def _paged_state(files, n_slots=2, role=None):
    engine = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                             temperature=0.0, seed=3)
    return BatchedApiState(engine, n_slots=n_slots, role=role)


def _jax_state(files, role=None):
    engine = JaxEngine(files["m"], files["t"], tp=1, kv_block_size=BLOCK,
                       temperature=0.0, seed=3)
    return JaxBatchedApiState(engine, n_slots=2, role=role)


def _close(state):
    state.close()
    state.engine.close()


def _serve(state, handler=make_handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload, path="/v1/chat/completions", timeout=120):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _body(prompt, n=8, **extra):
    return {"messages": [{"role": "user", "content": prompt}], "max_tokens": n,
            "temperature": 0, **extra}


def _session_text(tag):
    return tag + "".join(chr(97 + j % 26) for j in range(40))


def _text(out):
    return out["choices"][0]["message"]["content"]


@pytest.fixture(scope="module")
def src_server(files):
    """The migration SOURCE (a paged port replica) and the never-migrated
    oracle: batched output equals solo output (tests/test_torch_serving.py)."""
    state = _paged_state(files)
    httpd, port = _serve(state)
    yield f"http://127.0.0.1:{port}", state, port
    _stop(httpd)
    _close(state)


@pytest.fixture(scope="module")
def dst_state(files):
    """The migration DESTINATION, driven through ``BatchedApiState.complete(...,
    kv_peer=...)`` — what the handler does with the X-Dllama-KV-Peer header."""
    state = _paged_state(files)
    yield state
    _close(state)


def _mig_totals(reg=tm):
    r = reg.registry()
    return {"migrated": r.counter(reg.KVWIRE_MIGRATIONS).total(outcome="migrated"),
            "fallback": r.counter(reg.KVWIRE_MIGRATIONS).total(outcome="fallback"),
            **{x: r.counter(reg.KVWIRE_FALLBACK).total(reason=x)
               for x in ("timeout", "crc", "peer_death", "exhaustion")}}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def test_migrated_decode_token_exact(src_server, dst_state):
    """Warm the source, migrate the prefix over the wire, and the
    destination's completion equals the never-migrated source run; the
    ingested blocks equal the exported planes cast to the pool (f32)."""
    url, src, port = src_server
    body = _body(_session_text("mig-exact-"), n=8)
    baseline = _post(url, body)
    t0 = _mig_totals()
    rx0 = tm.registry().counter(tm.KVWIRE_RX_BYTES).total()
    out = dst_state.complete(dict(body, timing=True), kv_peer=f"127.0.0.1:{port}")
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert out["finish_reason"] == baseline["choices"][0]["finish_reason"]
    assert d["migrated"] == 1 and d["fallback"] == 0
    assert tm.registry().counter(tm.KVWIRE_RX_BYTES).total() > rx0
    assert out["timing"]["kvmigrate_ms"] > 0
    # the bytes: the export decoded by the port's reader, against the
    # destination's blocks at the ids its match returns
    prompt = dst_state.template.generate([ChatItem("user", body["messages"][0]["content"])],
                                         append_generation_prompt=True)
    ids = dst_state.engine.tokenizer.encode(prompt.content, is_start=True,
                                            add_special_tokens=True)
    req = urllib.request.Request(url + "/v1/kv/export",
                                 data=json.dumps({"tokens": ids[:-1]}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        hdr, blocks = kvwire.read_stream(r, dst_state.sched.gen.wire_geometry())
    gen = dst_state.sched.gen
    shared = gen.pool.match_prefix(ids[:-1])[0]
    assert len(shared) >= hdr["n_blocks"] >= 2
    for (_, k, v), b in zip(blocks, shared):
        assert np.array_equal(gen.pkv.k[:, b].numpy(), k)
        assert np.array_equal(gen.pkv.v[:, b].numpy(), v)


def test_peer_refuses_when_prefix_not_resident(src_server):
    url, _, _ = src_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"tokens": [9, 9, 9, 9]}, path="/v1/kv/export", timeout=30)
    assert e.value.code == 404
    assert "not resident" in json.loads(e.value.read())["error"]
    req = urllib.request.Request(url + "/v1/kv/export", data=b'{"tokens": "nope"}',
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_chaos_dead_peer_falls_back_to_recompute(src_server, dst_state):
    url, _, _ = src_server
    body = _body(_session_text("mig-dead-"), n=8)
    baseline = _post(url, body)
    t0 = _mig_totals()
    out = dst_state.complete(body, kv_peer="127.0.0.1:9")
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["migrated"] == 0 and d["peer_death"] == 1


def test_chaos_source_killed_mid_transfer(src_server, dst_state):
    """The peer dies mid-stream at every attempt: the destination recomputes
    and completes token-exact."""
    url, _, _ = src_server
    geom = dst_state.sched.gen.wire_geometry()
    shape = (geom["n_layers"], geom["n_kv_heads"], geom["block_size"], geom["head_dim"])
    rng = np.random.default_rng(5)
    blocks = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
    buf = io.BytesIO()
    kvwire.write_stream(buf, dict(geom, n_blocks=2, n_tokens=2 * BLOCK), blocks)
    data = buf.getvalue()
    stub = _StubPeer([("truncate", data, int(len(data) * 0.6))] * 3)
    body = _body(_session_text("mig-kill-"), n=8)
    baseline = _post(url, body)
    t0 = _mig_totals()
    try:
        out = dst_state.complete(body, kv_peer=stub.peer)
    finally:
        stub.close()
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["peer_death"] == 1


def test_chaos_short_read_injection_is_crc_fallback(src_server, dst_state):
    url, _, port = src_server
    body = _body(_session_text("mig-crc-"), n=8)
    baseline = _post(url, body)
    fired0 = fp.registry().fired("kvwire")
    fp.arm("kvwire", "short_read", times=1)
    t0 = _mig_totals()
    out = dst_state.complete(body, kv_peer=f"127.0.0.1:{port}")
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["crc"] == 1 and d["migrated"] == 0
    assert fp.registry().fired("kvwire") == fired0 + 1


def test_chaos_raise_mid_stream_is_peer_death(src_server, dst_state):
    url, _, port = src_server
    body = _body(_session_text("mig-raise-"), n=8)
    baseline = _post(url, body)
    fp.arm("kvwire", "raise", times=3)  # every attempt dies on its first frame
    t0 = _mig_totals()
    out = dst_state.complete(body, kv_peer=f"127.0.0.1:{port}")
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["peer_death"] == 1


def test_chaos_stalled_stream_is_timeout_fallback(src_server, dst_state, monkeypatch):
    url, _, port = src_server
    body = _body(_session_text("mig-slow-"), n=8)
    baseline = _post(url, body)
    monkeypatch.setattr(kvwire, "DEFAULT_DEADLINE_S", 0.3)
    fp.registry().arm("kvwire", "sleep", times=1, delay_s=0.8)
    t0 = _mig_totals()
    out = dst_state.complete(body, kv_peer=f"127.0.0.1:{port}")
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["timeout"] == 1


def test_chaos_destination_pool_exhausted(src_server, dst_state):
    """The wire delivered but the destination cannot stage: the partial
    blocks are released (no leak), reason ``exhaustion``, recompute."""
    url, _, port = src_server
    body = _body(_session_text("mig-full-"), n=8)
    baseline = _post(url, body)
    pool = dst_state.sched.gen.pool
    orig_alloc = pool.alloc
    armed = {"on": True}

    def failing_alloc(*a, **kw):
        if armed["on"]:
            armed["on"] = False
            raise BlockPoolExhausted("injected: no blocks for staging")
        return orig_alloc(*a, **kw)

    pool.alloc = failing_alloc
    free0 = pool.free_blocks()
    t0 = _mig_totals()
    try:
        out = dst_state.complete(body, kv_peer=f"127.0.0.1:{port}")
    finally:
        pool.alloc = orig_alloc
    d = _delta(_mig_totals(), t0)
    assert out["text"] == _text(baseline)
    assert d["fallback"] == 1 and d["exhaustion"] == 1
    assert not armed["on"]
    assert pool.used_blocks() == 0 and pool.free_blocks() == free0


def test_disaggregated_decode_through_router(files):
    """Router → prefill warm-up on the ``prefill`` replica → KV export →
    the decode replica imports and streams the completion, equal to a
    never-migrated run; the prefill replica is never dispatched to."""
    from dllama_tpu_torch.serve.router import FleetRouter, make_router_handler

    p_state = _paged_state(files, role="prefill")
    d_state = _paged_state(files)
    p_httpd, p_port = _serve(p_state)
    d_httpd, d_port = _serve(d_state)
    fleet = FleetRouter([f"127.0.0.1:{p_port}", f"127.0.0.1:{d_port}"],
                        probe_interval_s=0.05)
    r_httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_router_handler(fleet))
    r_port = r_httpd.server_address[1]
    threading.Thread(target=r_httpd.serve_forever, daemon=True).start()
    try:
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if (all(r.state == "up" for r in fleet.replicas)
                    and any(r.is_prefill() for r in fleet.replicas)):
                break
            time.sleep(0.02)
        assert all(r.state == "up" for r in fleet.replicas)
        assert any(r.is_prefill() for r in fleet.replicas)
        body = _body(_session_text("disagg-"), n=8, session_id="disagg-e2e", timing=True)
        t0 = _mig_totals()
        out = _post(f"http://127.0.0.1:{r_port}", body)
        d = _delta(_mig_totals(), t0)
        assert d["migrated"] == 1 and d["fallback"] == 0
        assert out["timing"]["kvmigrate_ms"] > 0
        reg = tm.registry()
        assert reg.counter(tm.ROUTER_DISPATCHES).total(replica=f"127.0.0.1:{d_port}") >= 1
        assert reg.counter(tm.ROUTER_DISPATCHES).total(replica=f"127.0.0.1:{p_port}") == 0
        assert {"rt_prefill", "rt_kv_donor"} <= {s["phase"] for s in fleet.spans.raw_spans()}
        oracle = _post(f"http://127.0.0.1:{p_port}",
                       _body(_session_text("disagg-"), n=8, session_id="disagg-e2e"))
        assert _text(out) == _text(oracle)
        with urllib.request.urlopen(f"http://127.0.0.1:{p_port}/readyz", timeout=30) as r:
            rz = json.loads(r.read())
        assert rz["role"] == "prefill" and rz["kv_prefixes"]
    finally:
        _stop(r_httpd)
        fleet.close()
        for h in (p_httpd, d_httpd):
            _stop(h)
        _close(p_state)
        _close(d_state)


def test_interop_jax_source_into_port_destination(files, dst_state):
    """A JAX replica's export feeds a port destination: token-exact to the
    never-migrated run."""
    src = _jax_state(files)
    httpd, port = _serve(src, jax_make_handler)
    try:
        body = _body(_session_text("jax-to-port-"), n=8)
        baseline = _post(f"http://127.0.0.1:{port}", body)
        t0 = _mig_totals()
        out = dst_state.complete(body, kv_peer=f"127.0.0.1:{port}")
        d = _delta(_mig_totals(), t0)
        assert d["migrated"] == 1 and d["fallback"] == 0
        assert out["text"] == _text(baseline)
    finally:
        _stop(httpd)
        _close(src)


def test_interop_port_source_into_jax_destination(files, src_server):
    """A port replica's export feeds a JAX destination: token-exact."""
    url, _, port = src_server
    dst = _jax_state(files)
    try:
        body = _body(_session_text("port-to-jax-"), n=8)
        baseline = _post(url, body)
        t0 = _mig_totals(jtm)
        out = dst.complete(body, kv_peer=f"127.0.0.1:{port}")
        d = _delta(_mig_totals(jtm), t0)
        assert d["migrated"] == 1 and d["fallback"] == 0
        assert out["text"] == _text(baseline)
    finally:
        _close(dst)


def test_readyz_advertises_role_and_prefixes(files):
    state = _paged_state(files, role="decode")
    httpd, port = _serve(state)
    try:
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/readyz", timeout=30) as r:
            rz = json.loads(r.read())
        assert rz["role"] == "decode" and rz["kv_prefixes"] == []
        _post(url, _body("advertise me", n=2))
        with urllib.request.urlopen(url + "/readyz", timeout=30) as r:
            assert len(json.loads(r.read())["kv_prefixes"]) == 1
        # the state's advertisement is bounded and expires
        for i in range(state.KV_PREFIX_MAX + 5):
            state.note_kv_prefix(f"k{i}")
        assert len(state.kv_prefix_list()) == state.KV_PREFIX_MAX
        assert state.kv_prefix_list()[0] == f"k{state.KV_PREFIX_MAX + 4}"
        state.drop_kv_prefix(f"k{state.KV_PREFIX_MAX + 4}")
        assert f"k{state.KV_PREFIX_MAX + 4}" not in state.kv_prefix_list()
    finally:
        _stop(httpd)
        _close(state)


def test_kv_peer_header_sanitized():
    from dllama_tpu.serve.api import kv_peer as jax_kv_peer
    from dllama_tpu_torch.serve.api import KV_PEER_HEADER, kv_peer

    assert KV_PEER_HEADER == "X-Dllama-KV-Peer"
    for v in ("127.0.0.1:8080", "host.example:1", "[::1]:9", "bad", "a b:1", "x" * 300 + ":1",
              "127.0.0.1:123456", None):
        h = {} if v is None else {KV_PEER_HEADER: v}
        assert kv_peer(h) == jax_kv_peer(h), v


@pytest.mark.parametrize("argv", [
    ["api", "--role", "prefill"],
    ["api", "--role", "decode", "--batch-slots", "4"],
    ["api", "--role", "prefill", "--kv-block-size", "16"],
    ["api", "--role", "decode", "--batch-slots", "1", "--kv-block-size", "16"]])
def test_role_refused_without_batched_paged_serving(argv):
    with pytest.raises(SystemExit, match="--role tags a disaggregated replica"):
        cli.main([*argv, "--model", "m.m", "--tokenizer", "t.t", "--device", "cpu"])


def test_cli_serves_role_and_host_tier(files):
    """``api --batch-slots 2 --kv-block-size 16 --kv-host-blocks 8 --role
    prefill`` starts with the tier and the tag; ``--kv-host-blocks``
    without ``--kv-block-size`` is refused by the engine."""
    box: dict = {}
    ready = threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        ready.set()

    argv = ["api", "--model", files["m"], "--tokenizer", files["t"], "--device", "cpu",
            "--batch-slots", "2", "--kv-block-size", "16", "--kv-host-blocks", "8",
            "--role", "prefill", "--port", "0"]
    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        argv, on_listening=on_listening)), daemon=True)
    th.start()
    assert ready.wait(120)
    try:
        state = box["state"]
        assert state.role == "prefill"
        gen = state.sched.gen
        assert gen.pool.n_host_blocks == 8 and gen.mirror is not None
        url = f"http://127.0.0.1:{box['server'].server_address[1]}"
        with urllib.request.urlopen(url + "/readyz", timeout=30) as r:
            assert json.loads(r.read())["role"] == "prefill"
    finally:
        box["server"].shutdown()
        th.join(60)
    assert box.get("rc") == 0
    with pytest.raises(ValueError, match="--kv-host-blocks"):
        cli.main(["api", "--model", files["m"], "--tokenizer", files["t"], "--device",
                  "cpu", "--batch-slots", "2", "--kv-host-blocks", "8", "--port", "0"])
