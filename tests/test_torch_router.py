"""The port's fleet router (``dllama_tpu_torch/serve/router.py``).

1. Every behaviour of the JAX router's own tests (``tests/test_router.py``:
   probes, least-loaded dispatch, affinity, breaker, retry, shedding, drain,
   mid-stream resume with its budgets, fleet trace identity and the
   timeline join, the fleettrace CLI, the SLO and tenant surfaces) runs on
   the port's router against the same ``StubReplica``: the JAX test module's
   router, telemetry and failpoint names, and the modules its tests import
   inside their bodies (``flightrec``, ``tenancy``, the CLI's ``main``), are
   pointed at the port's for the length of each case.
2. A real port replica (the tiny CPU model) behind the port's router:
   completions equal direct access, and the fleet identity reaches the
   replica's flight dump, spans and timing block.
3. Interop across the packages, both ways: the JAX router in front of a port
   replica, and the port router in front of a JAX replica, each give the same
   choices and usage as direct access, with the tenant forwarded.
"""

from __future__ import annotations

import inspect
import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer, ThreadingHTTPServer

import numpy as np
import pytest

# bound before any case patches the JAX package's attributes, so these
# modules keep their own imports
import dllama_tpu.runtime as jruntime
import dllama_tpu.runtime.serving  # noqa: F401
import dllama_tpu.serve.api  # noqa: F401
import dllama_tpu.serve.cli as jcli
import dllama_tpu.serve.router as jrouter
import test_router as jr
from dllama_tpu.formats import tfile
from dllama_tpu.runtime import tenancy as jtenancy
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime import failpoints, flightrec, telemetry, tenancy
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.serve import cli, router
from dllama_tpu_torch.serve.api import ApiState, BatchedApiState, make_handler

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

# the one JAX case that builds a JAX engine replica; parts 2 and 3 cover it
_JAX_ENGINE_CASES = {"test_router_fronts_real_engine_replica"}
CASES = sorted(n for n, f in vars(jr).items()
               if n.startswith("test_") and inspect.isfunction(f)
               and n not in _JAX_ENGINE_CASES)


@pytest.fixture
def on_port(monkeypatch):
    for name, val in {"FleetRouter": router.FleetRouter,
                      "make_router_handler": router.make_router_handler,
                      "affinity_key": router.affinity_key,
                      "tm": telemetry, "fp": failpoints}.items():
        monkeypatch.setattr(jr, name, val)
    # `from dllama_tpu.runtime import flightrec` and `from dllama_tpu.serve.cli
    # import main` inside a case read these attributes
    monkeypatch.setattr(jruntime, "flightrec", flightrec)
    monkeypatch.setattr(jruntime, "tenancy", tenancy)
    monkeypatch.setattr(jcli, "main", cli.main)
    failpoints.registry().clear()
    yield
    failpoints.registry().clear()
    tenancy.reset()


def test_cases_cover_the_jax_router_suite():
    assert len(CASES) >= 34 and "test_midstream_death_splices_resume_exactly_once" in CASES
    # the port's router shares the JAX one's vocabulary
    for name in ("RESUME_OUTCOMES", "STATES", "EJECT_AFTER", "FLEET_RID_HEADER",
                 "TENANT_HEADER", "RESUME_FROM_HEADER", "_ROUTES"):
        assert getattr(router, name) == getattr(jrouter, name), name
    assert router.READY_CODES == dllama_tpu.serve.api.READY_CODES
    body = {"messages": [{"role": "user", "content": "x" * 300}]}
    for b in (body, {"session_id": "s1"}, {"user": "u"}, {}):
        assert router.affinity_key(b) == jrouter.affinity_key(b)


@pytest.mark.parametrize("case", CASES)
def test_jax_router_behaviour_on_port(case, on_port, tmp_path):
    fn = getattr(jr, case)
    fn(**({"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters
          else {}))


# -- real replicas -------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_router")
    mpath, tpath = d / "m.m", d / "t.t"
    # seq_len 256: room for the ~90-token templated prompt and its answer
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(9))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


def _serve(state, handler=make_handler, threading_server=True):
    cls = ThreadingHTTPServer if threading_server else HTTPServer
    httpd = cls(("127.0.0.1", 0), handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, headers=None):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(r.headers), r.read()


def _router(mod, urls):
    fleet = mod.FleetRouter(urls, probe_interval_s=0.05)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_router_handler(fleet))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    jr._wait(lambda: fleet.readiness()[0], what="replica probed up", timeout=60)

    def close():
        httpd.shutdown()
        httpd.server_close()
        fleet.close()

    return f"http://127.0.0.1:{httpd.server_address[1]}", fleet, close


def test_port_router_fronts_real_port_replica(files):
    """The port's JAX-router case 'fronts a real engine replica' on the
    port's single-sequence server: completions equal direct access, the SSE
    relay ends in [DONE], and a client-chosen fleet id reaches the replica's
    flight dump (a ``fleet_rid`` binding), its spans and its timing block."""
    m, t = files
    engine = InferenceEngine(m, t, device="cpu", temperature=0.0, seed=3)
    httpd, direct = _serve(ApiState(engine), threading_server=False)
    url, _, close = _router(router, [direct])
    try:
        body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6,
                "temperature": 0}
        want = json.loads(_post(direct, body)[1])
        got = json.loads(_post(url, body)[1])
        assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
        assert b"data: [DONE]" in _post(url, dict(body, stream=True))[1]
        hdrs, raw = _post(url, dict(body, timing=True),
                          {"X-Dllama-Request-Id": "e2e.trace-1"})
        assert hdrs["X-Dllama-Request-Id"] == "e2e.trace-1"
        timed = json.loads(raw)
        assert timed["timing"]["request_id"] == "e2e.trace-1" and timed["timing"]["hop"] == 0
        with urllib.request.urlopen(direct + "/debug/flight", timeout=30) as r:
            flight = json.loads(r.read())
        binds = [e for e in flight["events"]
                 if e.get("event") == "fleet_rid" and e.get("reason") == "e2e.trace-1"]
        assert len(binds) == 1 and binds[0]["hop"] == 0
        spans = [s for s in flight["spans"] if s.get("fleet") == "e2e.trace-1"]
        assert spans and all(s["hop"] == 0 for s in spans)
        # a resume body is refused by the single-sequence server (400)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(direct, dict(body, resume_from=1, resume_tokens=[5]))
        assert e.value.code == 400 and b"batched serving" in e.value.read()
    finally:
        close()
        httpd.shutdown()
        httpd.server_close()
        engine.close()


@pytest.mark.parametrize("way", ["jax_router_port_replica", "port_router_jax_replica"])
def test_cross_package_interop(files, way):
    """Each package's router in front of the other package's batched
    replica: greedy and sampled completions, JSON and SSE, equal direct
    access (choices, usage, streamed text); the replica attributes the
    routed requests to the caller's tenant, with the same token totals as
    the direct requests."""
    m, t = files
    # fresh registries first: a scheduler keeps the registry it was built with
    tenancy.reset()
    jtenancy.reset()
    if way == "jax_router_port_replica":
        eng = InferenceEngine(m, t, device="cpu", kv_block_size=16, temperature=0.0)
        state, handler = BatchedApiState(eng, n_slots=2), make_handler
        rmod, ten = jrouter, tenancy
    else:
        eng = JaxEngine(m, t, tp=1, kv_block_size=16, temperature=0.0)
        state = dllama_tpu.serve.api.BatchedApiState(eng, n_slots=2)
        handler, rmod, ten = dllama_tpu.serve.api.make_handler, router, jtenancy
    httpd, direct = _serve(state, handler)
    url, _, close = _router(rmod, [direct])
    try:
        for i, body in enumerate([
                {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 7,
                 "temperature": 0},
                {"messages": [{"role": "user", "content": "sampled words"}], "max_tokens": 7,
                 "temperature": 0.9, "seed": 5}]):
            want = json.loads(_post(direct, body, {"X-Dllama-Tenant": "direct"})[1])
            hdrs, raw = _post(url, body, {"X-Dllama-Tenant": "routed"})
            got = json.loads(raw)
            assert hdrs["X-Dllama-Tenant"] == "routed"
            assert got["choices"] == want["choices"] and got["usage"] == want["usage"], i
            # SSE: the stamped stream relays intact, text equal to direct
            _, sraw = _post(url, dict(body, stream=True), {"X-Dllama-Tenant": "routed"})
            events = jr._sse_events(sraw)
            assert events[-1] == "[DONE]"
            text = "".join((e["choices"][0].get("delta") or {}).get("content") or ""
                           for e in events if e != "[DONE]" and "choices" in e)
            assert all("dllama" in e for e in events[:-2] if e != "[DONE]")
            assert text.endswith(want["choices"][0]["message"]["content"])
        with urllib.request.urlopen(direct + "/debug/tenants", timeout=30) as r:
            snap = json.loads(r.read())["tenants"]
        assert snap["routed"]["admissions"] == 2 * snap["direct"]["admissions"] == 4
        assert snap["routed"]["decode_tokens"] == 2 * snap["direct"]["decode_tokens"]
    finally:
        close()
        httpd.shutdown()
        httpd.server_close()
        state.close()
        eng.close()
        ten.reset()
