"""The port's ``fleettrace`` mode and the fleet CLI surface.

``python -m dllama_tpu_torch fleettrace`` over dumps saved from a live port
fleet (the router's ``/debug/fleet`` and two replicas' ``/debug/flight``,
one request resumed across both) writes exactly the trace the JAX package's
``flightrec.fleet_chrome_trace`` makes of the same dumps, validated; it
exits 1 on malformed or unjoinable input. ``router`` and ``fleettrace`` are
ported modes now, and ``--role`` (KV migration) is refused with a message."""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import flightrec as jflightrec
from dllama_tpu_torch.runtime import flightrec
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.serve import cli
from dllama_tpu_torch.serve.api import BatchedApiState, make_handler
from dllama_tpu_torch.serve.router import FleetRouter, make_router_handler

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_router import _sse_events, _wait
from test_stream_resume import _body, _open_stream, _post_json, _read_until_stamped

REPO = Path(__file__).resolve().parent.parent


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A live port fleet (two paged replicas, one router): two routed
    completions, then a stream whose replica is killed mid-flight and
    resumed on the other; the router's and both replicas' debug bodies are
    saved as a fleettrace run would save them."""
    d = tmp_path_factory.mktemp("torch_fleettrace")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=256),
                     np.random.default_rng(23))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"
    tfile.write_tfile(tpath, td)
    flightrec.recorder().reset()
    states, httpds, urls = [], [], []
    for _ in range(2):
        eng = InferenceEngine(str(mpath), str(tpath), device="cpu", kv_block_size=16,
                              temperature=0.0)
        st = BatchedApiState(eng, n_slots=2)
        h = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(st))
        threading.Thread(target=h.serve_forever, daemon=True).start()
        states.append(st)
        httpds.append(h)
        urls.append(f"127.0.0.1:{h.server_address[1]}")
    fleet = FleetRouter(urls, probe_interval_s=0.05)
    rh = ThreadingHTTPServer(("127.0.0.1", 0), make_router_handler(fleet))
    threading.Thread(target=rh.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{rh.server_address[1]}"
    try:
        _wait(lambda: all(r.state == "up" for r in fleet.replicas), timeout=60,
              what="replicas up")
        for i in range(2):
            _post_json(url, dict(_body(f"warm-{i}", n=4), stream=False))
        body = _body("trace-kill")
        _post_json(url, dict(body, stream=False, max_tokens=4))
        with fleet._lock:
            victim = fleet._affinity["sid:trace-kill"].name
        resp = _open_stream(url, body)
        raw = _read_until_stamped(resp, 2)
        # the replicas share this process's flight recorder: save the victim's
        # dump at its death, the survivor's once the stream is done
        states[urls.index(victim)].close(drain_s=0.0)
        victim_dump = _get(f"http://{victim}/debug/flight")
        raw += resp.read()
        assert _sse_events(raw)[-1] == "[DONE]" and b"upstream_error" not in raw
        survivor = [u for u in urls if u != victim][0]
        files = {"router": d / "fleet.json", victim: d / "victim.json",
                 survivor: d / "survivor.json"}
        files["router"].write_bytes(_get(url + "/debug/fleet"))
        files[victim].write_bytes(victim_dump)
        files[survivor].write_bytes(_get(f"http://{survivor}/debug/flight"))
        yield d, files, victim, survivor
    finally:
        rh.shutdown()
        rh.server_close()
        fleet.close()
        for h in httpds:
            h.shutdown()
            h.server_close()
        for st in states:
            st.close()
            st.engine.close()


def test_fleettrace_equals_jax_join_of_the_same_dumps(dumps):
    d, files, victim, survivor = dumps
    out = d / "trace.json"
    args = ["fleettrace", "--router-dump", str(files["router"]), "--out", str(out),
            "--replica-dump", f"A={files[victim]}", "--replica-dump", f"B={files[survivor]}"]
    assert cli.main(args) == 0
    got = json.loads(out.read_text())
    load = lambda p: json.loads(Path(p).read_text())  # noqa: E731
    want = jflightrec.fleet_chrome_trace(load(files["router"]),
                                         {"A": load(files[victim]), "B": load(files[survivor])})
    assert got == want
    assert flightrec.validate_chrome_trace(got) == [] == jflightrec.validate_chrome_trace(want)
    assert got["fleetJoin"]["joined"] >= 3 and got["fleetJoin"]["replicas"] == 2
    # the resumed request's flow crosses both replica tracks
    resumed = [s["request_id"] for s in load(files["router"])["spans"]
               if s["phase"] == "rt_resume"]
    assert resumed
    pids = {e["pid"] for e in got["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "replica"
            and e["args"].get("request_id") == resumed[0]}
    assert len(pids) == 2


def test_fleettrace_bare_file_names_track_by_stem(dumps):
    d, files, victim, _ = dumps
    out = d / "stem.json"
    assert cli.main(["fleettrace", "--router-dump", str(files["router"]),
                     "--replica-dump", str(files[victim]), "--out", str(out)]) == 0
    names = {e["args"]["name"] for e in json.loads(out.read_text())["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert any("victim" in n for n in names)


def test_fleettrace_rejects_malformed_and_unjoinable(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli.main(["fleettrace", "--router-dump", str(bad)]) == 1
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps({"spans": [{"wrong": 1}]}))
    assert cli.main(["fleettrace", "--router-dump", str(broken)]) == 1
    listed = tmp_path / "list.json"
    listed.write_text("[1, 2]")
    assert cli.main(["fleettrace", "--router-dump", str(listed)]) == 1
    router_dump = tmp_path / "router.json"
    router_dump.write_text(json.dumps({"spans": [
        {"request_id": "r1-1", "phase": "rt_queue", "start_ns": 1000, "end_ns": 2000}]}))
    replica = tmp_path / "replica.json"
    replica.write_text(json.dumps({"ticks": [], "events": [], "spans": []}))
    assert cli.main(["fleettrace", "--router-dump", str(router_dump),
                     "--replica-dump", f"r0={replica}"]) == 1
    assert cli.main(["fleettrace", "--router-dump", str(router_dump),
                     "--replica-dump", f"r0={tmp_path / 'missing.json'}"]) == 1
    replica.write_text(json.dumps({"ticks": [], "events": [], "spans": [
        {"request_id": 5, "phase": "decode", "start_ns": 1200, "end_ns": 1800, "slot": 0,
         "fleet": "r1-1", "hop": 0}]}))
    out = tmp_path / "ok.json"
    assert cli.main(["fleettrace", "--router-dump", str(router_dump),
                     "--replica-dump", f"r0={replica}", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["fleetJoin"]["joined"] == 1
    with pytest.raises(SystemExit, match="--router-dump"):
        cli.main(["fleettrace"])


def test_fleet_modes_ported_and_role_refused():
    assert "router" in cli.PORTED_MODES and "fleettrace" in cli.PORTED_MODES
    assert "router" not in cli.PENDING_MODES and "fleettrace" not in cli.PENDING_MODES
    # --role is ported with KV migration: refused only without batched paged
    # serving, with the JAX CLI's message
    with pytest.raises(SystemExit, match="--role tags a disaggregated replica; it needs "
                                         "batched paged serving"):
        cli.main(["api", "--role", "prefill", "--model", "m.m", "--tokenizer", "t.t"])
    with pytest.raises(SystemExit, match="at least one --replica"):
        cli.main(["router"])
    with pytest.raises(SystemExit, match="--slo: unknown SLO objective"):
        cli.main(["router", "--replica", "http://127.0.0.1:1", "--slo", "p95=3"])


def test_router_process_serves_without_a_model(tmp_path):
    """``python -m dllama_tpu_torch router`` in a process of its own: it
    binds, answers /readyz 503 ``loading`` while its one replica is
    unreachable, loads no torch library, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "router", "--replica",
         "http://127.0.0.1:9", "--port", "0", "--probe-interval", "0.2",
         "--slo", "ttft_p95_ms=500,shed_rate=0.05"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        for line in proc.stdout:
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "the router never printed its address"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{port}/readyz")
        assert e.value.code == 503
        slo = json.loads(_get(f"http://127.0.0.1:{port}/debug/slo"))
        assert set(slo["objectives"]) == {"ttft_p95_ms", "shed_rate"}
        # host only: the router process never loads torch (nor so CUDA)
        maps = Path(f"/proc/{proc.pid}/maps").read_text()
        assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
