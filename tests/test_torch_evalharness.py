"""The port's quality observatory (``dllama_tpu_torch.runtime.evalharness``,
``Request.score`` in both generators, ``InferenceEngine.score_nll`` and the
CLI's ``eval`` mode) on the CPU, mirroring ``tests/test_evalharness.py``.

The model is the JAX suite's builtin eval model (``tiny_header_params(
seq_len=64)`` drawn from seed ``0x5EED``, the one ``QUALITY_BASELINE.json``
was recorded on). The port's per-token NLLs equal the JAX engine's within
rtol 1e-5, atol 1e-6 (f32 exact; the frameworks sum in other orders, so
bit identity across them is not a goal); the port's four configs
(``single``, ``dense``, ``paged``, ``paged_spec``) give bit-identical
per-sequence and total NLL hexes among themselves; the ``single``
perplexity equals the committed baseline within rel 1e-4 (the JAX test's
own bound); mid-run faults give partials; ``eval --json --compare`` works;
``/debug/eval`` and ``/readyz`` report eval residency."""

from __future__ import annotations

import json
import math
import os
import threading
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime import evalharness
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "goldens", "eval_tiny.jsonl")
BASELINE = os.path.join(REPO, "QUALITY_BASELINE.json")
BUILTIN_SEED = 0x5EED
NLL_RTOL, NLL_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """A leaked armed failpoint would crash unrelated schedulers."""
    fp.registry().clear()
    yield
    fp.registry().clear()


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_evalharness")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(seq_len=64),
                     np.random.RandomState(BUILTIN_SEED))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # BatchedApiState needs one
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


@pytest.fixture(scope="module")
def oracle_engine(model_files):
    eng = InferenceEngine(*model_files, device="cpu")
    yield eng
    eng.close()


def _seqs():
    return evalharness.load_dataset(FIXTURE)


def _engine(model_files, **kw):
    return InferenceEngine(*model_files, device="cpu", **kw)


# -- load_dataset ---------------------------------------------------------------


def test_load_dataset_rejects_bad_entries(tmp_path):
    p = tmp_path / "d.jsonl"
    p.write_text('{"text": "hello"}\n')
    with pytest.raises(ValueError, match=r"d\.jsonl:1: 'text' entry needs"):
        evalharness.load_dataset(str(p))
    p.write_text('{"tokens": [5]}\n')
    with pytest.raises(ValueError, match=r":1: sequence has 1 token"):
        evalharness.load_dataset(str(p))
    p.write_text('{"tokens": [5, 6, 7]}\nnot json{\n')
    with pytest.raises(ValueError, match=r":2: not JSON"):
        evalharness.load_dataset(str(p))
    p.write_text('{"neither": 1}\n')
    with pytest.raises(ValueError, match=r"neither 'tokens' nor 'text'"):
        evalharness.load_dataset(str(p))
    p.write_text("\n\n")
    with pytest.raises(ValueError, match="empty eval dataset"):
        evalharness.load_dataset(str(p))
    p.write_text('{"tokens": [1, 2, 3, 4, 5]}\n')
    assert evalharness.load_dataset(str(p), seq_len=3) == [{"id": "seq0", "tokens": [1, 2, 3]}]


def test_load_dataset_text_form_encodes(tmp_path, oracle_engine):
    p = tmp_path / "t.jsonl"
    p.write_text('{"id": "greeting", "text": "hello world"}\n')
    seqs = evalharness.load_dataset(str(p), oracle_engine.tokenizer)
    assert seqs[0]["id"] == "greeting" and len(seqs[0]["tokens"]) >= 2


# -- the oracle against the JAX engine ------------------------------------------


@pytest.mark.parametrize("sync", ["f32", "q80"])
def test_score_nll_matches_jax_engine(model_files, sync):
    """Per-token NLLs of every fixture sequence: the port's ``score_nll``
    against the JAX engine's on the same file (f32 exact; with and without
    the Q80 sync casts)."""
    from dllama_tpu.formats.quants import F32, Q80

    st = F32 if sync == "f32" else Q80
    jeng = JaxEngine(*model_files, tp=1, sync_type=st)
    eng = _engine(model_files, sync_type=st)
    try:
        for seq in _seqs():
            got = eng.score_nll(seq["tokens"])
            want = np.asarray(jeng.score_nll(seq["tokens"]))
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=NLL_RTOL, atol=NLL_ATOL)
        assert eng.seen_buckets == {32}  # every fixture sequence fits one 32-row chunk
    finally:
        jeng.close()
        eng.close()


# -- the four configs, bit for bit, and the committed golden --------------------


def test_eval_parity_golden(model_files, oracle_engine):
    """All four configs give bit-identical per-sequence and total NLL hexes;
    the single-sequence perplexity is the committed QUALITY_BASELINE.json
    number; a warm rerun repeats the hex; the ``dllama_eval_*`` family and
    the last-run store carry the evidence."""
    seqs = _seqs()
    n_scored = sum(len(s["tokens"]) - 1 for s in seqs)
    runs = {"single": evalharness.run_eval(seqs, dataset="eval_tiny", config="single",
                                           engine=oracle_engine)}
    sched = BatchScheduler(oracle_engine, n_slots=4)
    try:
        runs["dense"] = evalharness.run_eval(seqs, dataset="eval_tiny", config="dense",
                                             sched=sched)
    finally:
        sched.close()
    for config, kw in (("paged", {"kv_block_size": 8}),
                       ("paged_spec", {"kv_block_size": 8, "spec_lookup": 4})):
        eng = _engine(model_files, **kw)
        sched = BatchScheduler(eng, n_slots=4)
        try:
            runs[config] = evalharness.run_eval(seqs, dataset="eval_tiny", config=config,
                                                sched=sched)
            if config == "paged":
                rerun = evalharness.run_eval(seqs, dataset="eval_tiny", config=config,
                                             sched=sched)
                assert rerun["total_nll_hex"] == runs[config]["total_nll_hex"]
        finally:
            sched.close()
            eng.close()
    for config, run in runs.items():
        assert run["n_seqs"] == len(seqs), config
        assert run["n_tokens"] == n_scored, config
        assert run["partial"] is False and math.isfinite(run["perplexity"])
    assert len({r["total_nll_hex"] for r in runs.values()}) == 1, \
        {c: r["total_nll_hex"] for c, r in runs.items()}
    per_seq = {c: [e["nll_hex"] for e in r["seqs"]] for c, r in runs.items()}
    assert per_seq["single"] == per_seq["dense"] == per_seq["paged"] == per_seq["paged_spec"]
    with open(BASELINE, encoding="utf-8") as f:
        golden = json.load(f)["metrics"]["eval_tiny.perplexity"]["value"]
    assert runs["single"]["perplexity"] == pytest.approx(golden, rel=1e-4)
    reg = tm.registry()
    assert reg.counter(tm.EVAL_TOKENS).total(dataset="eval_tiny", config="single") >= n_scored
    assert reg.counter(tm.EVAL_NLL).total(dataset="eval_tiny", config="paged") > 0
    assert reg.gauge(tm.EVAL_PERPLEXITY).value(dataset="eval_tiny") == pytest.approx(
        runs["paged_spec"]["perplexity"])
    last = evalharness.last_run()
    assert last is not None and last["partial"] is False


def test_scoring_requests_emit_nothing_and_leave_no_prefix(model_files):
    """A scoring request retires after its last prefill chunk with no token,
    balances admissions and retires, and leaves nothing a later request's
    prefix match could reuse: the paged pool registers no blocks and frees
    them all."""
    eng = _engine(model_files, kv_block_size=8)
    sched = BatchScheduler(eng, n_slots=2)
    reg = tm.registry()
    adm0, ret0 = reg.counter(tm.ADMISSIONS).total(), reg.counter(tm.RETIRES).total()
    try:
        seq = _seqs()[3]["tokens"]
        req = sched.submit(seq, 0, score=True)
        assert req.done.wait(timeout=60) and req.error is None
        assert req.tokens == [] and sum(p.size for p in req.nll_parts) == len(seq) - 1
        assert reg.counter(tm.ADMISSIONS).total() - adm0 == 1
        assert reg.counter(tm.RETIRES).total() - ret0 == 1
        pool = sched.gen.pool
        assert pool.used_blocks() == 0
        assert pool.match_prefix(seq[:-1])[1] == 0
        np.testing.assert_array_equal(np.concatenate(req.nll_parts), eng.score_nll(seq))
    finally:
        sched.close()
        eng.close()


def test_run_eval_rejects_unknown_config_and_missing_backend(oracle_engine):
    with pytest.raises(ValueError, match="unknown eval config"):
        evalharness.run_eval([], dataset="d", config="typo", engine=oracle_engine)
    with pytest.raises(ValueError, match="needs engine="):
        evalharness.run_eval([], dataset="d", config="single")
    with pytest.raises(ValueError, match="needs sched="):
        evalharness.run_eval([], dataset="d", config="paged")


# -- faults: a mid-run failure is loud, never a truncation ---------------------


def test_midrun_fault_yields_partial_with_completed_vs_in_flight(oracle_engine, monkeypatch):
    seqs = _seqs()
    real = oracle_engine.score_nll
    calls = {"n": 0}

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected scorer fault")
        return real(ids)

    monkeypatch.setattr(oracle_engine, "score_nll", flaky)
    with pytest.raises(evalharness.EvalAborted, match="seq2") as ei:
        evalharness.run_eval(seqs, dataset="eval_tiny", config="single",
                             engine=oracle_engine)
    p = ei.value.partial
    assert p["partial"] is True
    assert p["completed"] == ["seq0", "seq1"]
    assert p["in_flight"] == ["seq2", "seq3", "seq4", "seq5"]
    assert "injected scorer fault" in p["error"]
    assert [e["id"] for e in p["seqs"]] == ["seq0", "seq1"]
    assert evalharness.last_run()["partial"] is True


def test_eval_failpoint_aborts_batched_submit(oracle_engine):
    seqs = _seqs()
    sched = BatchScheduler(oracle_engine, n_slots=2, _start_thread=False)
    try:
        fp.registry().arm("eval", "raise", times=1)
        with pytest.raises(evalharness.EvalAborted, match="submit failed"):
            evalharness.run_eval(seqs, dataset="eval_tiny", config="dense", sched=sched)
        p = evalharness.last_run()
        assert p["partial"] is True and p["completed"] == []
        assert p["in_flight"] == [s["id"] for s in seqs]
        assert sched.is_alive()
    finally:
        sched.close()


def test_scheduler_crash_midrun_aborts_with_partial(model_files):
    eng = _engine(model_files)
    sched = BatchScheduler(eng, n_slots=2)
    try:
        fp.registry().arm("step_hang", "raise", times=1)
        with pytest.raises(evalharness.EvalAborted):
            evalharness.run_eval(_seqs(), dataset="eval_tiny", config="dense", sched=sched,
                                 timeout_s=120.0)
        assert evalharness.last_run()["partial"] is True
    finally:
        sched.close()
        eng.close()


# -- CLI: python -m dllama_tpu_torch eval -----------------------------------------


def _last_json(text: str) -> dict:
    for line in text.splitlines()[::-1]:
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in: {text!r}")


@pytest.mark.parametrize("flags,primary,compare", [
    (["--batch-slots", "2", "--kv-block-size", "8"], "paged", "single"),
    ([], "single", "paged_spec"),
    (["--batch-slots", "3"], "dense", "paged"),
])
def test_cli_eval_json_with_compare_parity(model_files, capsys, flags, primary, compare):
    mpath, tpath = model_files
    rc = cli.main(["eval", "--model", mpath, "--tokenizer", tpath, "--device", "cpu",
                   "--buffer-float-type", "f32", "--data", FIXTURE, "--json",
                   "--compare", compare, *flags])
    out = capsys.readouterr().out
    assert rc == 0
    res = _last_json(out)
    assert res["config"] == primary and res["dataset"] == "eval_tiny"
    assert res["compare"]["config"] == compare
    assert res["parity_drift"] is False
    assert res["total_nll_hex"] == res["compare"]["total_nll_hex"]
    with open(BASELINE, encoding="utf-8") as f:
        golden = json.load(f)["metrics"]["eval_tiny.perplexity"]["value"]
    assert res["perplexity"] == pytest.approx(golden, rel=1e-4)


def test_cli_eval_without_tokenizer_and_human_output(model_files, capsys):
    """A token-id dataset needs no tokenizer; without ``--json`` the summary
    prints as the human table."""
    rc = cli.main(["eval", "--model", model_files[0], "--device", "cpu", "--data", FIXTURE])
    out = capsys.readouterr().out
    assert rc == 0
    assert "📊 eval eval_tiny [single]: 6 seqs, 131 tokens" in out
    assert "📊 Perplexity:" in out


def test_cli_eval_failpoint_exits_nonzero_with_partial_json(model_files, capsys):
    mpath, tpath = model_files
    fp.registry().arm("eval", "raise", times=1)
    rc = cli.main(["eval", "--model", mpath, "--tokenizer", tpath, "--device", "cpu",
                   "--data", FIXTURE, "--json"])
    cap = capsys.readouterr()
    assert rc == 1
    partial = _last_json(cap.out)
    assert partial["partial"] is True
    assert set(partial["completed"]) | set(partial["in_flight"]) == {f"seq{i}" for i in range(6)}
    assert "💥" in cap.err


def test_cli_eval_requires_data(model_files):
    mpath, tpath = model_files
    with pytest.raises(SystemExit, match="--data"):
        cli.main(["eval", "--model", mpath, "--tokenizer", tpath, "--device", "cpu"])


# -- residency on /readyz + GET /debug/eval ---------------------------------------


def test_eval_resident_counts_scoring_work(oracle_engine):
    sched = BatchScheduler(oracle_engine, n_slots=2, _start_thread=False)
    try:
        assert sched.eval_resident() == 0
        sched.submit([1, 2, 3, 4], 0, score=True)
        sched.submit([5, 6, 7], 0, score=True)
        sched.submit([8, 9], 2)  # decode work is not eval residency
        assert sched.eval_resident() == 2
    finally:
        sched.close()


def test_readyz_advertises_eval_residency_and_debug_eval(oracle_engine):
    from dllama_tpu_torch.serve.api import BatchedApiState, make_handler

    state = BatchedApiState(oracle_engine, n_slots=2)
    # a hand-driven scheduler, so residency is deterministic (the real loop
    # would drain the eval work before the probe lands)
    state.sched.close()
    state.sched = BatchScheduler(oracle_engine, n_slots=2, _start_thread=False)
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/readyz") as r:
            assert "eval_resident" not in json.loads(r.read())  # zero is not advertised
        state.sched.submit([1, 2, 3, 4], 0, score=True)
        with urllib.request.urlopen(url + "/readyz") as r:
            assert json.loads(r.read())["eval_resident"] == 1
        marker = {"dataset": "eval_tiny", "config": "single", "partial": False,
                  "perplexity": 42.0}
        evalharness.set_last_run(marker)
        with urllib.request.urlopen(url + "/debug/eval") as r:
            assert json.loads(r.read()) == marker
        with urllib.request.urlopen(url + "/debug") as r:
            assert "/debug/eval" in json.loads(r.read())["endpoints"]
        http = tm.registry().counter(tm.HTTP_REQUESTS)
        assert http.total(route="/debug/eval", status="200") >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.sched.close()
