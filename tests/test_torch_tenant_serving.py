"""Tenancy in the port's scheduler (``dllama_tpu_torch/runtime/serving.py``)
held against the JAX package's ``BatchScheduler`` on the tiny model of
``tests/test_tenancy.py`` (vocab 268, seq_len 96), over the paged pool and
the dense one: the same submit script under the same ``tenant_limits``
(a slot-capped flooder, a weight-4 light tenant, a token-rate-metered
tenant, anonymous traffic), driven tick by tick on the calling thread, gives
the same admission order, the same shed reasons and the same per-tenant
totals (tokens, admissions, sheds) — and every request's tokens equal the
JAX scheduler's. The per-tenant sums reconcile with the global counters."""

from __future__ import annotations

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime import tenancy as jten
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.serving import BatchScheduler as JaxScheduler
from dllama_tpu.runtime.serving import TenantOverBudgetError as JaxOverBudget
from dllama_tpu_torch.runtime import telemetry as ttm
from dllama_tpu_torch.runtime import tenancy as tten
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import (BatchScheduler, QueueFullError,
                                              TenantOverBudgetError)

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

LIMITS = {"flood": {"max_slots": 1}, "light": {"weight": 4.0},
          "metered": {"tokens_per_s": 20.0}}
# (tenant, prompt, max_tokens, temperature, seed)
SCRIPT = ([("flood", f"flood {i} hello", 7, 0.0, i) for i in range(5)]
          + [("light", f"light {i}", 5, 0.8, 10 + i) for i in range(3)]
          + [("metered", f"meter {i}", 8, 0.0, 20 + i) for i in range(3)]
          + [("", "anonymous caller", 6, 0.0, 30), ("flood", "flood late", 4, 0.0, 31)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tenant_serving")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(23))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


@pytest.fixture(autouse=True)
def _fresh_tenancy():
    jten.reset()
    tten.reset()
    yield
    jten.reset()
    tten.reset()


def _run(sched, tok, over_budget):
    """Submit the script, then tick on this thread until every admitted
    request is done. Returns (admission order, sheds, tokens per request)."""
    order = []
    begin = sched.gen.begin_admit

    def spy(req, slot):
        order.append((req.tenant, req.rid))
        return begin(req, slot)

    sched.gen.begin_admit = spy
    reqs, sheds = [], []
    for tenant, prompt, n, temp, seed in SCRIPT:
        try:
            reqs.append(sched.submit(tok.encode(prompt, is_start=True), n,
                                     stop_on_eos=False, temperature=temp, seed=seed,
                                     tenant=tenant))
        except over_budget as e:
            sheds.append((tenant, type(e).__name__.replace("Jax", "")))
    for _ in range(2000):
        if all(r.done.is_set() for r in reqs):
            break
        sched._tick()
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return order, sheds, [list(r.tokens) for r in reqs]


def _totals(snap: dict) -> dict:
    keys = ("prefill_tokens", "decode_tokens", "admissions", "sheds", "timeouts",
            "spec_drafted", "spec_accepted")
    return {t: {k: st[k] for k in keys} for t, st in snap["tenants"].items()}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_same_admission_order_sheds_and_tenant_totals(files, paged):
    m, t = files
    block = 16 if paged else 0
    jeng = JaxEngine(m, t, tp=1, kv_block_size=block)
    teng = InferenceEngine(m, t, device="cpu", kv_block_size=block)
    g = ttm.registry()
    base_batch = g.counter(ttm.BATCH_TOKENS).total()
    base_adm = g.counter(ttm.ADMISSIONS).total()
    jsched = JaxScheduler(jeng, n_slots=3, _start_thread=False,
                          tenant_limits=jten.parse_limits(LIMITS))
    tsched = BatchScheduler(teng, n_slots=3, _start_thread=False,
                            tenant_limits=tten.parse_limits(LIMITS))
    try:
        want = _run(jsched, jeng.tokenizer, JaxOverBudget)
        got = _run(tsched, teng.tokenizer, TenantOverBudgetError)
    finally:
        jsched.close()
        tsched.close()
        jeng.close()
        teng.close()
    assert got[0] == want[0], "admission order differs"
    assert got[1] == want[1] and got[1], "shed decisions differ"
    assert got[2] == want[2], "per-request tokens differ"
    # the slot cap held: a flood admission always follows its predecessor's
    # retirement, so flood's admissions are spread through the order
    tenants = [a for a, _ in got[0]]
    assert tenants.count("flood") == 6 and tenants[:3].count("flood") == 1
    tsnap, jsnap = tten.registry().snapshot(), jten.registry().snapshot()
    assert _totals(tsnap) == _totals(jsnap)
    assert tsnap["tenants"]["metered"]["sheds"] == {"tenant_rate_budget": len(got[1])}
    # per-tenant sums reconcile with the global counters, exactly
    assert sum(s["decode_tokens"] for s in tsnap["tenants"].values()) \
        == g.counter(ttm.BATCH_TOKENS).total() - base_batch
    assert sum(s["admissions"] for s in tsnap["tenants"].values()) \
        == g.counter(ttm.ADMISSIONS).total() - base_adm == len(got[2])


def test_queue_full_shed_is_attributed(files):
    """The shared ``max_queue`` bound sheds before the tenant budget and is
    attributed to the shed tenant (``queue_full``), as in the JAX scheduler;
    the budget error is a ``QueueFullError`` (the api's 429)."""
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", kv_block_size=16)
    sched = BatchScheduler(eng, n_slots=2, max_queue=2, _start_thread=False,
                           tenant_limits=tten.parse_limits(LIMITS))
    try:
        ids = eng.tokenizer.encode("hello", is_start=True)
        sched.submit(ids, 4, tenant="light")
        sched.submit(ids, 4, tenant="light")
        with pytest.raises(QueueFullError) as e:
            sched.submit(ids, 4, tenant="flood")
        assert not isinstance(e.value, TenantOverBudgetError)
        assert issubclass(TenantOverBudgetError, QueueFullError)
    finally:
        sched.close()
        eng.close()
    snap = tten.registry().snapshot()["tenants"]
    assert snap["flood"]["sheds"] == {"queue_full": 1}
    evs = [e for e in sched.flight.snapshot()["events"] if e["event"] == "shed"]
    assert evs[-1]["reason"] == "queue_full" and evs[-1]["tenant"] == "flood"
