"""The port's tenant observatory (``dllama_tpu_torch/runtime/tenancy.py``)
held against the JAX package's ``runtime/tenancy.py`` in one process: the
identity and limits grammar give the same verdicts, ``FairQueue`` pops in the
same order for seeded push/peek/pop/push_front/remove scripts (hypothesis),
and ``TenantRegistry.snapshot``, ``fairness`` and ``usage_record`` are equal
after the same events, overflow into ``other`` included, under injected
clocks and separate metric registries. Host only."""

from __future__ import annotations

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu.runtime import tenancy as jten
from dllama_tpu_torch.runtime import telemetry as ttm
from dllama_tpu_torch.runtime import tenancy as tten


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return ("err", str(e))
    if isinstance(out, dict):
        out = {k: v.as_dict() for k, v in out.items()}
    return ("ok", out)


def test_constants_and_sanitize_same():
    for name in ("ANON", "OTHER", "TENANT_CAP", "ADMIT_REASONS", "FAIR_WINDOW_S",
                 "BURST_S"):
        assert getattr(tten, name) == getattr(jten, name), name
    for raw in ("acme", "a.b_c-d.42", "  acme  ", "x" * 64, None, "", " ", "x" * 65,
                "has space", "no/slash", "bad{brace}", "naïve", b"bytes", 42):
        assert tten.sanitize_tenant(raw) == jten.sanitize_tenant(raw), raw


@pytest.mark.parametrize("doc", [
    {"acme": {"weight": 2, "max_slots": 3, "tokens_per_s": 100}, "*": {"weight": 0.5}},
    {"light": {"weight": 4}, "flood": {"max_slots": 2}},
    {},
    [1, 2],
    {"bad id": {"weight": 1}},
    {"acme": 3},
    {"acme": {"wieght": 1}},
    {"acme": {"weight": 0}},
    {"acme": {"weight": float("inf")}},
    {"acme": {"max_slots": -1}},
    {"acme": {"tokens_per_s": -2}},
])
def test_parse_limits_same_verdicts(doc):
    assert _outcome(tten.parse_limits, doc) == _outcome(jten.parse_limits, doc)


def test_load_limits_inline_file_and_garbage_same(tmp_path):
    f = tmp_path / "limits.json"
    f.write_text(json.dumps({"metered": {"tokens_per_s": 5}}))
    for arg in (str(f), '{"a": {"weight": 3}}', "{not json", '{"a": {"nope": 1}}'):
        got, want = _outcome(tten.load_limits, arg), _outcome(jten.load_limits, arg)
        if want[0] == "err":
            # the JSON decoder's message names the same position in both
            assert got[0] == "err" and got[1] == want[1], arg
        else:
            assert got == want, arg


def test_jain_index_same():
    for vals in ([], [0, 0], [1], [1, 1, 1], [3, 1], [0.2, 0.5, 0.9, 0.0], [5, 0, 0, 1]):
        assert tten.jain_index(vals) == jten.jain_index(vals), vals


class _Item:
    def __init__(self, n: int, tenant: str):
        self.n, self.tenant = n, tenant


# one op: (kind, tenant index, blocked mask)
_OPS = st.lists(st.tuples(st.sampled_from(["push", "push", "pop", "pop", "front",
                                            "remove", "peek"]),
                          st.integers(0, 3), st.integers(0, 15)),
                min_size=1, max_size=60)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, weights=st.lists(st.sampled_from([0.5, 1.0, 2.0, 4.0]), min_size=4,
                                  max_size=4))
def test_fair_queue_same_order(ops, weights):
    """Seeded push/peek/pop/push_front/remove scripts over four weighted
    tenants: the port's FairQueue proposes, pops and iterates exactly as the
    JAX one does (peeks under a blocked-tenant set included)."""
    tenants = ["t0", "t1", "t2", "t3"]
    wof = dict(zip(tenants, weights)).get
    queues = (jten.FairQueue(weight_of=wof), tten.FairQueue(weight_of=wof))
    items = ([], [])
    popped = ([], [])
    seq = 0
    for kind, ti, mask in ops:
        blocked = frozenset(t for j, t in enumerate(tenants) if mask >> j & 1)
        heads = [q.peek(blocked if kind == "peek" else frozenset()) for q in queues]
        assert [h and h.n for h in heads] == [heads[0] and heads[0].n] * 2
        for side, q in enumerate(queues):
            if kind == "push":
                it = _Item(seq, tenants[ti])
                items[side].append(it)
                q.push(it)
            elif kind == "pop" and heads[side] is not None:
                popped[side].append(q.pop(heads[side]).n)
            elif kind == "front" and popped[side]:
                n = popped[side].pop()
                q.push_front(next(i for i in items[side] if i.n == n))
            elif kind == "remove":
                live = [i for i in q if i.tenant == tenants[ti]]
                if live:
                    q.remove(live[-1])
        if kind == "push":
            seq += 1
        assert len(queues[0]) == len(queues[1]) and bool(queues[0]) == bool(queues[1])
        assert [i.n for i in queues[1]] == [i.n for i in queues[0]]
        assert queues[1].tenants_queued() == queues[0].tenants_queued()
    assert popped[1] == popped[0]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pair(cap: int = tten.TENANT_CAP):
    cj, ct = _Clock(), _Clock()
    rj, rt = jtm.Registry(), ttm.Registry()
    return (jten.TenantRegistry(registry=rj, clock=cj, cap=cap),
            tten.TenantRegistry(registry=rt, clock=ct, cap=cap), (cj, ct), (rj, rt))


def _strip_wall(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("t_wall", "uptime_s")}


@pytest.mark.parametrize("cap", [8, tten.TENANT_CAP])
def test_registry_views_equal_after_same_events(cap):
    """The same script of resolves (past the cap: overflow into ``other``),
    limits, token charges, sheds, admissions, TTFT/ITL, timeouts,
    speculation and KV ticks: snapshot, fairness, usage_record and the
    published ``dllama_tenant_*`` series are equal."""
    jr, tr, clocks, regs = _pair(cap)
    limits = {"flood": {"max_slots": 2}, "light": {"weight": 4},
              "metered": {"tokens_per_s": 3}, "*": {"weight": 1.5}}
    jr.set_limits(jten.parse_limits(limits))
    tr.set_limits(tten.parse_limits(limits))
    names = ["flood", "light", "metered", "anon", "bad id"] + [f"fz{i}" for i in range(12)]
    for step in range(240):
        for c in clocks:
            c.t += 0.37
        raw = names[(step * 7) % len(names)]
        lj, lt = jr.resolve(raw), tr.resolve(raw)
        assert lt == lj
        cost = 1 + step % 9
        assert tr.try_charge_tokens(lt, cost) == jr.try_charge_tokens(lj, cost)
        k = step % 6
        for r in (jr, tr):
            if k == 0:
                r.note_admission(lj, 0.5 + step / 7)
                r.note_prefill_tokens(lj, 3 + step % 5)
            elif k == 1:
                r.note_ttft(lj, 10.0 + step)
                r.note_decode_tokens(lj, 1 + step % 3)
            elif k == 2:
                r.note_itl(lj, 4.0 + (step % 11) / 3, n=1 + step % 4)
                r.note_decode_tokens(lj, 2)
            elif k == 3:
                r.note_shed(lj, jten.ADMIT_REASONS[step % len(jten.ADMIT_REASONS)])
            elif k == 4:
                r.note_timeout(lj)
                r.note_spec(lj, drafted=4, accepted=step % 5)
                r.note_admission(lj)
            else:
                r.note_tick(0.25, {lj: 1 + step % 3, "light": 2.0}, {lj: 1})
    assert tr.snapshot() == jr.snapshot()
    assert tr.fairness() == jr.fairness()
    assert _strip_wall(tr.usage_record(7)) == _strip_wall(jr.usage_record(7))
    assert tr.limit_for("nobody").as_dict() == jr.limit_for("nobody").as_dict()
    # the dllama_tenant_* series each registry renders for /metrics
    def series(reg):
        return [ln for ln in reg.render().splitlines() if ln.startswith("dllama_tenant_")]

    assert series(regs[1]) == series(regs[0]) and len(series(regs[0])) > 20
    if cap == 8:
        assert jten.OTHER in tr.snapshot()["tenants"]


def test_usage_ledger_lines_equal_and_monotonic(tmp_path):
    """Both ledgers, fed the same registry events on the same clock, write
    the same lines (wall stamps aside), cumulative and monotonic."""
    jr, tr, clocks, _ = _pair()
    lc = _Clock()
    lj, lt = jten.UsageLedger(clock=lc), tten.UsageLedger(clock=lc)
    pj, pt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    lj.configure(str(pj), interval_s=1.0)
    lt.configure(str(pt), interval_s=1.0)
    for step in range(30):
        lc.t += 0.4
        for r in (jr, tr):
            r.note_decode_tokens(r.resolve(f"t{step % 3}"), step + 1)
        assert lt.maybe_write(tr) == lj.maybe_write(jr)
    assert lt.maybe_write(tr, force=True) and lj.maybe_write(jr, force=True)
    a = [_strip_wall(json.loads(x)) for x in pj.read_text().splitlines()]
    b = [_strip_wall(json.loads(x)) for x in pt.read_text().splitlines()]
    assert b == a and len(b) > 5
    prev: dict = {}
    for rec in b:
        for t, v in rec["tenants"].items():
            assert v["decode_tokens"] >= prev.get(t, 0)
            prev[t] = v["decode_tokens"]


def test_process_registry_reset():
    tten.reset()
    reg = tten.registry()
    reg.note_decode_tokens(reg.resolve("acme"), 3)
    assert reg.snapshot()["tenants"]["acme"]["decode_tokens"] == 3
    tten.reset()
    assert tten.registry() is not reg and tten.registry().snapshot()["tenants"] == {}
    assert not tten.ledger().enabled
