"""The port's roofline math (``dllama_tpu_torch/runtime/roofline.py``)
against the JAX package's: ``attribute``, ``rate_roofline`` and
``rate_roofline_families`` return the same dicts over a seeded grid (a
zero-FLOP program, a missing wall and raw fractions above 1 included),
``probe_ceilings`` reads the same probe files alike, and ``snapshot`` has the
same keys; then the port's own ceilings: the H100's nameplate row, a card
without a row gets ``no_evidence``, never a borrowed row, and the
``--stats`` line carries ``roofline=``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch  # noqa: F401 — the device kind is read from torch once it is imported

from dllama_tpu.runtime import introspection as jintro
from dllama_tpu.runtime import roofline as jroof
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu_torch.runtime import introspection, roofline, telemetry as tm


def _grid(seed: int) -> list[tuple]:
    """(bytes, flops, wall_ms) cases: random, a zero-FLOP program, a zero
    program, a missing and a zero wall, and over-unity rates."""
    rng = np.random.default_rng(seed)
    cases = [(float(rng.uniform(1e6, 2e10)), float(rng.uniform(0, 5e13)),
              float(rng.uniform(0.01, 80.0))) for _ in range(40)]
    return cases + [(8.5e9, 0.0, 29.0), (0.0, 0.0, 5.0), (1e9, 1e12, None), (1e9, 1e12, 0.0),
                    (5e10, 1e9, 1.0), (1e6, 5e15, 1.0), (1e3, 1.0, 1e6)]


CEILINGS = [(3350.0, 989.0, "nameplate:h100"), (770.0, 70.0, "probe:x"), (50.0, 1.0, "cpu")]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gbps,tflops,source", CEILINGS)
def test_attribute_equals_jax(seed, gbps, tflops, source):
    mine = roofline.Ceilings(hbm_gbps=gbps, tflops=tflops, source=source)
    theirs = jroof.Ceilings(hbm_gbps=gbps, tflops=tflops, source=source)
    for n_bytes, flops, wall in _grid(seed):
        assert roofline.attribute(n_bytes, flops, wall, mine) == \
            jroof.attribute(n_bytes, flops, wall, theirs), (n_bytes, flops, wall)


@pytest.mark.parametrize("gbps,tflops,source", CEILINGS)
def test_rate_rooflines_equal_jax(gbps, tflops, source):
    mine = roofline.Ceilings(hbm_gbps=gbps, tflops=tflops, source=source)
    theirs = jroof.Ceilings(hbm_gbps=gbps, tflops=tflops, source=source)
    rng = np.random.default_rng(5)
    for _ in range(40):
        tok_s, weight_gb = float(rng.uniform(1, 5000)), float(rng.uniform(0.1, 40))
        assert roofline.rate_roofline(tok_s, weight_gb, mine) == \
            jroof.rate_roofline(tok_s, weight_gb, theirs)
        stage = {k: float(rng.uniform(1, 20000)) for k in
                 ("decode_tok_per_s", "prefill_tok_per_s", "paged_decode_tok_per_s")
                 if rng.random() > 0.3}
        n_params = int(rng.integers(10**6, 10**11))
        assert roofline.rate_roofline_families(stage, weight_gb, n_params, mine) == \
            jroof.rate_roofline_families(stage, weight_gb, n_params, theirs)


def test_probe_ceilings_equal_jax(tmp_path):
    jsonl = tmp_path / "probe.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in (
        {"stage": "device", "kind": "NVIDIA H100 80GB HBM3"},
        {"stage": "hbm_bw", "chain_gbps": 2900.5, "sync_gbps": 2100.0},
        {"stage": "mxu", "tflops": 640.25})) + "\nnot json\n")
    plain = tmp_path / "probe.json"
    plain.write_text(json.dumps({"hbm_gbps": 3000.0, "tflops": 700.0, "device_kind": "x"}))
    half = tmp_path / "half.jsonl"
    half.write_text(json.dumps({"stage": "hbm_bw", "chain_gbps": 1.0}))
    for path in (jsonl, plain, half, tmp_path / "absent.json"):
        mine, theirs = roofline.probe_ceilings(str(path)), jroof.probe_ceilings(str(path))
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert (mine.hbm_gbps, mine.tflops, mine.source, mine.device_kind) == \
                (theirs.hbm_gbps, theirs.tflops, theirs.source, theirs.device_kind)
    assert roofline.load_ceilings(probe_path=str(jsonl)).tflops == 640.25


def test_nameplate_rows_and_no_borrowed_row(monkeypatch):
    h100 = roofline.nameplate_ceilings("NVIDIA H100 80GB HBM3")
    assert (h100.hbm_gbps, h100.tflops, h100.source) == (3350.0, 989.0, "nameplate:h100")
    cpu = roofline.nameplate_ceilings("cpu")
    assert cpu.hbm_gbps > 0 and cpu.tflops > 0
    other = roofline.nameplate_ceilings("NVIDIA A100-SXM4-80GB")
    assert other.hbm_gbps == other.tflops == 0.0
    assert other.source.startswith("no_evidence:") and "A100" in other.source
    got = roofline.attribute(1e9, 1e12, 2.0, other)
    assert set(got) == {"no_evidence"} and "A100" in got["no_evidence"]
    assert "no_evidence" in roofline.rate_roofline(100.0, 4.0, other)
    monkeypatch.delenv("DLLAMA_HW_PROBE_FILE", raising=False)
    assert roofline.load_ceilings(refresh=True).source == "nameplate:cpu"  # torch, no card


def _record_programs(led, tel) -> None:
    """One decode program with an analysis and one without, and decode
    walls in ``tel``'s histograms."""
    e = led.register("engine-1", "decode")
    led.record(e, 0.5, {"tok": "i[1,1]"}, "none", {"hbm_total_bytes": 4_000_000_000,
                                                    "flops": 8e9})
    led.register("engine-1", "verify")
    reg = tel.registry()
    for ms in (500.0, 30.0, 31.0, 29.0):
        reg.histogram(tel.DECODE_STEP_MS).record(ms)


def test_snapshot_keys_equal_jax():
    for tel in (tm, jtm):
        tel.registry().reset()
    led, jled = introspection.ledger(), jintro.ledger()
    led.reset()
    jled.reset()
    try:
        _record_programs(led, tm)
        _record_programs(jled, jtm)
        mine = roofline.snapshot(ceilings=roofline.nameplate_ceilings("cpu"))
        theirs = jroof.snapshot(ceilings=jroof.nameplate_ceilings("cpu"))
        assert set(mine) == set(theirs) == {"ceilings", "programs", "summary"}
        assert set(mine["ceilings"]) == set(theirs["ceilings"])
        assert set(mine["summary"]) == set(theirs["summary"])
        assert [set(p) for p in mine["programs"]] == [set(p) for p in theirs["programs"]]
        # the same numbers from the same ledger and walls
        assert mine["summary"] == theirs["summary"]
        line = tm.stats_line()
        assert f"roofline={100 * mine['summary']['roofline_fraction']:.1f}%" in line
        assert tm.registry().gauge(tm.ROOFLINE_FRACTION).value(
            scope="engine-1", program="decode") == mine["summary"]["roofline_fraction"]
    finally:
        led.reset()
        jled.reset()
