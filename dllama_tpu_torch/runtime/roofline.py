"""Roofline attribution — achieved against ceiling, per program (the port
of the JAX package's ``runtime/roofline.py``: the same math and the same
result schema).

It joins three records the port keeps:

* **per-program bytes + operations** — the compile ledger's analysis
  (``runtime/introspection.py``): what one dispatch of each program moves
  and computes through the kernels K1-K5, counted by their wrappers
  (``ops/cost.py``) during its capture or first run. Norms, rope, the
  sampler and copies are not counted, so a fraction is K1-K5's share of
  what the card could do in the step's wall;
* **per-dispatch walls** — the telemetry step histograms
  (``dllama_decode_step_ms`` / ``dllama_batch_step_ms`` /
  ``dllama_prefill_chunk_ms``, host windows that end in a readback), with
  the ledger's capture and first-run walls subtracted so warm-up
  dispatches don't dilute the steady-state mean;
* **the card's ceilings** — a probe file when one is present
  (``DLLAMA_HW_PROBE_FILE``, the JAX package's format), else the
  nameplate row of the device kind (``torch.cuda.get_device_name()``): the
  H100's data sheet, 3350 GB/s and 989 TFLOP/s dense bf16. A ``Ceilings``
  has one compute rate, so an exact-mode program's compute fraction is
  read against the bf16 rate. A CUDA card without a row and without a
  probe file gets ``no_evidence`` with the reason, never a borrowed row.
  The CPU row is a nominal figure so fractions stay finite in the CPU
  tests, not a measured claim. The ceiling source is always named in the
  output.

Per program it yields achieved GB/s and TFLOP/s, the roofline fraction
(max of the bandwidth and compute fractions, clamped to (0, 1]; a raw value
above 1 means the byte or operation count is wrong and is kept in
``raw_fraction``), and the memory- or compute-bound classification.
Surfaces: ``GET /debug/roofline``, the ``dllama_roofline_fraction`` /
``dllama_achieved_hbm_gbps`` / ``dllama_achieved_tflops`` gauges, the
``roofline=…%`` fragment of ``--stats`` and the CLI's ``roofline:`` line
(:func:`rate_roofline`).

Stdlib only at import; the telemetry and ledger joins import lazily.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

# nameplate peak dense-bf16 TFLOP/s and HBM GB/s by device-kind substring
# (first match wins): the H100 SXM data sheet, and a nominal DDR-class CPU
# line so fractions stay finite in the CPU tests (not a measured claim)
NAMEPLATE_SPECS = (
    ("h100", 989.0, 3350.0),
    ("cpu", 1.0, 50.0),
)

# the probe-file override (the JAX package's knob). The JAX module also
# looks for probe files of its TPU runs at the repo root; the port reads
# none of them
_PROBE_ENV = "DLLAMA_HW_PROBE_FILE"


@dataclass(frozen=True)
class Ceilings:
    """One chip's roofline ceilings and where they came from.

    ``source`` is ``probe:<path>`` (hw_probe measurements) or
    ``nameplate:<kind>`` — achieved-vs-probe and achieved-vs-nameplate
    are different claims and every consumer must say which it made. A
    device kind without either has zero rates and ``no_evidence:<why>``."""

    hbm_gbps: float
    tflops: float
    source: str
    device_kind: str = ""


def nameplate_ceilings(device_kind: str) -> Ceilings:
    """Nameplate ceilings by device-kind substring (the fallback when no
    probe file is present); zero rates and a ``no_evidence:`` source for a
    kind without a row."""
    dk = (device_kind or "").lower()
    for key, tflops, gbps in NAMEPLATE_SPECS:
        if key in dk:
            return Ceilings(hbm_gbps=gbps, tflops=tflops,
                            source=f"nameplate:{key}", device_kind=device_kind)
    return Ceilings(hbm_gbps=0.0, tflops=0.0, device_kind=device_kind,
                    source=f"no_evidence:no nameplate row or probe file for device "
                           f"kind {device_kind!r}")


def _no_ceilings(ceilings: Ceilings) -> dict | None:
    if ceilings.hbm_gbps <= 0 and ceilings.tflops <= 0:
        return {"no_evidence": ceilings.source.removeprefix("no_evidence:")}
    return None


def probe_ceilings(path: str) -> Ceilings | None:
    """Parse a hw_probe output file into ceilings, or None when the file
    is absent/unreadable/incomplete. Two accepted shapes:

    * the tool's own JSONL stream (``tools/hw_probe.py --out FILE``):
      the ``hbm_bw`` stage's ``chain_gbps`` (fetch-forced chain — the
      honest effective bandwidth; ``sync_gbps`` pays one RTT per rep)
      and the ``mxu`` stage's ``tflops``;
    * a plain object ``{"hbm_gbps": ..., "tflops": ...}`` for
      hand-curated snapshots.
    """
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    gbps = tflops = None
    kind = ""
    try:
        obj = json.loads(text)
        if isinstance(obj, dict) and "stage" not in obj:
            gbps = obj.get("hbm_gbps")
            tflops = obj.get("tflops")
            kind = str(obj.get("device_kind", ""))
    except ValueError:
        obj = None
    if gbps is None and tflops is None:
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            stage = rec.get("stage")
            if stage == "hbm_bw":
                gbps = rec.get("chain_gbps") or rec.get("sync_gbps") or gbps
            elif stage == "mxu":
                tflops = rec.get("tflops") or tflops
            elif stage == "device":
                kind = str(rec.get("kind", kind))
    if not gbps or not tflops:
        return None  # a half-measured probe is not a ceiling claim
    return Ceilings(hbm_gbps=float(gbps), tflops=float(tflops),
                    source=f"probe:{path}", device_kind=kind)


_ceilings_cache: list = []  # [] = unresolved; [Ceilings] once resolved


def load_ceilings(device_kind: str | None = None,
                  probe_path: str | None = None, *,
                  refresh: bool = False) -> Ceilings:
    """The process's chip ceilings: probe file first (the explicit path,
    then the env override), nameplate by device kind otherwise. The no-argument call is cached — a probe file
    does not change mid-process."""
    default_call = probe_path is None and device_kind is None
    if default_call and _ceilings_cache and not refresh:
        return _ceilings_cache[0]
    paths = [probe_path] if probe_path else []
    env = os.environ.get(_PROBE_ENV)
    if env:
        paths.append(env)
    for p in paths:
        c = probe_ceilings(p)
        if c is not None:
            break
    else:
        c = nameplate_ceilings(device_kind if device_kind is not None
                               else _detect_device_kind())
    if default_call and c.tflops > 0:  # a missing row may be found once torch is up
        _ceilings_cache.clear()
        _ceilings_cache.append(c)
    return c


def _detect_device_kind() -> str:
    """The device kind: ``torch.cuda.get_device_name(0)`` on a machine with
    a card, ``cpu`` without one. Only consults torch when the process has
    already imported it (an engine is running); a torch-free caller gets
    no kind, and so no row."""
    import sys as _sys

    torch = _sys.modules.get("torch")
    if torch is None:
        return ""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


# -- the per-program math ------------------------------------------------------


def attribute(hbm_bytes: float, flops: float, wall_ms: float | None,
              ceilings: Ceilings) -> dict:
    """THE roofline formula for one program: achieved bandwidth/compute
    from measured bytes/FLOPs over a measured steady-state dispatch
    wall, fractions against the ceilings, and the bound classification.

    Returns a dict with ``roofline_fraction`` in (0, 1] (raw value above
    1 preserved in ``raw_fraction`` — over-unity means the byte/FLOP
    accounting over-counted, not that the chip beat physics), or a
    ``no_evidence`` reason when a side is missing. A zero-FLOP program
    is legitimate (pure gather/copy): it classifies memory-bound on its
    bandwidth fraction alone."""
    if wall_ms is None or wall_ms <= 0:
        return {"no_evidence": "no steady-state dispatch wall measured"}
    if hbm_bytes <= 0 and flops <= 0:
        return {"no_evidence": "no measured bytes or FLOPs "
                               "(compile-ledger analysis missing)"}
    if (missing := _no_ceilings(ceilings)) is not None:
        return missing
    wall_s = wall_ms / 1e3
    achieved_gbps = hbm_bytes / wall_s / 1e9
    achieved_tflops = flops / wall_s / 1e12
    bw_frac = achieved_gbps / ceilings.hbm_gbps if ceilings.hbm_gbps else 0.0
    comp_frac = achieved_tflops / ceilings.tflops if ceilings.tflops else 0.0
    raw = max(bw_frac, comp_frac)

    def _frac(f: float) -> float:
        # 6 decimals, floored at 1e-6 for positive values: a CPU-mesh toy
        # model against real silicon ceilings is genuinely ~1e-5, and the
        # (0, 1] contract must survive the rounding
        return max(round(min(1.0, f), 6), 1e-6 if f > 0 else 0.0)

    out = {
        "wall_ms": round(wall_ms, 4),
        "hbm_bytes": int(hbm_bytes),
        "flops": float(flops),
        "achieved_hbm_gbps": round(achieved_gbps, 6),
        "achieved_tflops": round(achieved_tflops, 6),
        "bw_fraction": _frac(bw_frac),
        "compute_fraction": _frac(comp_frac),
        "roofline_fraction": _frac(raw),
        "bound": "memory" if bw_frac >= comp_frac else "compute",
    }
    if raw > 1.0:
        out["raw_fraction"] = round(raw, 4)
    if flops > 0 and hbm_bytes > 0:
        # operational intensity vs the machine's ridge point — the classic
        # roofline x-axis, kept for plotting
        out["flops_per_byte"] = round(flops / hbm_bytes, 4)
        out["ridge_flops_per_byte"] = round(
            ceilings.tflops * 1e12 / (ceilings.hbm_gbps * 1e9), 4)
    if raw <= 0:
        return {"no_evidence": "achieved rate computed as zero"}
    return out


# program → wall family: every engine/serving program is either a
# prefill-regime forward (variable token width per dispatch; the port's
# are named ``*prefill*``) or a decode-regime step (the histograms below
# time exactly these dispatches)
_PREFILL_PROGRAMS = ("forward", "replicated_forward", "forward_with_taps")


def _wall_family(program: str) -> str:
    if program in _PREFILL_PROGRAMS or "prefill" in program:
        return "prefill"
    return "decode"


def _family_walls(reg, led_snap: dict) -> dict:
    """Steady-state mean dispatch wall per family, capture-corrected:
    the histograms record EVERY dispatch, including the one that rode
    each capture or first run — subtract the ledger's walls and counts
    so a cold server's means aren't mostly warm-up. Walls are
    process-global (the histograms are unlabeled), which is the honest
    grain: two engines' dispatches interleave on one chip."""
    from . import telemetry

    comp_ms = {"decode": 0.0, "prefill": 0.0}
    comp_n = {"decode": 0, "prefill": 0}
    for p in led_snap.get("programs", ()):
        fam = _wall_family(p["program"])
        comp_ms[fam] += p.get("total_compile_s", 0.0) * 1e3
        comp_n[fam] += p.get("compiles", 0)

    fams = {}
    hists = {"decode": (telemetry.DECODE_STEP_MS, telemetry.BATCH_STEP_MS),
             "prefill": (telemetry.PREFILL_CHUNK_MS,)}
    for fam, names in hists.items():
        s = sum(reg.histogram(n).sum() for n in names)
        c = sum(reg.histogram(n).count() for n in names)
        n_adj, s_adj = c - comp_n[fam], s - comp_ms[fam]
        if n_adj >= 1 and s_adj > 0:
            fams[fam] = {"wall_ms": s_adj / n_adj, "n_dispatches": n_adj,
                         "source": "+".join(names) + " (compile-corrected)"}
        elif c >= 1:
            fams[fam] = {"wall_ms": s / c, "n_dispatches": c,
                         "source": "+".join(names) + " (raw — too few "
                                   "dispatches to subtract compiles)"}
        else:
            fams[fam] = {"wall_ms": None, "n_dispatches": 0,
                         "source": "+".join(names)}
    if fams["prefill"]["wall_ms"] is None:
        # batched serving prefills through the generator's own chunk
        # dispatch (no engine-histogram record) but every chunk leaves a
        # `prefill_chunk` span in the always-on ring — the MEDIAN duration
        # is robust to the compile-inflated first chunk
        durs = sorted((sp["end_ns"] - sp["start_ns"]) / 1e6
                      for sp in telemetry.tracer().raw_spans()
                      if sp["phase"] == "prefill_chunk")
        if durs:
            fams["prefill"] = {"wall_ms": durs[len(durs) // 2],
                               "n_dispatches": len(durs),
                               "source": "prefill_chunk spans (median)"}
    return fams


def snapshot(*, ceilings: Ceilings | None = None, scope: str | None = None,
             publish: bool = True) -> dict:
    """The roofline observatory's one computation: join the compile
    ledger's per-program bytes/operations with the step-histogram walls
    against the card's ceilings. Pure host-side reads: it dispatches
    nothing, so it can never capture or run a program. ``publish`` also
    updates the three gauges so a ``/metrics`` scrape after any snapshot
    carries the same numbers."""
    from . import introspection, telemetry

    reg = telemetry.registry()
    ceil = ceilings or load_ceilings()
    led_snap = introspection.ledger().snapshot()
    walls = _family_walls(reg, led_snap)

    programs = []
    g_frac = reg.gauge(telemetry.ROOFLINE_FRACTION)
    g_bw = reg.gauge(telemetry.ACHIEVED_HBM_GBPS)
    g_fl = reg.gauge(telemetry.ACHIEVED_TFLOPS)
    best = None  # decode-family program with the largest measured bytes
    for p in led_snap.get("programs", ()):
        if scope is not None and p["scope"] != scope:
            continue
        analysis = p.get("analysis") or {}
        fam = _wall_family(p["program"])
        wall = walls[fam]
        entry = {"scope": p["scope"], "program": p["program"],
                 "family": fam, "wall_source": wall["source"],
                 "n_dispatches": wall["n_dispatches"]}
        if not analysis or "hbm_total_bytes" not in analysis:
            entry["no_evidence"] = ("compile-ledger analysis missing (the "
                                    "program was registered and never ran)")
            programs.append(entry)
            continue
        entry.update(attribute(analysis.get("hbm_total_bytes", 0),
                               analysis.get("flops", 0.0) or 0.0,
                               wall["wall_ms"], ceil))
        programs.append(entry)
        if "roofline_fraction" not in entry:
            continue
        if publish:
            labels = dict(scope=p["scope"], program=p["program"])
            g_frac.set(entry["roofline_fraction"], **labels)
            g_bw.set(entry["achieved_hbm_gbps"], **labels)
            g_fl.set(entry["achieved_tflops"], **labels)
        if fam == "decode" and (best is None
                                or entry["hbm_bytes"] > best["hbm_bytes"]):
            best = entry
    out = {"ceilings": asdict(ceil), "programs": programs}
    if best is not None:
        out["summary"] = {
            "program": best["program"], "scope": best["scope"],
            "roofline_fraction": best["roofline_fraction"],
            "achieved_hbm_gbps": best["achieved_hbm_gbps"],
            "achieved_tflops": best["achieved_tflops"],
            "bound": best["bound"],
        }
    return out


def stats_fraction() -> float | None:
    """The ``--stats`` fragment: the decode-program roofline fraction of
    the dominant (largest measured bytes) decode program, refreshing the
    gauges as a side effect. None while there is no evidence."""
    summary = snapshot(publish=True).get("summary")
    return summary["roofline_fraction"] if summary else None


def rate_roofline(tok_per_s: float, weight_gb: float,
                  ceilings: Ceilings) -> dict:
    """The classic decode roofline from a measured token rate and the
    weight bytes streamed per token (no ledger; the CLI's ``roofline:``
    line). The HBM roofline rate for a decode step that must stream every
    weight byte is ``ceiling_GBps / weight_GB`` tok/s; the fraction is the
    measured rate against it (clamped like :func:`attribute`)."""
    if (missing := _no_ceilings(ceilings)) is not None:
        return dict(missing, ceiling_source=ceilings.source)
    roof = ceilings.hbm_gbps / weight_gb if weight_gb > 0 else 0.0
    raw = tok_per_s / roof if roof > 0 else 0.0
    out = {
        "roofline_tok_per_s": round(roof, 1),
        "achieved_hbm_gbps": round(tok_per_s * weight_gb, 1),
        "roofline_fraction": round(min(1.0, raw), 4),
        "bound": "memory",
        "ceiling_source": ceilings.source,
        "ceiling_hbm_gbps": ceilings.hbm_gbps,
        "ceiling_tflops": ceilings.tflops,
    }
    if raw > 1.0:
        out["raw_fraction"] = round(raw, 4)
    return out


def rate_roofline_families(stage: dict, weight_gb: float, n_params: int,
                           ceilings: Ceilings) -> dict:
    """``roofline_fraction`` per program FAMILY (decode vs prefill vs
    paged) from one measured stage's rates — the same shape algebra as
    :func:`rate_roofline`, with first-class ``no_evidence`` for any family
    the stage never measured.

    * **decode** — memory-bound against the weight stream (the headline
      formula).
    * **prefill** — compute-bound: achieved TFLOP/s from ``2 * n_params``
      FLOPs per token against the compute ceiling (the classic MFU).
    * **paged** — the SAME weight-stream pricing as decode, applied to the
      block-table step: both families must stream every weight byte, so
      the paged fraction sitting below decode's is the overhead of the
      paged path."""
    fams: dict = {}
    v = stage.get("decode_tok_per_s")
    fams["decode"] = (rate_roofline(v, weight_gb, ceilings) if v
                      else {"no_evidence": "decode never measured"})
    v = stage.get("prefill_tok_per_s")
    if v:
        ach = v * 2.0 * n_params / 1e12
        raw = ach / ceilings.tflops if ceilings.tflops else 0.0
        rec = {"achieved_tflops": round(ach, 3),
               "roofline_fraction": round(min(1.0, raw), 4),
               "bound": "compute",
               "ceiling_source": ceilings.source,
               "ceiling_tflops": ceilings.tflops}
        if raw > 1.0:
            rec["raw_fraction"] = round(raw, 4)
        fams["prefill"] = rec
    else:
        fams["prefill"] = {"no_evidence": "prefill never measured"}
    v = stage.get("paged_decode_tok_per_s")
    fams["paged"] = (rate_roofline(v, weight_gb, ceilings) if v
                     else {"no_evidence": "paged decode never measured"})
    return fams
