"""Numerics observatory — the layer that watches the values (the port of
the JAX package's ``runtime/numerics.py``).

The stack is quantized end to end (Q40 weights, Q80 activation-sync casts)
and bets that those lossy representations stay quality-neutral. Four
instruments check it:

* **Activation-stat taps** — :func:`~dllama_tpu_torch.models.llama.forward`
  optionally returns per-layer stats (rms / abs-max / non-finite count /
  Q80 roundtrip error at ``attn_out``, ``mlp_out``, ``final_norm``,
  ``logits``). Behind an engine flag (``--numerics-taps``), read inside
  ``forward`` from a thread-local (:func:`taps_active`, armed by
  :func:`collecting_taps`), so the untapped forward runs no tap code. Taps
  run on prefill and canary forwards only; the stats come back in one
  readback per forward.
* **Non-finite tripwire** — every single-sequence and batched decode,
  chunk and verify step returns a per-row count of non-finite logits
  lanes, computed on the device inside the step (inside the captured
  graph on the card) and read back with its tokens. Always on; feeds
  ``dllama_nonfinite_total{site}``. Opt-in fail-fast
  (``--numerics-failfast``) turns a poisoned request into an explicit
  :class:`NumericsError` (HTTP 5xx naming the site) instead of garbage
  tokens. The ``logits`` failpoint drives it end to end
  (:func:`poison_code`): the step's poison selector is a device scalar
  written before each replay, never a value frozen at capture.
* **Quant-error audit** — ``python -m dllama_tpu_torch audit --model m.m``
  (:func:`audit_model`): offline, host-only per-tensor table of Q40/Q80
  reconstruction health (non-finite values, scale range, roundtrip SNR/MSE
  through the port's ``formats/quants.py`` codecs).
* **Golden canary drift sentinel** — :class:`CanarySentinel` replays a
  fixed-seed canary prompt through the engine's prefill forward on a
  scratch KV cache and compares greedy ids + a crc32 of the last
  position's logits against the recorded golden, bit for bit. Drift
  increments ``dllama_canary_drift_total`` and the warning names the first
  divergent layer when the taps are on. Driven by the batch scheduler's
  tick (and after single-sequence completions); surfaced via ``GET
  /debug/numerics`` and the ``--stats`` ``drift=N!`` marker.

The JAX package's ``wire`` failpoint poisons the quantized ring
collective's shipped partial (codes >= 3 of the same selector); those
collectives are not ported yet, so :func:`poison_code` fires ``logits``
only and the codes >= 3 pass the logits through clean.
"""

from __future__ import annotations

import math
import os
import threading
import zlib
from contextlib import contextmanager

import numpy as np

from . import failpoints, telemetry

#: tap sites in model order — layer-stacked sites first, then the head
TAP_SITES = ("attn_out", "mlp_out", "final_norm", "logits")

#: the per-site statistics of a tap, in the order a tap tensor stacks them
TAP_STATS = ("rms", "absmax", "nonfinite", "q80_err")

#: tripwire sites (the dispatch families that carry the check)
TRIPWIRE_SITES = ("decode", "batch", "verify", "prefill", "canary")


class NumericsError(RuntimeError):
    """Non-finite values on a decode path with fail-fast armed: the request
    dies with a named site instead of emitting garbage tokens (HTTP 5xx in
    the serving layers)."""


def nonfinite_error(site: str, count: int) -> NumericsError:
    """The one spelling of the fail-fast error, so every layer (engine,
    batched serving, HTTP) names the site the same way."""
    return NumericsError(
        f"non-finite values in decode-step logits (site={site}, {count} lanes) "
        f"— numerics fail-fast is armed (--numerics-failfast); see /debug/numerics")


# -- tap flag -------------------------------------------------------------------

_tls = threading.local()


def taps_active() -> bool:
    """Whether the current forward collects activation taps (read inside
    ``models.llama.forward``)."""
    return getattr(_tls, "taps", False)


@contextmanager
def collecting_taps():
    """Arm the tap flag for the enclosed forward
    (``models.llama.forward_with_taps`` wraps its forward call in this)."""
    prev = getattr(_tls, "taps", False)
    _tls.taps = True
    try:
        yield
    finally:
        _tls.taps = prev


# -- non-finite tripwire --------------------------------------------------------

# the steps' poison selector values (models.llama._poison_logits): the
# `logits` failpoint's `nonfinite` action returns the mode string and the
# dispatch writes the matching code into the step's device scalar — 0.0 is
# clean
POISON_CODES = {"nan": 1.0, "inf": 2.0}

# the JAX package's `wire` failpoint codes ride the same selector in a
# disjoint range (>= 3 poisons the quantized ring collective's partial, not
# the logits); kept for the selector's contract, fired once the quantized
# collectives are ported
WIRE_POISON_CODES = {"nan": 3.0, "inf": 4.0}

# module state for GET /debug/numerics: last counts per site + last taps
_state_lock = threading.Lock()
_last_nonfinite: dict[str, int] = {}
_last_taps: dict | None = None


def poison_code() -> float:
    """Fire the ``logits`` failpoint for this dispatch; returns the poison
    code its step writes into the logits (0.0 = clean, 1.0 NaN, 2.0 +Inf).
    Raise-type actions armed on the site propagate as usual."""
    mode = failpoints.fire("logits")
    if mode:
        return POISON_CODES.get(str(mode), POISON_CODES["nan"])
    return 0.0


def record_nonfinite(count: int, site: str) -> None:
    """Count one non-finite tripwire event (``count`` > 0 affected lanes at
    ``site``) into ``dllama_nonfinite_total{site}`` and the debug state.
    One increment per event, not per lane: the counter is an alarm rate,
    the lane count lives in the error and debug detail."""
    telemetry.registry().counter(telemetry.NONFINITE).inc(site=site)
    with _state_lock:
        _last_nonfinite[site] = int(count)


def check_nonfinite(count, site: str, *, failfast: bool = False) -> int:
    """Host-side tripwire tail of the engine paths: ``count`` is the step's
    per-row non-finite count (array or scalar, already on the host). Returns
    the total; records and optionally fails fast when nonzero."""
    n = int(np.sum(np.asarray(count)))
    if n > 0:
        record_nonfinite(n, site)
        if failfast:
            raise nonfinite_error(site, n)
    return n


# -- activation-stat taps (host side) ------------------------------------------


def taps_to_host(taps: dict) -> dict:
    """A tapped forward's stats (``{site: [..., 4] tensor}`` in
    :data:`TAP_STATS` order, the layer sites ``[L, 4]``) as the JAX
    package's per-site dicts of numpy leaves, in one device→host copy."""
    import torch

    sites = list(taps)
    flat = torch.cat([taps[s].reshape(-1, len(TAP_STATS)) for s in sites]).cpu().numpy()
    out, i = {}, 0
    for s in sites:
        n = taps[s].reshape(-1, len(TAP_STATS)).shape[0]
        rows = flat[i:i + n]
        i += n
        layered = taps[s].dim() > 1
        st = {}
        for j, name in enumerate(TAP_STATS):
            col = rows[:, j] if layered else rows[0, j]
            st[name] = (np.asarray(col, np.int64) if name == "nonfinite"
                        else np.asarray(col, np.float32))
        out[s] = st
    return out


def record_taps(taps: dict, *, site_prefix: str = "") -> dict:
    """Publish one tapped dispatch's stats (numpy leaves, from
    :func:`taps_to_host`): per-site gauges (rms of the last layer, abs-max
    and Q80 roundtrip error maxed over layers), the non-finite counter per
    site, and the per-layer detail kept for ``GET /debug/numerics``.
    Returns the summarized dict."""
    reg = telemetry.registry()
    summary: dict = {}
    for site, st in taps.items():
        rms = np.atleast_1d(np.asarray(st["rms"], np.float64))
        absmax = np.atleast_1d(np.asarray(st["absmax"], np.float64))
        nf = int(np.sum(np.asarray(st["nonfinite"])))
        q80 = np.atleast_1d(np.asarray(st["q80_err"], np.float64))
        label = site_prefix + site
        reg.gauge(telemetry.ACTIVATION_RMS).set(float(rms[-1]), site=label)
        reg.gauge(telemetry.ACTIVATION_ABSMAX).set(float(absmax.max()), site=label)
        reg.gauge(telemetry.Q80_ROUNDTRIP_ERROR).set(float(q80.max()), site=label)
        if nf > 0:
            record_nonfinite(nf, "taps")
        summary[site] = {
            "rms": [float(v) for v in rms],
            "absmax": [float(v) for v in absmax],
            "nonfinite": nf,
            "q80_err": [float(v) for v in q80],
        }
    global _last_taps
    with _state_lock:
        _last_taps = summary
    return summary


def first_divergent_layer(taps: dict, golden: dict, rtol: float = 1e-3) -> str | None:
    """Name the first (layer, site) whose tapped rms deviates from the
    golden's beyond ``rtol`` — model order: per layer, attn_out before
    mlp_out, then the head sites. None when every site agrees."""
    layered = [s for s in ("attn_out", "mlp_out") if s in taps and s in golden]
    if layered:
        n_layers = len(taps[layered[0]]["rms"])
        for layer in range(n_layers):
            for site in layered:
                a = taps[site]["rms"][layer]
                b = golden[site]["rms"][layer]
                if not math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9):
                    return f"layer {layer} ({site})"
    for site in ("final_norm", "logits"):
        if site in taps and site in golden:
            a, b = taps[site]["rms"][0], golden[site]["rms"][0]
            if not math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9):
                return site
    return None


# -- golden canary drift sentinel -----------------------------------------------


class CanarySentinel:
    """Fixed-seed canary replay + golden comparison for one engine.

    The canary prompt is ``width`` random token ids (fixed seed) at the
    engine's smallest prefill bucket width, run through the engine's
    prefill forward (the tapped one when taps are on) at position 0 on a
    fresh scratch KV cache of the engine's geometry: engine position,
    sampler RNG and serving state are untouched, and every replay runs the
    same kernels at the same shapes (K1 at M = width, K3 over the cache's
    rows), so a replay on healthy weights reproduces the golden bit for
    bit — the kernels use no atomics and their split counts come from
    shapes alone.

    Drift = greedy token ids OR the crc32 of the last position's logits
    differing from the recorded golden. Each drift increments
    ``dllama_canary_drift_total`` and warns; with taps on, the warning
    names the first divergent layer from the per-layer rms comparison.
    """

    def __init__(self, engine, interval_s: float = 60.0, seed: int = 0xCA7A):
        if getattr(engine, "multihost", False):
            raise ValueError("the canary sentinel is single-host only (its scratch "
                             "dispatches are not broadcast to worker mirrors)")
        self.eng = engine
        self.interval_s = interval_s
        width = engine.prefill_buckets[-1]
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, engine.cfg.vocab_size, size=(1, width)).astype(np.int64)
        self.golden: dict | None = None
        self._last_run = 0.0
        # _lock guards only the bookkeeping (status() must answer while a
        # replay is in flight); _replay_lock serializes the dispatches
        self._lock = threading.Lock()
        self._replay_lock = threading.Lock()
        self.runs = 0
        self.drifts = 0
        self.last: dict | None = None

    # -- the replay dispatch ---------------------------------------------------

    def _replay(self):
        """One canary forward on a scratch KV cache; returns ``(logits [T,
        vocab] np, taps summary | None)``."""
        import torch

        from ..models.llama import forward, forward_with_taps

        eng = self.eng
        kv = eng._fresh_kv()
        tokens = torch.from_numpy(self.tokens).to(eng.device)
        with eng.watchdog.guard("canary"):
            if eng.numerics_taps:
                (logits, taps), _ = forward_with_taps(eng.params, eng.cfg, tokens, 0, kv,
                                                      eng.plan)
                taps = taps_to_host(taps)
            else:
                logits, _ = forward(eng.params, eng.cfg, tokens, 0, kv, eng.plan)
                taps = None
            row = logits[0].float().cpu().numpy()
        del kv
        if taps is not None:
            taps = record_taps(taps)
        # direct non-finite signal on the replayed logits (site=canary): a
        # NaN burst during a replay must not surface only as fingerprint
        # drift. Count-only: a fail-fast here would kill the sentinel itself
        bad = int(row.size - np.count_nonzero(np.isfinite(row)))
        if bad:
            record_nonfinite(bad, "canary")
        return row, taps

    @staticmethod
    def _fingerprint(logits: np.ndarray) -> tuple[list[int], int]:
        ids = [int(t) for t in np.argmax(logits, axis=-1)]
        crc = zlib.crc32(np.ascontiguousarray(logits[-1], np.float32).tobytes())
        return ids, crc

    def ensure_golden(self) -> dict:
        """Record the golden on the first call (at server startup, before
        serving traffic). A golden recording is a run: same accounting."""
        with self._lock:
            golden = self.golden
        if golden is None:
            self.run()
            with self._lock:
                golden = self.golden
        return golden

    def maybe_run(self) -> dict | None:
        """Time-gated replay (the scheduler-tick / post-completion hook):
        no-op until ``interval_s`` has elapsed since the last run."""
        now = telemetry.now_ns() / 1e9
        with self._lock:
            if self.golden is not None and now - self._last_run < self.interval_s:
                return None
        return self.run()

    def run(self) -> dict:
        """One canary replay + golden comparison; the very first call
        records the golden instead of comparing. The dispatch runs under
        ``_replay_lock`` only, so :meth:`status` never blocks behind it."""
        reg = telemetry.registry()
        with self._replay_lock:
            logits, taps = self._replay()
            ids, crc = self._fingerprint(logits)
            with self._lock:
                # the interval starts at the replay, golden or not
                self._last_run = telemetry.now_ns() / 1e9
                self.runs += 1
                reg.counter(telemetry.CANARY_RUNS).inc()
                if self.golden is None:
                    self.golden = {"token_ids": ids, "logits_crc": crc, "taps": taps}
                    self.last = {"drift": False, "golden_recorded": True}
                    return self.last
                golden = self.golden
            token_drift = ids != golden["token_ids"]
            crc_drift = crc != golden["logits_crc"]
            result: dict = {"drift": bool(token_drift or crc_drift),
                            "token_drift": bool(token_drift),
                            "fingerprint_drift": bool(crc_drift),
                            "divergent_layer": None}
            if result["drift"]:
                reg.counter(telemetry.CANARY_DRIFT).inc()
                if taps is not None and golden.get("taps") is not None:
                    result["divergent_layer"] = first_divergent_layer(taps, golden["taps"])
                where = (result["divergent_layer"]
                         or "unknown (enable --numerics-taps for layer attribution)")
                print(f"⚠️ canary drift: fixed-seed replay diverged from the recorded "
                      f"golden (tokens {'differ' if token_drift else 'match'}, logit "
                      f"fingerprint {'differs' if crc_drift else 'matches'}) — first "
                      f"divergent: {where}", flush=True)
            with self._lock:
                if result["drift"]:
                    self.drifts += 1
                self.last = result
            return result

    def status(self) -> dict:
        """JSON-able state for ``GET /debug/numerics``."""
        with self._lock:
            return {
                "golden_recorded": self.golden is not None,
                "interval_s": self.interval_s,
                "canary_width": int(self.tokens.shape[1]),
                "runs": self.runs,
                "drifts": self.drifts,
                "last": self.last,
            }


# -- offline quant-error audit --------------------------------------------------


# elements scored at a time: a slice's temporaries stay in the core's cache
_AUDIT_SLICE = 1 << 18


def _snr_db(sig: float, err: float) -> float:
    """10·log10(signal/error) power ratio from the two sums of squares; inf
    when the roundtrip is exact, 0.0 for an all-zero signal."""
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return 0.0
    return 10.0 * math.log10(sig / err)


def audit_tensor(key: str, rec, buf, *, dense: np.ndarray) -> dict:
    """One audit row: reconstruction health + roundtrip error of one tensor.
    ``dense`` is the reference-dequantized f32 flat array. Scored in
    block-aligned slices of :data:`_AUDIT_SLICE` elements, the sums of
    squares added in float64 (the JAX module sums the whole tensor at once:
    the same values to ~1e-16 relative)."""
    from ..formats import quants as q

    n = dense.size
    nf, absmax, sumsq = 0, 0.0, 0.0
    for a in range(0, n, _AUDIT_SLICE):
        x = dense[a:a + _AUDIT_SLICE]
        finite = np.isfinite(x)
        bad = x.size - int(np.count_nonzero(finite))
        if bad:
            nf += bad
            x = x[finite]
        if x.size:
            absmax = max(absmax, float(np.max(np.abs(x))))
            sumsq += float(np.sum(np.square(x, dtype=np.float64)))
    row: dict = {
        "tensor": key,
        "type": q.FLOAT_TYPE_NAMES.get(rec.float_type, str(rec.float_type)),
        "n": int(n),
        "nonfinite": nf,
        "absmax": absmax,
        "rms": math.sqrt(sumsq / (n - nf)) if n - nf else 0.0,
    }
    if rec.float_type in (q.Q40, q.Q80):
        per = q.Q40_BLOCK_BYTES if rec.float_type == q.Q40 else q.Q80_BLOCK_BYTES
        nb = n // q.QUANT_BLOCK_SIZE
        raw = np.frombuffer(buf, dtype=np.uint8, count=nb * per).reshape(nb, per)
        s = raw[:, 0:2].copy().view(np.float16).reshape(-1).astype(np.float32)
        row["scale_nonfinite"] = int(np.sum(~np.isfinite(s)))
        sf = s[np.isfinite(s)]
        row["scale_absmax"] = float(np.max(np.abs(sf))) if sf.size else 0.0
    if nf == 0 and n and n % q.QUANT_BLOCK_SIZE == 0:
        # Q40 roundtrip of the reference-dequantized values: for dense
        # tensors what Q40-quantizing them would cost; for quantized ones a
        # self-consistency check (healthy blocks re-encode near-exactly). An
        # exact roundtrip stores SNR as None + q40_exact (inf is not JSON)
        err40 = err80 = 0.0
        for a in range(0, n, _AUDIT_SLICE):
            x = dense[a:a + _AUDIT_SLICE]
            y = q.dequantize_q40(q.quantize_q40(x), x.size)
            err40 += float(np.sum(np.square((x - y).astype(np.float64))))
            if rec.float_type == q.Q80:
                y = q.dequantize_q80(q.quantize_q80(x), x.size)
                err80 += float(np.sum(np.square((x - y).astype(np.float64))))
        row["q40_mse"] = err40 / n
        snr = _snr_db(sumsq, err40)
        row["q40_exact"] = math.isinf(snr)
        row["q40_snr_db"] = None if math.isinf(snr) else snr
        if rec.float_type == q.Q80:
            snr80 = _snr_db(sumsq, err80)
            row["q80_snr_db"] = None if math.isinf(snr80) else snr80
    return row


def audit_model(path: str, emit=None) -> dict:
    """Offline per-tensor quant-error audit (``python -m dllama_tpu_torch
    audit --model m.m``). Host only — no torch device: every tensor is
    reference-dequantized (``formats/quants.py``) and scored, on a thread
    per host core (numpy releases the GIL in its loops; the largest
    tensors start first, the rows keep the file's order).
    Publishes ``dllama_quant_audit_min_snr_db`` /
    ``dllama_quant_audit_nonfinite_total`` and returns ``{"rows": [...],
    "nonfinite_tensors": [...], "min_snr_db": ...}``."""
    from concurrent.futures import ThreadPoolExecutor

    from ..formats.mfile import ModelFile

    with ModelFile.open(path) as mf:
        def score(key: str) -> dict:
            dense = np.asarray(mf.tensor_f32(key), np.float32).reshape(-1)
            return audit_tensor(key, mf.tensors[key], mf.raw(key), dense=dense)

        by_size = sorted(mf.tensors, key=lambda k: -mf.tensors[k].n_bytes)
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            done = dict(zip(by_size, pool.map(score, by_size)))
        rows = [done[key] for key in mf.tensors]
    bad = [r["tensor"] for r in rows if r["nonfinite"] or r.get("scale_nonfinite")]
    snrs = [r["q40_snr_db"] for r in rows if r.get("q40_snr_db") is not None]
    min_snr = min(snrs) if snrs else float("inf")
    total_nf = sum(r["nonfinite"] for r in rows)
    reg = telemetry.registry()
    reg.gauge(telemetry.QUANT_AUDIT_MIN_SNR).set(0.0 if math.isinf(min_snr) else min_snr)
    if total_nf:
        reg.counter(telemetry.QUANT_AUDIT_NONFINITE).inc(total_nf)
    out = {"model": str(path), "tensors": len(rows), "rows": rows,
           "nonfinite_tensors": bad,
           "min_snr_db": None if math.isinf(min_snr) else min_snr}
    if emit is not None:
        emit(f"🔬 quant audit: {path} ({len(rows)} tensors)")
        emit(f"{'tensor':34s} {'type':5s} {'nonfin':>6s} {'absmax':>10s} "
             f"{'rms':>10s} {'q40 snr dB':>10s}")
        for r in rows:
            snr = r.get("q40_snr_db")
            snr_s = ("exact" if r.get("q40_exact")
                     else f"{snr:.1f}" if snr is not None else "-")
            emit(f"{r['tensor']:34s} {r['type']:5s} {r['nonfinite']:6d} "
                 f"{r['absmax']:10.4g} {r['rms']:10.4g} {snr_s:>10s}")
        if bad:
            emit(f"❌ non-finite values in {len(bad)} tensor(s): " + ", ".join(bad))
        else:
            emit("✅ no non-finite values; worst Q40 roundtrip SNR "
                 + ("exact" if out["min_snr_db"] is None
                    else f"{out['min_snr_db']:.1f} dB"))
    return out


# -- GET /debug/numerics ----------------------------------------------------------


def debug_snapshot(engine=None) -> dict:
    """JSON-able observatory state: tripwire totals per site, the last
    tapped dispatch's per-layer stats, and the canary status."""
    reg = telemetry.registry()
    nf = reg.counter(telemetry.NONFINITE)
    with _state_lock:
        taps = _last_taps
        last_counts = dict(_last_nonfinite)
    canary = getattr(engine, "canary", None) if engine is not None else None
    return {
        "nonfinite_total": nf.total(),
        "nonfinite_by_site": {s: nf.total(site=s) for s in TRIPWIRE_SITES + ("taps",)
                              if nf.total(site=s)},
        "last_nonfinite_lanes": last_counts,
        "failfast": bool(getattr(engine, "nf_failfast", False)),
        "taps_enabled": bool(getattr(engine, "numerics_taps", False)),
        "taps": taps,
        "canary": canary.status() if canary is not None else None,
        "canary_drift_total": reg.counter(telemetry.CANARY_DRIFT).total(),
    }
