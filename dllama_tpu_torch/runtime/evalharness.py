"""Quality observatory: batched teacher-forced eval over the serving stack
(the port of the JAX package's ``runtime/evalharness.py``).

It scores a JSONL dataset teacher-forced — per-token negative
log-likelihood of each next token given its prefix — through the real
serving machinery, two ways:

* **single** — the engine oracle: :meth:`InferenceEngine.score_nll`
  chunks each sequence through ``models.llama.prefill_nll`` (the forward
  with a fused log-softmax-gather epilogue, so only ``[B, T]`` NLL values
  leave the device).
* **dense** / **paged** / **paged_spec** — many eval sequences admitted
  through ``BatchScheduler`` as continuous-batching work
  (``Request.score``): the same function, the same chunk boundaries, the
  same zero padding and the same kernels at the same shapes (K1 at the
  chunk width, K3 over a column of ``padded_cache_len(seq_len)`` rows),
  which is what makes the batched totals **bit-identical** to the
  oracle's.

Sums are canonical: each sequence's float32 NLL values accumulate into a
float64 sum in position order; the run total sums the per-sequence sums
in dataset order. Exact totals travel as ``float.hex()`` strings, so
parity comparisons are bit-level, never tolerance-level.

A mid-run failure (scheduler crash, the ``eval`` failpoint) never yields a
silently truncated perplexity: :class:`EvalAborted` carries a
partial-results summary naming completed and in-flight sequences, and the
CLI exits non-zero with that JSON.
"""
from __future__ import annotations

import json
import math
import threading
import time

import numpy as np

from . import failpoints, flightrec, telemetry

# per-sequence wait bound in the batched path: generous (the first chunk of
# each width on the card builds nothing, but a full-width model scores a
# long dataset in minutes) but finite, so a wedged run aborts with a
# partial instead of hanging the harness
DEFAULT_TIMEOUT_S = 900.0


class EvalAborted(RuntimeError):
    """A mid-run eval failure. ``partial`` is the partial-results summary
    (``completed`` / ``in_flight`` sequence ids + the scored entries so
    far) — the loud alternative to a truncated perplexity."""

    def __init__(self, msg: str, partial: dict):
        super().__init__(msg)
        self.partial = partial


# -- dataset ------------------------------------------------------------------


def load_dataset(path: str, tokenizer=None, *, seq_len: int = 0) -> list[dict]:
    """Load a JSONL eval dataset: one object per line with ``tokens`` (a
    token-id list) or ``text`` (encoded with ``tokenizer``), plus an
    optional ``id``. Sequences are clipped to ``seq_len`` when given;
    anything shorter than 2 tokens (no next token to predict) is rejected."""
    seqs: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            if "tokens" in obj:
                ids = [int(t) for t in obj["tokens"]]
            elif "text" in obj:
                if tokenizer is None:
                    raise ValueError(f"{path}:{lineno}: 'text' entry needs a tokenizer "
                                     f"(model has none loaded)")
                ids = list(tokenizer.encode(obj["text"]))
            else:
                raise ValueError(f"{path}:{lineno}: entry has neither 'tokens' nor 'text'")
            if seq_len:
                ids = ids[:seq_len]
            if len(ids) < 2:
                raise ValueError(f"{path}:{lineno}: sequence has {len(ids)} token(s); "
                                 f"teacher-forced scoring needs at least 2")
            seqs.append({"id": str(obj.get("id", f"seq{len(seqs)}")), "tokens": ids})
    if not seqs:
        raise ValueError(f"{path}: empty eval dataset")
    return seqs


# -- summaries ----------------------------------------------------------------


def _seq_entry(sid: str, vals: np.ndarray) -> dict:
    nll = float(np.asarray(vals, dtype=np.float64).sum())
    return {"id": sid, "n_tokens": int(vals.size), "nll": nll, "nll_hex": nll.hex()}


def _summarize(entries: list[dict], *, dataset: str, config: str, wall_s: float) -> dict:
    """Fold per-sequence entries into the run summary, in dataset order (the
    canonical summation order, identical across configs by construction).
    Publishes the ``dllama_eval_*`` family."""
    total = 0.0
    n_tok = 0
    for e in entries:
        total += e["nll"]
        n_tok += e["n_tokens"]
    ppl = math.exp(total / n_tok) if n_tok else float("nan")
    summary = {
        "dataset": dataset,
        "config": config,
        "n_seqs": len(entries),
        "n_tokens": n_tok,
        "total_nll": total,
        "total_nll_hex": float(total).hex(),
        "perplexity": ppl,
        "wall_s": round(wall_s, 3),
        "eval_tok_per_s": round(n_tok / wall_s, 2) if wall_s > 0 else 0.0,
        "partial": False,
        "seqs": entries,
    }
    reg = telemetry.registry()
    reg.counter(telemetry.EVAL_TOKENS).inc(n_tok, dataset=dataset, config=config)
    reg.counter(telemetry.EVAL_NLL).inc(total, dataset=dataset, config=config)
    reg.gauge(telemetry.EVAL_PERPLEXITY).set(ppl, dataset=dataset)
    set_last_run(summary)
    return summary


def _partial(entries: list[dict], seqs: list[dict], *, dataset: str, config: str,
             error: str) -> dict:
    done_ids = [e["id"] for e in entries]
    partial = {
        "dataset": dataset,
        "config": config,
        "partial": True,
        "error": error,
        "completed": done_ids,
        "in_flight": [s["id"] for s in seqs if s["id"] not in set(done_ids)],
        "seqs": entries,
    }
    set_last_run(partial)
    return partial


# -- scoring paths ------------------------------------------------------------


def score_single(engine, seqs: list[dict], *, dataset: str, config: str = "single") -> dict:
    """The single-sequence oracle: every sequence through
    :meth:`InferenceEngine.score_nll`, one ``eval`` span and flight decision
    per sequence so eval traffic is timeline-attributable."""
    flight = flightrec.recorder()
    entries: list[dict] = []
    t_run = time.perf_counter()
    for i, seq in enumerate(seqs):
        t0 = telemetry.now_ns()
        try:
            failpoints.fire("eval")
            vals = engine.score_nll(seq["tokens"])
        except Exception as e:  # noqa: BLE001 — partial, then loud
            raise EvalAborted(
                f"eval aborted on sequence {seq['id']!r}: {e}",
                _partial(entries, seqs, dataset=dataset, config=config,
                         error=str(e))) from e
        telemetry.tracer().emit(i, "eval", t0, telemetry.now_ns(), n_tokens=int(vals.size))
        flight.note("eval_done", i, n_tokens=int(vals.size))
        entries.append(_seq_entry(seq["id"], vals))
    return _summarize(entries, dataset=dataset, config=config,
                      wall_s=time.perf_counter() - t_run)


def score_batched(sched, seqs: list[dict], *, dataset: str, config: str,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Eval sequences as continuous-batching work: all submitted up front
    (``Request.score`` routes each admission's chunks through
    ``prefill_nll``; the scheduler interleaves them like any other traffic),
    then reaped in dataset order. Any failed or timed-out request aborts the
    run with a partial, never a silent truncation."""
    reqs = []
    entries: list[dict] = []
    t_run = time.perf_counter()
    try:
        for seq in seqs:
            failpoints.fire("eval")
            reqs.append(sched.submit(seq["tokens"], 0, score=True))
    except Exception as e:  # noqa: BLE001 — partial, then loud
        raise EvalAborted(
            f"eval submit failed after {len(reqs)}/{len(seqs)} sequences: {e}",
            _partial(entries, seqs, dataset=dataset, config=config, error=str(e))) from e
    for seq, req in zip(seqs, reqs):
        ok = req.done.wait(timeout=timeout_s)
        err = (req.error if req.error
               else None if ok
               else f"timed out after {timeout_s:.0f}s")
        if err is None and not req.nll_parts and len(seq["tokens"]) > 1:
            # a retire with no scored chunks (a crash's fail-all raced the
            # done flag) must not count as a zero-NLL sequence
            err = "sequence retired without scored chunks"
        if err is not None:
            raise EvalAborted(
                f"eval aborted on sequence {seq['id']!r}: {err}",
                _partial(entries, seqs, dataset=dataset, config=config, error=err))
        vals = (np.concatenate(req.nll_parts) if req.nll_parts
                else np.zeros(0, dtype=np.float32))
        entries.append(_seq_entry(seq["id"], vals))
    return _summarize(entries, dataset=dataset, config=config,
                      wall_s=time.perf_counter() - t_run)


def run_eval(seqs: list[dict], *, dataset: str, config: str, engine=None, sched=None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Score ``seqs`` under ``config`` (one of ``telemetry.EVAL_CONFIGS``):
    ``single`` needs ``engine``; the batched configs need ``sched``."""
    if config not in telemetry.EVAL_CONFIGS:
        raise ValueError(f"unknown eval config {config!r} "
                         f"(choices: {telemetry.EVAL_CONFIGS})")
    if config == "single":
        if engine is None:
            raise ValueError("config 'single' needs engine=")
        return score_single(engine, seqs, dataset=dataset)
    if sched is None:
        raise ValueError(f"config {config!r} needs sched=")
    return score_batched(sched, seqs, dataset=dataset, config=config, timeout_s=timeout_s)


# -- last-run store (GET /debug/eval) -----------------------------------------

_last_lock = threading.Lock()
_last_run: dict | None = None


def set_last_run(summary: dict) -> None:
    """Publish a run (or partial) summary for ``GET /debug/eval``."""
    global _last_run
    with _last_lock:
        _last_run = summary


def last_run() -> dict | None:
    """The most recent eval summary scored in this process, else None."""
    with _last_lock:
        return _last_run
