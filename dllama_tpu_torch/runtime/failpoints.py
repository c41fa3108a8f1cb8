"""Fault-injection registry — named failpoints for chaos testing (the port
of the JAX package's ``runtime/failpoints.py``; the registry, the spec
grammar and the actions are the JAX package's, letter for letter).

The serving stack's failure semantics (scheduler supervision, load
shedding, deadline cancellation, drain — runtime/serving.py, serve/api.py)
are only trustworthy if every path can be *driven*, not just reasoned
about. This module is the driver: a telemetry-style process-global
registry of named failpoints. Production code calls
:func:`fire` at its injection sites; a disarmed site costs one attribute
read + one dict bool check (no lock), so the hooks stay in the hot path
permanently — the same always-on philosophy as the metrics registry.

Arming is programmatic (tests: ``failpoints.arm("step", times=1)``) or
via the environment for operator-driven game days::

    DLLAMA_FAILPOINTS=step:raise,emit:broken_pipe python -m dllama_tpu_torch api ...

Spec grammar: ``name:action[:times]`` joined by commas. Actions map to
exception types (``raise`` → :class:`FailpointError`, ``broken_pipe`` →
``BrokenPipeError``, ``conn_reset`` → ``ConnectionResetError``,
``oserror`` → ``OSError``, ``short_read`` → :class:`ShortReadError`, an
``OSError`` so the loader's transient-retry path treats it as such) —
except ``sleep``, which does not raise at all: the armed site blocks for
``delay_s`` seconds (default 30; programmatic ``arm(..., delay_s=...)``
overrides), simulating a wedged device dispatch for the step watchdog —
and ``nonfinite``, which neither raises nor blocks: :func:`fire` RETURNS
the poison mode (``"nan"`` default; programmatic ``arm(..., mode="inf")``
selects Inf) and the call site injects it into the dispatch (the
``logits`` site ships it as a traced scalar that poisons the decode-step
logits in-graph, driving the numerics tripwire end to end —
runtime/numerics.py).
``times`` bounds how often the point fires (default: every hit). Every
fire increments ``dllama_failpoints_fired_total{name=...}`` so chaos
tests assert injection *and* recovery through the same telemetry
registry.

Site registry (the JAX package's closed world). The port fires ``step``,
``admit``, ``emit``, ``load_read``, ``step_hang``, ``kv_alloc`` and
``draft`` at the JAX package's sites; ``logits`` and ``wire`` come with
the numerics tripwire, ``spill``/``pagein`` with the host KV tier,
``proxy``/``resume`` with the fleet router, ``kvwire`` with KV migration
and ``eval`` with the eval harness. In the port every site sits in host
code: ``step_hang`` inside the guard around a graph replay and its
readback, never inside a captured step.

* ``step`` — the batch scheduler's decode dispatch (supervised: a raise
  here exercises crash → fail-all → restart).
* ``admit`` — slot admission (exercises the per-request reject path).
* ``emit`` — the HTTP SSE write (a ``broken_pipe`` here exercises the
  client-disconnect accounting).
* ``load_read`` — the streaming weight loader's per-tensor read callback
  (``runtime/weights.py``; ``short_read``/``oserror`` exercise the
  bounded-retry path, ``raise`` the atomic load-failure path).
* ``step_hang`` — inside every watchdog-guarded device dispatch (engine
  and batched generator; the ``sleep`` action simulates a wedged XLA
  dispatch and exercises the step-watchdog trip).
* ``logits`` — the decode-step logits poison selector
  (``runtime/numerics.poison_code``, read by every guarded decode
  dispatch): the ``nonfinite`` action injects NaN/Inf into the
  decode-step logits in-graph, exercising the non-finite tripwire and
  its opt-in fail-fast.
* ``kv_alloc`` — the paged KV block allocator (``runtime/kvblocks.py
  BlockPool.alloc``): a ``raise`` here simulates block-pool exhaustion,
  which must degrade to queueing (admission) or an explicit per-request
  failure (mid-decode growth), never a crash.
* ``spill`` — the KV tier's device→host spill executor
  (``runtime/serving.py PagedGenerator._exec_spill``, fired before the
  batched copy): a ``raise`` simulates a failed spill, which must
  DEGRADE to the pre-tier drop-evict contract (cached content lost,
  allocation proceeds, requeue/503 semantics unchanged) — never a crash
  and never a failed request.
* ``pagein`` — the KV tier's host→device page-in executor
  (``runtime/serving.py PagedGenerator._exec_pagein``, fired before the
  restore copy): a ``raise`` fails ONLY the resuming request
  (503-shaped ``PageInError``; host copies stay intact for a retry),
  bystander slots keep decoding token-intact.
* ``draft`` — the speculative proposer's draft call
  (``runtime/serving.py _GeneratorCore._safe_draft``, fired per slot
  per verify tick): a ``raise`` simulates a poisoned/crashing proposer,
  which must DEGRADE that slot to plain decode for the step
  (``dllama_spec_degraded_total``; the request completes, bystanders
  untouched), never fail the request or the batch.
* ``proxy`` — the fleet router's upstream dispatch point
  (``serve/router.py`` ``_open_upstream``, fired per upstream request
  before any bytes move): a ``conn_reset``/``broken_pipe``/``raise``
  severs the replica connection deterministically, driving the
  retry-on-another-replica and circuit-breaker paths end to end
  (tests/test_router.py).
* ``kvwire`` — the KV-migration wire's per-frame receive point
  (``runtime/kvwire.py read_frames``, fired before each frame read on
  the import side): ``raise`` severs the transfer like a peer death
  (fallback reason ``peer_death``), ``short_read`` truncates the frame
  so it fails integrity verification (fallback reason ``crc``), and
  ``sleep`` stalls the stream past the per-transfer deadline (fallback
  reason ``timeout``). Every action must end in the destination
  rolling back its staged blocks and recomputing the prefix locally —
  never in a user-visible failure.
* ``wire`` — the overlapped wire collectives' shipped partial
  (``runtime/numerics.poison_code``, injected in-graph by
  ``parallel/qcollectives._maybe_poison_partial``): the ``nonfinite``
  action corrupts THIS device's ring-hop payload for batch row 0 only
  (NaN/Inf per the mode), proving a dropped/corrupt quantized hop trips
  the non-finite tripwire and fails only the affected request,
  503-shaped. Requires a trace that contains the ring collectives
  (``--comm-overlap`` on a tp mesh).
* ``resume`` — the fleet router's mid-stream failover re-dispatch
  (``serve/router.py`` ``_resume_stream``, fired once per spliced
  continuation before the resume target is contacted): a
  ``conn_reset``/``broken_pipe``/``raise`` kills the re-dispatch
  exactly where a dying resume target would, driving the bounded
  resume budget to its terminal SSE 502 while bystander streams stay
  token-intact (tests/test_chaos.py).
* ``eval`` — the quality observatory's per-sequence scoring point
  (``runtime/evalharness.py``, fired once per eval sequence as the
  harness submits/scores it): a ``raise`` aborts the run mid-dataset,
  which must surface as :class:`~.evalharness.EvalAborted` carrying a
  partial-results summary naming completed vs in-flight sequences —
  the eval CLI exits non-zero with that JSON, never a silently
  truncated perplexity.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass


class FailpointError(RuntimeError):
    """The generic injected failure (action ``raise``)."""


class ShortReadError(OSError):
    """Injected truncated read (action ``short_read``) — an ``OSError``
    so transient-IO retry paths classify it as retryable."""


DEFAULT_SLEEP_S = 30.0

_ACTIONS = {
    "raise": FailpointError,
    "broken_pipe": BrokenPipeError,
    "conn_reset": ConnectionResetError,
    "oserror": OSError,
    "short_read": ShortReadError,
    "sleep": None,  # blocks instead of raising (step-hang injection)
    "nonfinite": None,  # returns the poison mode instead of raising
}

_POISON_MODES = ("nan", "inf")


@dataclass
class _Armed:
    action: str
    times: int | None  # None = fire on every hit
    delay_s: float = DEFAULT_SLEEP_S  # sleep action only
    mode: str = "nan"  # nonfinite action only: which poison to inject


class FailpointRegistry:
    """Thread-safe armed-failpoint table + per-name fire counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Armed] = {}
        self._fired: dict[str, int] = {}

    def arm(self, name: str, action: str = "raise",
            times: int | None = None,
            delay_s: float = DEFAULT_SLEEP_S,
            mode: str = "nan") -> None:
        if action not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"(known: {sorted(_ACTIONS)})")
        if times is not None and times <= 0:
            raise ValueError("times must be positive (or None for always)")
        if mode not in _POISON_MODES:
            raise ValueError(f"nonfinite mode must be one of "
                             f"{_POISON_MODES}, got {mode!r}")
        with self._lock:
            self._armed[name] = _Armed(action, times, delay_s, mode)

    def disarm(self, name: str) -> None:
        with self._lock:
            self._armed.pop(name, None)

    def clear(self) -> None:
        """Disarm everything and zero fire counts (tests)."""
        with self._lock:
            self._armed.clear()
            self._fired.clear()

    def armed(self, name: str) -> bool:
        with self._lock:
            return name in self._armed

    def fired(self, name: str) -> int:
        with self._lock:
            return self._fired.get(name, 0)

    def fire(self, name: str) -> str | None:
        """Raise the armed exception for ``name``; no-op when disarmed.

        Non-raising actions return instead: ``nonfinite`` returns its
        poison mode (``"nan"``/``"inf"``) for the call site to inject,
        ``sleep`` blocks then returns None. The disarmed fast path takes
        no lock: ``_armed`` is read as a plain attribute and arming
        between the check and the locked re-check only delays the
        injection by one hit — fine for a test hook, and it keeps
        per-step cost negligible."""
        if not self._armed:
            return None
        with self._lock:
            fp = self._armed.get(name)
            if fp is None:
                return None
            if fp.times is not None:
                fp.times -= 1
                if fp.times <= 0:
                    del self._armed[name]
            self._fired[name] = self._fired.get(name, 0) + 1
        from . import telemetry

        telemetry.registry().counter(telemetry.FAILPOINTS_FIRED).inc(name=name)
        if fp.action == "sleep":
            # simulate a wedged dispatch: block the calling thread, then
            # return normally — the step watchdog must notice, not this code
            time.sleep(fp.delay_s)
            return None
        if fp.action == "nonfinite":
            return fp.mode
        raise _ACTIONS[fp.action](f"failpoint {name!r} fired")

    def configure(self, spec: str | None) -> None:
        """Arm from a ``name:action[:times],...`` spec (the
        ``DLLAMA_FAILPOINTS`` grammar); ``None``/empty clears."""
        self.clear()
        if not spec:
            return
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"bad failpoint spec {part!r} (want name:action[:times])")
            name, action = fields[0], fields[1]
            times = int(fields[2]) if len(fields) == 3 else None
            self.arm(name, action, times)


_registry = FailpointRegistry()


def registry() -> FailpointRegistry:
    return _registry


def fire(name: str) -> str | None:
    return _registry.fire(name)


def arm(name: str, action: str = "raise", times: int | None = None,
        delay_s: float = DEFAULT_SLEEP_S, mode: str = "nan") -> None:
    _registry.arm(name, action, times, delay_s, mode)


def configure_from_env() -> bool:
    """Arm from ``DLLAMA_FAILPOINTS`` if set; True when anything armed."""
    spec = os.environ.get("DLLAMA_FAILPOINTS")
    if not spec:
        return False
    _registry.configure(spec)
    return True
