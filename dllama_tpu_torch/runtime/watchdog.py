"""Step watchdog — hang detection for device dispatches (the port of the
JAX package's ``runtime/watchdog.py``).

A wedged dispatch (a kernel that never finishes, a driver fault) blocks
its calling thread forever: on the card that thread sits in the readback
after a graph replay (``.cpu()`` / ``.tolist()``), since a replay itself
returns at once. The batch scheduler's loop thread is then stuck, every
queued request waits behind it, and nothing raises. This module closes
the gap:

* every guarded dispatch arms a deadline on a shared monitor thread
  (:meth:`StepWatchdog.guard`, which spans the replay AND its readback);
  the budget is an EWMA of observed step times × ``margin``, floored at
  ``min_budget_s``;
* no deadline is armed until ``min_samples`` steps have been observed —
  the first steps (and a graph capture, which the port keeps outside the
  guard) train the EWMA instead of tripping it;
* on expiry the monitor dumps diagnostics (the compile ledger's programs,
  the last flight-recorder ticks and all thread stacks: enough to tell a
  capture or a kernel build in progress from a wedged dispatch), increments ``dllama_watchdog_stalls_total``,
  marks the watchdog stalled, and calls the registered ``on_stall``
  callbacks from the MONITOR thread — the dispatch thread is the one that
  is stuck, so supervision (fail in-flight → 503, flip ``/readyz``) must
  run elsewhere, and must not touch the device.

Env knobs: ``DLLAMA_WATCHDOG=0`` disables arming entirely,
``DLLAMA_WATCHDOG_MARGIN`` / ``DLLAMA_WATCHDOG_FLOOR_S`` override the
budget shape (README, "Failure semantics").
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from contextlib import contextmanager

from . import telemetry

DEFAULT_MARGIN = 20.0
DEFAULT_FLOOR_S = 120.0
DEFAULT_MIN_SAMPLES = 3
DEFAULT_ALPHA = 0.2  # EWMA weight of the newest observation


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


class StepWatchdog:
    """Deadline monitor for one engine's device dispatches.

    Thread model: dispatch threads call :meth:`guard` (arm → dispatch →
    disarm + observe); one lazy daemon monitor thread waits for the
    earliest armed deadline and trips at most once per armed guard. All
    shared state is under ``_lock``.
    """

    def __init__(self, name: str = "engine", *,
                 margin: float | None = None,
                 min_budget_s: float | None = None,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 alpha: float = DEFAULT_ALPHA,
                 enabled: bool | None = None):
        self.name = name
        self.margin = margin if margin is not None else _env_float(
            "DLLAMA_WATCHDOG_MARGIN", DEFAULT_MARGIN)
        self.min_budget_s = min_budget_s if min_budget_s is not None \
            else _env_float("DLLAMA_WATCHDOG_FLOOR_S", DEFAULT_FLOOR_S)
        self.min_samples = min_samples
        self.alpha = alpha
        self.enabled = (os.environ.get("DLLAMA_WATCHDOG") != "0"
                        if enabled is None else enabled)
        self.ewma_ms: float | None = None
        self.n_samples = 0
        # stall state: sticky until the process restarts — a dispatch that
        # exceeded its budget may still be holding the device, so "it came
        # back eventually" does not make the engine healthy again
        self.stalled = False
        self.stall_count = 0
        # callbacks run on the MONITOR thread with one dict argument
        # (label/budget/waited); the scheduler registers its fail-all here
        self.on_stall: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._deadline: float | None = None  # monotonic; None = disarmed
        self._armed_label: str | None = None
        self._armed_t0 = 0.0
        self._armed_seq = 0   # guard generation: trip at most once each
        self._tripped_seq = -1
        self._thread: threading.Thread | None = None
        self._closed = False

    # -- budget --------------------------------------------------------------

    def budget_s(self) -> float | None:  # dlint: owner=any
        """Current deadline budget, or None while the EWMA is still
        training (fewer than ``min_samples`` observations)."""
        if not self.enabled or self.n_samples < self.min_samples \
                or self.ewma_ms is None:
            return None
        return max(self.min_budget_s, self.ewma_ms / 1000.0 * self.margin)

    def observe(self, ms: float) -> None:  # dlint: owner=any
        """Feed one completed step's wall time into the EWMA."""
        with self._lock:
            self.ewma_ms = ms if self.ewma_ms is None else (
                self.alpha * ms + (1.0 - self.alpha) * self.ewma_ms)
            self.n_samples += 1

    # -- guarding ------------------------------------------------------------

    @contextmanager
    def guard(self, label: str):  # dlint: owner=any
        """Arm a deadline around one device dispatch; always records the
        observed duration on exit (the EWMA trains even before arming)."""
        budget = self.budget_s()
        t0 = time.perf_counter()
        if budget is not None:
            self._arm(label, t0, t0 + budget)
        try:
            yield
        finally:
            if budget is not None:
                self._disarm()
            self.observe((time.perf_counter() - t0) * 1000.0)

    def _arm(self, label: str, t0: float, deadline: float) -> None:  # dlint: owner=any
        with self._lock:
            self._deadline = deadline
            self._armed_label = label
            self._armed_t0 = t0
            self._armed_seq += 1
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"dllama-watchdog-{self.name}")
                self._thread.start()
        self._wake.set()

    def _disarm(self) -> None:  # dlint: owner=any
        with self._lock:
            self._deadline = None
            self._armed_label = None

    def close(self) -> None:  # dlint: owner=any
        with self._lock:
            self._closed = True
            self._deadline = None
        self._wake.set()

    # -- monitor thread ------------------------------------------------------

    def _run(self) -> None:  # dlint: owner=monitor-thread
        while True:
            with self._lock:
                if self._closed:
                    return
                deadline = self._deadline
                now = time.perf_counter()
                tripped_current = self._tripped_seq == self._armed_seq
                expired = (deadline is not None and now >= deadline
                           and not tripped_current)
                if expired:
                    self._tripped_seq = self._armed_seq
                    info = {"name": self.name,
                            "label": self._armed_label,
                            "budget_s": deadline - self._armed_t0,
                            "waited_s": now - self._armed_t0}
            if expired:
                self._trip(info)
                continue
            # park until the next arm/disarm when nothing is pending — a
            # guard that already tripped stays wedged indefinitely and
            # must not be busy-polled at the clamped minimum
            timeout = None if (deadline is None or tripped_current) \
                else max(0.01, deadline - time.perf_counter())
            self._wake.wait(timeout=timeout)
            self._wake.clear()

    def _trip(self, info: dict) -> None:  # dlint: owner=monitor-thread
        self.stalled = True
        self.stall_count += 1
        telemetry.registry().counter(telemetry.WATCHDOG_STALLS).inc(
            name=self.name)
        print(f"🛑 step watchdog [{self.name}]: dispatch "
              f"{info['label']!r} exceeded its {info['budget_s']:.1f}s "
              f"budget ({info['waited_s']:.1f}s and counting) — marking "
              f"engine unhealthy", flush=True)
        self._dump_diagnostics()
        for cb in list(self.on_stall):
            try:
                cb(info)
            except Exception as e:  # noqa: BLE001 — one bad callback must not mask the stall or skip the next callback
                print(f"🛑 watchdog on_stall callback failed: "
                      f"{type(e).__name__}: {e}", flush=True)

    def _dump_diagnostics(self) -> None:  # dlint: owner=monitor-thread
        """The compile ledger's programs, the last flight-recorder ticks and
        all-thread stacks: what was captured or built, the decisions that
        led in, and where the loop thread is stuck."""
        try:
            from . import introspection

            snap = introspection.ledger().snapshot()
            lines = [f"    {p['scope']}/{p['program']}: "
                     f"{p['compiles']} compiles, {p['hits']} hits, "
                     f"last {p['last_compile_s']:.2f}s"
                     for p in snap["programs"]]
            print("🛑 watchdog: compile-ledger state\n"
                  + ("\n".join(lines) or "    (no programs recorded)"),
                  flush=True)
        except Exception as e:  # noqa: BLE001 — diagnostics are advisory; the stall itself is already reported
            print(f"🛑 watchdog: compile ledger unavailable "
                  f"({type(e).__name__}: {e})", flush=True)
        try:
            from . import flightrec

            ticks = flightrec.recorder().snapshot()["ticks"][-8:]
            if ticks:
                lines = [
                    f"    tick {t['tick']}: q={t.get('queue_depth', 0)} "
                    f"active={t.get('n_active', 0)} "
                    f"dispatch={t.get('dispatch_ms', 0.0):.1f}ms "
                    f"prefill={t.get('prefill_ms', 0.0):.1f}ms "
                    f"decisions={[d.get('event') for d in t.get('decisions', [])]}"
                    for t in ticks]
                print("🛑 watchdog: last flight-recorder ticks\n"
                      + "\n".join(lines), flush=True)
        except Exception as e:  # noqa: BLE001 — diagnostics are advisory; the stall itself is already reported
            print(f"🛑 watchdog: flight recorder unavailable "
                  f"({type(e).__name__}: {e})", flush=True)
        try:
            frames = sys._current_frames()
            out = []
            for tid, frame in frames.items():
                tname = next((t.name for t in threading.enumerate()
                              if t.ident == tid), str(tid))
                stack = "".join(traceback.format_stack(frame, limit=12))
                out.append(f"  -- thread {tname} --\n{stack}")
            print("🛑 watchdog: thread stacks\n" + "".join(out),
                  file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — diagnostics are advisory; the stall itself is already reported
            print(f"🛑 watchdog: thread dump failed "
                  f"({type(e).__name__}: {e})", flush=True)
