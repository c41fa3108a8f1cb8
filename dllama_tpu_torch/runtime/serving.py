"""Continuous batched serving (the port of the JAX package's
``runtime/serving.py``: ``Request``, ``_GeneratorCore``, the dense
``BatchedGenerator``, ``PagedGenerator`` and ``BatchScheduler``).

* :class:`_GeneratorCore` — the slot lifecycle both generators share: the
  slot table, positions and next tokens, per-slot n-gram proposers, and
  the emit / retire / cancel / sampling / non-finite rules.
* :class:`BatchedGenerator` — the dense slot pool (``api --batch-slots N``
  without ``--kv-block-size``): one cache column per slot and ONE ragged
  decode step per tick (``models.llama.ragged_sampled_step``: K2 at ``M =
  n_slots``, K3 with a start position per row), replayed from a CUDA graph
  on the card; ``--decode-chunk K`` runs K replays with one readback, and
  ``--spec-lookup K`` the ragged verify step (``ragged_verify_step``, also
  a graph). Admission prefills the slot's own column in place through K1
  and K3, after copying the longest prefill-context prefix any slot holds
  (cross-slot prefix reuse).
* :class:`PagedGenerator` — ``n_slots`` sequence slots over one block pool
  (:mod:`~dllama_tpu_torch.runtime.kvblocks`) and ONE ragged decode step
  per tick for all of them (``models.llama.paged_sampled_step``: K2 at
  ``M = n_slots``, K4 over the pool, per-row on-device sampling), replayed
  from a CUDA graph on the card (:mod:`~dllama_tpu_torch.runtime.graphs`;
  its inputs are two copies of fixed shape into static buffers). Under
  ``--spec-lookup K`` the tick's dispatch is the ragged paged verify step
  instead (``models.llama.paged_verify_step``: K1 at ``M = n_slots *
  (K + 1)``, K4 at ``T = K + 1``), also a replayed graph: every slot
  drafts from its own n-gram table, greedy rows keep the run their argmax
  agrees with and sampled rows the exact-match run. Admission
  is priced in blocks; a prompt's full blocks are shared with earlier
  prompts and the partial tail is copied on write; prefill runs the
  engine's own dense ``forward`` (K1 + K3) over the sequence's gathered
  column, whose own blocks are scattered back at commit.
* :class:`BatchScheduler` — thread-safe front end over either generator
  (``engine.kv_block_size`` picks): a queue beyond the slots of per-tenant
  FIFOs drained by weighted round-robin (``max_queue`` shedding), deadlines,
  interleaved chunked prefill under a
  per-tick token budget, cancellation, and supervision (a crash fails
  every waiter, resets the pool and restarts, up to ``max_restarts``). One
  loop thread owns the generator and every device dispatch; it captures
  the tick's step before the scheduler is handed out, so before any server
  listens.

Determinism: each request carries its own xorshift seed and consumes its
own coin stream, so a request's output does not depend on what shares the
batch with it — the transcripts equal the single-sequence engine's
(``tests/test_torch_serving.py``, ``tests/test_torch_dense_serving.py``).

Observability, at the JAX package's sites: the batch, admission, retire,
prefix-reuse, queue, shed, timeout and crash/restart counters and the
block-pool gauges (:mod:`~dllama_tpu_torch.runtime.telemetry`); the
``queue``/``admit``/``prefill``/``prefill_chunk``/``decode``/``requeue``
spans; one flight-recorder tick per work-carrying scheduler tick with its
decisions, and the TTFT/ITL attribution (:mod:`~dllama_tpu_torch.runtime.flightrec`);
the engine's step watchdog around every dispatch, whose stall fails every
request (``_on_stall``, on the monitor thread, touching no device state);
and the ``step``, ``admit``, ``draft`` and ``step_hang`` failpoints. Each
guard spans a graph replay and its readback; every call is host code
around the replays (nothing sits inside a captured step), and none reads a
device tensor.

Quality and numerics: a request submitted with ``score=True`` is
a teacher-forced eval sequence (``runtime/evalharness.py``): admitted like
any request but never prefix-matched, every prefill chunk runs
``models.llama.prefill_nll`` on the same padded chunk the plain prefill
would, its NLL values collect in ``Request.nll_parts``, and it retires after
its last chunk without emitting a token. Every step carries the non-finite
tripwire (``runtime/numerics.py``): the ``logits`` failpoint's poison code
rides in the step's knobs buffer (a row written before each replay with
the other knobs, no extra copy or synchronisation), each row's non-finite
lane count comes back with its tokens and counts at the ``batch`` site,
and under ``--numerics-failfast`` fails that row's request (503-shaped).
The scheduler's tick replays the engine's canary, if one is set. Device
memory (``runtime/hbm.py``): a dense pool or a block pool larger than the
card shrinks to what fits (``fit_batch_slots``, ``fit_block_pool``), and
``submit`` refuses a prompt that would push the card past its limit
(:func:`check_hbm_admission`, :class:`HbmAdmissionError`).

Tenancy (:mod:`~dllama_tpu_torch.runtime.tenancy`), at the JAX package's
sites: every request carries its caller's canonical tenant label, the wait
queue is a :class:`~dllama_tpu_torch.runtime.tenancy.FairQueue`, a tenant
at its ``max_slots`` cap is skipped for the tick while the others keep
admitting, a tenant over its ``tokens_per_s`` budget is shed at submit
(:class:`TenantOverBudgetError`, a 429), and every accounting site notes
the same value into the tenant registry that it publishes globally (prefill
and decode tokens, admissions with their queue wait, TTFT and ITL, sheds,
timeouts, speculation, KV block-seconds per tick), with the usage ledger
appended from the loop thread. All of it is host bookkeeping on the loop or
handler threads: no device read, no synchronisation.

Mid-stream resume: a request submitted with ``resume_from = n`` carries a
dead replica's ``n`` emitted tokens at the tail of its prompt. It admits
through the one ordinary path (prefix match, chunked prefill), its coin
stream is fast-forwarded by ``n`` draws (coin ``i`` belongs to emitted token
``i``), and its streaming decoder replays the history with the output
dropped, so the continuation is the one the dead replica would have made.

Tiered KV memory and KV migration (``--kv-host-blocks``, ``runtime/kvwire.py``),
at the JAX package's sites: under allocation pressure the paged pool spills
its coldest cached blocks to a host mirror (:class:`~dllama_tpu_torch.runtime.kvblocks.HostKVMirror`)
instead of dropping them, and an admission whose prefix match lands on host
blocks pages them back in, one ``SPILL_BATCH`` a tick, before its CoW copy and
prefill (the ``pagein`` TTFT phase and span; a failed page-in fails only that
request, 503-shaped). :meth:`PagedGenerator.export_prefix` and
:meth:`PagedGenerator.ingest_prefix` move a resident prefix over the
checksummed Q80 wire: the scheduler serves peers' export gathers between
ticks (:meth:`BatchScheduler.request_kv_export`) and parks a request whose
``kv_peer`` names a donor while a fetch thread pulls its prefix, then admits
it through the ordinary path; every wire failure recomputes, counted by
reason. The pool is always written in place (the captured graphs hold its
address), and tier copies never synchronise the host.

Left out (later slices): the multihost broadcast.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..models.llama import (forward, gather_kv_blocks, paged_sampled_step, paged_verify_step,
                            prefill_nll, ragged_sampled_step, ragged_verify_step,
                            scatter_kv_blocks)
from ..tokenizer.sampler import xorshift_random_f32
from . import failpoints, flightrec, introspection, kvwire, numerics, telemetry, tenancy
from .graphs import StepGraph, load, staging
from .hbm import (admission_check, check_budget, estimate_block_pool_bytes,
                  estimate_prefill_temp_bytes, fit_batch_slots, fit_block_pool, fit_host_pool)
from .kvblocks import (SPILL_BATCH, BlockPool, BlockPoolExhausted, HostKVMirror, PageInError,
                       PagedKVCache, blocks_per_seq)
from ..parallel.sharding import paged_kv_sharding
from .kvcache import HeadShardedKVCache, KVCache, cache_bits, padded_cache_len, to_cache
from .speculative import NgramProposer, spec_coins_consumed

if TYPE_CHECKING:
    from .engine import InferenceEngine

_MASK64 = (1 << 64) - 1


class SchedulerError(RuntimeError):
    """Base for admission-time scheduler failures (serve/api.py maps each
    subclass to an HTTP status)."""


class QueueFullError(SchedulerError):
    """Bounded admission: the wait queue is at --max-queue (HTTP 429)."""


class TenantOverBudgetError(QueueFullError):
    """Per-tenant admission: THIS tenant's ``--tenant-limits`` token-rate
    bucket ran dry (HTTP 429 with the queue-full backpressure headers — the
    subclassing is the contract). Other tenants are unaffected."""


class SchedulerUnavailableError(SchedulerError):
    """The scheduler is draining, closed, or crashed past its restart
    budget (HTTP 503)."""


class RequestTimeoutError(SchedulerError):
    """A request's deadline expired before it produced any output
    (HTTP 408). Expiry mid-generation instead finishes the request with
    ``finish_reason="timeout"`` and partial output."""


class HbmAdmissionError(SchedulerError):
    """The device-memory admission guard refused the request: the estimate,
    raised by the measured per-program bytes, would exceed the card's limit
    (HTTP 503 with the reason; ``dllama_hbm_admission_rejects_total``)."""


def check_hbm_admission(engine, n_prompt: int, need_bytes: int) -> None:
    """The admission guard shared by the batch scheduler's ``submit`` and the
    single-sequence API path: before admitting a prompt, cross-check the
    staging-time estimate against the measured per-program bytes (the
    compile ledger's allocator peaks after each capture and first run),
    plus a temporaries estimate for a prefill width the engine has not run
    yet (a first run of a width allocates its temporaries for the first
    time). Raises :class:`HbmAdmissionError`; a no-op when the limit is
    unknown or ``DLLAMA_SKIP_HBM_CHECK`` is set."""
    bucket = engine._prefill_chunk_size(max(1, n_prompt - 1))
    extra = (0 if bucket in engine.seen_buckets
             else estimate_prefill_temp_bytes(engine.cfg, bucket))
    measured = introspection.ledger().measured_hbm_bytes(engine.introspection_scope)
    ok, reason = admission_check(need_bytes=need_bytes, measured_bytes=measured,
                                 extra_bytes=extra,
                                 what=f"admitting a {n_prompt}-token request",
                                 device=engine.device)
    if not ok:
        telemetry.registry().counter(telemetry.HBM_ADMISSION_REJECTS).inc()
        raise HbmAdmissionError(reason)


@dataclass
class Request:
    rid: int
    prompt_ids: list[int]
    max_tokens: int
    temperature: float = 0.0
    topp: float = 0.9
    seed: int = 0xB1A5
    stop_on_eos: bool = True
    on_token: Callable[[int, str | None], None] | None = None
    # the canonical tenant label (resolved through TenantRegistry.resolve at
    # submit, so the cardinality bound holds) that this request's tokens,
    # latency and KV residency are attributed to
    tenant: str = tenancy.ANON
    # mid-stream resume: the TAIL of prompt_ids carries this many tokens a
    # dead replica already emitted; the coin stream is fast-forwarded by the
    # same count, so the continuation draws the coins the dead replica would
    # have (coin i == emitted token i, the spec_coins_consumed invariant)
    resume_from: int = 0
    # filled by the generator:
    tokens: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    # True when `error` was set by a SERVER-side failure (scheduler crash,
    # shutdown, a non-finite step) rather than a per-request reject — the
    # HTTP layer maps these to 503, not 400
    server_error: bool = False
    # set by the CLIENT to stop decoding early (a stop string matched in the
    # emitted text); the slot retires at the next step boundary
    cancel: threading.Event = field(default_factory=threading.Event)
    rng_state: int = 0
    error: str | None = None
    decoder: object = None  # per-request streaming UTF-8 decoder
    # deadline (monotonic ns; 0 = none): past it the scheduler fails the
    # request if still queued, or cancels its slot at the next step boundary
    deadline_ns: int = 0
    timed_out: bool = False
    # monotonic ns stamps (0 = not reached): submit, admission start,
    # decode armed, first emitted token
    t_submit: int = 0
    t_admit: int = 0
    t_decode: int = 0
    t_first_token: int = 0
    # last emitted-run stamp: the tenant ITL records each run's mean gap
    t_last_emit: int = 0
    # latency attribution (runtime/flightrec): per-phase wall (ms) the
    # generator accumulates
    ms_prefill: float = 0.0       # own prefill chunk dispatch wall
    ms_decode_steps: float = 0.0  # decode dispatch wall while the slot was active
    ms_preempt: float = 0.0       # others' prefill chunks while decode-armed
    ms_verify: float = 0.0        # speculative verify dispatch wall
    ms_pagein: float = 0.0        # KV-tier page-in wall during admission (the
    #                               `pagein` TTFT phase of a resumed session)
    ms_kvmigrate: float = 0.0     # peer-KV migration wall while parked before
    #                               admission (the `kvmigrate` TTFT phase)
    # KV migration (runtime/kvwire): a peer replica whose paged pool holds
    # this prompt's prefix. The scheduler pulls the blocks over the
    # checksummed Q80 wire before admission; ANY failure clears the field
    # and the request admits normally (recompute fallback) — a migration is
    # an optimisation, never a correctness dependency
    kv_peer: str | None = None
    # speculative serving: drafted tokens offered to verify steps, and the
    # drafts accepted
    spec_drafted: int = 0
    spec_accepted: int = 0
    # quality observatory (runtime/evalharness): a teacher-forced eval
    # sequence — admitted and chunk-prefilled like any request, but every
    # chunk runs prefill_nll, the chunk's NLL values (float32, position
    # order) collect here, and it retires at the end of prefill: no decode,
    # no prefix registration
    score: bool = False
    nll_parts: list = field(default_factory=list)

    def __post_init__(self):
        self.rng_state = self.seed & _MASK64
        for _ in range(self.resume_from):
            _, self.rng_state = xorshift_random_f32(self.rng_state)

    def ttft_breakdown(self) -> dict | None:
        """This request's TTFT decomposition (ms) by the one phase formula
        (:func:`~dllama_tpu_torch.runtime.flightrec.ttft_phases`), or None
        before the first token (or for direct generator use, no submit
        stamp)."""
        if not (self.t_first_token and self.t_submit and self.t_admit and self.t_decode):
            return None
        return flightrec.ttft_phases(self.t_submit, self.t_admit, self.t_decode,
                                     self.t_first_token, self.ms_prefill, self.ms_pagein,
                                     self.ms_kvmigrate)


@dataclass
class _Admission:
    """In-flight incremental prefill of one request into one slot.

    ``pos`` doubles as the prompt cursor: exactly ``pos`` prompt tokens have
    been prefilled, at positions ``[0, pos)``."""

    req: Request
    slot: int
    # the column being filled: the paged sequence's gathered copy, or a view
    # of the dense slot's own column
    col: KVCache | None
    pos: int = 0
    reused: int = 0  # prompt positions prefix reuse skipped
    # KV tier (paged pool with --kv-host-blocks): outstanding page-in pairs
    # (host_bid, dev_bid), drained one SPILL_BATCH a continue_admit call so
    # a long resume interleaves with the other slots' decode ticks
    pagein: list = field(default_factory=list)
    # device work deferred until the paged-in content is resident: the
    # copy-on-write block copy (src_dev, dst_dev), the page-in reference on
    # a host-sourced CoW source to release after it, and the column gather
    cow: tuple | None = None
    cow_release: int = 0
    need_take: bool = False


@dataclass
class _KVMigration:
    """One in-flight peer-KV pull (runtime/kvwire): the request parks here
    (popped from the queue, not yet admitted) while a daemon thread streams
    frames from the peer. The fetch thread writes ONLY this holder and never
    touches scheduler or pool state; the loop thread commits or falls back
    in ``_service_migrations`` once ``finished`` flips."""

    req: Request
    peer: str
    t0_ns: int
    blocks: list = field(default_factory=list)
    error: BaseException | None = None
    finished: bool = False


@dataclass
class _KVExportJob:
    """One pending ``/v1/kv/export`` gather: the HTTP handler thread parks on
    ``done`` while the loop thread (the pool's owner) runs
    :meth:`PagedGenerator.export_prefix` between ticks."""

    tokens: list[int]
    done: threading.Event = field(default_factory=threading.Event)
    n_tokens: int = 0
    blocks: list = field(default_factory=list)
    error: BaseException | None = None


@dataclass
class _LoopJob:
    """One call the loop thread runs between ticks for another thread
    (:meth:`BatchScheduler.run_on_loop`)."""

    fn: Callable[[], object]
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None


class _GeneratorCore:
    """Slot lifecycle shared by the dense slot pool (:class:`BatchedGenerator`)
    and the paged block pool (:class:`PagedGenerator`), the JAX package's
    ``_GeneratorCore``: the slot table, each slot's position and next token,
    the per-slot n-gram proposers, and the emit, retire, cancel, sampling
    and non-finite rules of every dispatch. Subclasses own the KV storage
    and the admit and step programs. Not thread-safe by itself (the
    scheduler's loop thread owns it)."""

    # the tp plan the generator's forwards take (the paged pool's at tp > 1)
    plan = None
    # the first word of its programs' names in the compile ledger
    PROGRAM_PREFIX = ""

    def __init__(self, engine: "InferenceEngine", n_slots: int):
        self.eng = engine
        self.cfg = engine.cfg
        self.n_slots = n_slots
        # its programs in the engine's ledger scope, registered before the
        # scheduler can mark the scope steady
        names = ["step", "prefill", "prefill_nll"] + ["verify"] * bool(engine.spec_lookup)
        self.programs = {n: introspection.Program(engine.introspection_scope,
                                                  f"{self.PROGRAM_PREFIX}_{n}")
                         for n in names}
        self.pos = np.zeros(n_slots, dtype=np.int64)
        self.next_token = np.zeros(n_slots, dtype=np.int64)
        self.slots: list[Request | None] = [None] * n_slots
        # speculative serving (--spec-lookup K): K drafts per slot per
        # verify step, each slot's drafts from its own n-gram table
        self.spec = engine.spec_lookup
        self._proposers: list[NgramProposer | None] = [None] * n_slots
        # prompt tokens whose prefill was skipped by prefix reuse (also
        # counted into dllama_prefix_reuse_tokens_total)
        self.reused_tokens = 0
        # telemetry: cached handles (no registry lookups per step)
        self._tm = telemetry.registry()
        self._tm.gauge(telemetry.BATCH_SLOTS).set(n_slots)
        self._m_step_ms = self._tm.histogram(telemetry.BATCH_STEP_MS)
        self._m_occupancy = self._tm.gauge(telemetry.BATCH_OCCUPANCY)
        self._m_tokens = self._tm.counter(telemetry.BATCH_TOKENS)
        self._m_kv = self._tm.gauge(telemetry.KV_OCCUPANCY)
        # flight recorder: the scheduler opens and closes ticks; the
        # generator records its decisions and dispatch/prefill wall into the
        # open tick
        self.flight = flightrec.recorder()
        self._m_ttft_attrib = self._tm.histogram(telemetry.TTFT_ATTRIB_MS)
        self._m_itl_attrib = self._tm.histogram(telemetry.ITL_ATTRIB_MS)
        # the tenant observatory: every accounting site below notes the SAME
        # value it publishes globally, so per-tenant sums reconcile with the
        # global counters exactly
        self._tenancy = tenancy.registry()

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def can_admit(self, req: Request) -> bool:
        """Whether there is room for ``req`` beyond a free slot: the dense
        pool always has it; the paged pool prices the request in blocks."""
        return True

    def admit(self, req: Request, slot: int) -> None:
        """Admit in one go (tests / non-interleaved callers)."""
        adm = self.begin_admit(req, slot)
        while not self.continue_admit(adm):
            pass

    def abort_admit(self, adm: _Admission) -> None:
        """Roll back an admission that will never commit (client cancel
        mid-prefill, or a prefill that raised): nothing to undo in the dense
        pool; the paged pool releases its blocks."""

    def capture(self) -> StepGraph:
        """The step this generator dispatches every tick (the verify step
        under ``spec``), captured now (the compile ledger keeps its bytes
        for the admission guard)."""
        return self.verify_graph() if self.spec else self.step_graph()

    def _graph_sig(self, inp: torch.Tensor, knobs: torch.Tensor, out: torch.Tensor) -> dict:
        """A step graph's signature: its static buffers, the KV storage and
        the mesh."""
        return introspection.signature(inp=inp, knobs=knobs, out=out, kv=self._kv_store(),
                                       mesh=introspection.plan_desc(self.plan))

    def _run_prefill(self, name: str, width: int, fn):
        """``fn()``, one prefill chunk ``width`` tokens wide, as a dispatch of
        this generator's program ``name`` (filed at its first run at a
        width)."""
        return self.programs[name].run(width, fn, device=self.eng.device, sig=lambda: {
            "tokens": f"int64[1,{width}]", **introspection.signature(
                kv=self._kv_store(), mesh=introspection.plan_desc(self.plan))})

    def close(self) -> None:
        """Drop the captured steps (they hold the pool's and the
        parameters' addresses) before the engine releases them."""
        self._graph = None
        self._verify = None

    def _retire(self, slot: int, reason: str = "done") -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self._proposers[slot] = None
        self._tm.counter(telemetry.RETIRES).inc()
        if req.t_decode:
            telemetry.tracer().emit(req.rid, "decode", req.t_decode, telemetry.now_ns(),
                                    slot=slot, n_tokens=len(req.tokens))
        self.flight.note("retire", req.rid, reason=reason, slot=slot,
                         n_tokens=len(req.tokens), tenant=req.tenant)
        # speculation is charged once, at retire, where the request's
        # accept rate becomes final
        self._tenancy.note_spec(req.tenant, req.spec_drafted, req.spec_accepted)
        # ITL attribution, once per request: its decode dispatch wall
        # against the prefill chunks of other admissions that ran while it
        # waited (the tick budget's preemption share)
        if req.t_first_token and len(req.tokens) > 1:
            self._m_itl_attrib.record(req.ms_decode_steps, cause="step")
            self._m_itl_attrib.record(req.ms_preempt, cause="preempt")
            if req.ms_verify:
                self._m_itl_attrib.record(req.ms_verify, cause="verify")
        req.done.set()

    def _arm_decode(self, adm: _Admission) -> None:
        """Commit tail: arm the slot for decode (position, seed token, a
        per-request streaming decoder, the ``prefill`` span)."""
        req = adm.req
        self.pos[adm.slot] = adm.pos
        self.next_token[adm.slot] = req.prompt_ids[-1]
        if self.eng.tokenizer is not None:
            # a shallow copy shares the vocab tables but owns its UTF-8
            # carry-over, so interleaved slots can't corrupt each other
            req.decoder = copy.copy(self.eng.tokenizer)
            req.decoder._pending = bytearray()
            # resumed stream: replay the emitted history through the fresh
            # decoder (output dropped) so its UTF-8 carry-over matches the
            # dead replica's at the splice — a kill inside a multi-byte
            # character still decodes exactly
            for t in req.prompt_ids[len(req.prompt_ids) - req.resume_from:]:
                req.decoder.decode(t)
        req.t_decode = telemetry.now_ns()
        if req.t_admit:
            # n_tokens = positions actually prefilled (after prefix reuse)
            telemetry.tracer().emit(req.rid, "prefill", req.t_admit, req.t_decode,
                                    slot=adm.slot, n_tokens=adm.pos - adm.reused)
        self.flight.note("decode_armed", req.rid, slot=adm.slot, pos=adm.pos,
                         reused=adm.reused)
        self.slots[adm.slot] = req

    def _note_admitted(self, req: Request, slot: int, reused: int) -> None:
        """Admission telemetry, after the last call of ``begin_admit`` that
        can fail, so a rejected request never counts as admitted."""
        req.t_admit = telemetry.now_ns()
        self._tm.counter(telemetry.ADMISSIONS).inc()
        self.flight.note("admit", req.rid, slot=slot, reused=reused,
                         n_prompt=len(req.prompt_ids), tenant=req.tenant)
        if reused:
            self._tm.counter(telemetry.PREFIX_REUSE_TOKENS).inc(reused)
        if req.t_submit:
            wait_ms = (req.t_admit - req.t_submit) / 1e6
            self._tm.histogram(telemetry.QUEUE_WAIT_MS).record(wait_ms)
            # the same wait feeds the tenant's queue-wait histogram
            self._tenancy.note_admission(req.tenant, wait_ms)
            telemetry.tracer().emit(req.rid, "queue", req.t_submit, req.t_admit, slot=slot)
        else:
            self._tenancy.note_admission(req.tenant)

    def _exec_prefill(self, adm: _Admission, padded: list[int]) -> None:
        """One prefill chunk of ``padded`` tokens at ``adm.pos`` into the
        admission's column (the subclass's storage)."""
        raise NotImplementedError

    def _poison(self) -> float:
        """The tripwire's poison selector for one dispatch, driven by the
        ``logits`` failpoint (runtime/numerics); written into the step's
        knobs row with the other per-step knobs."""
        return numerics.poison_code()

    def _prefill_nll_chunk(self, adm: _Admission, padded: list[int], n_valid: int) -> None:
        """The scoring twin of :meth:`_prefill_chunk`: ``prefill_nll`` into
        the admission's column on the SAME padded chunk the plain prefill
        would dispatch (so eval chunking stays bit-comparable to the engine
        oracle's), with the same timing, attribution and ``prefill_chunk``
        span, plus the chunk's NLL values read back and appended to the
        request — sliced to the valid positions, so the padding rows never
        reach a sum."""
        tgt = adm.req.prompt_ids[adm.pos + 1:adm.pos + 1 + n_valid]
        dev = self.eng.device

        def run() -> np.ndarray:
            nll, adm.col = prefill_nll(
                self.eng.params, self.cfg,
                torch.tensor([padded], dtype=torch.long, device=dev),
                torch.tensor([tgt + [0] * (len(padded) - n_valid)], dtype=torch.long,
                             device=dev),
                adm.pos, adm.col, self.plan)
            return nll[0, :n_valid].float().cpu().numpy()

        t0 = telemetry.now_ns()
        with self.eng.guarded("batch_prefill"):
            vals = self._run_prefill("prefill_nll", len(padded), run)
        t1 = telemetry.now_ns()
        ms = (t1 - t0) / 1e6
        adm.req.ms_prefill += ms
        for s in self.slots:
            if s is not None:
                s.ms_preempt += ms
        bad = int(vals.size - np.count_nonzero(np.isfinite(vals)))
        if bad:
            numerics.record_nonfinite(bad, "eval")
        adm.req.nll_parts.append(vals)
        self._tenancy.note_prefill_tokens(adm.req.tenant, n_valid)
        self.flight.note_prefill(adm.req.rid, ms, n_valid)
        telemetry.tracer().emit(adm.req.rid, "prefill_chunk", t0, t1, slot=adm.slot,
                                n_tokens=n_valid)

    def _finish_score(self, adm: _Admission) -> None:
        """Retire a teacher-forced eval admission at the end of its prefill:
        eval sequences never decode. ``RETIRES`` balances the admission, and
        the ``eval`` span covers admission start → last NLL chunk."""
        req = adm.req
        self._tm.counter(telemetry.RETIRES).inc()
        n = max(0, len(req.prompt_ids) - 1)
        telemetry.tracer().emit(req.rid, "eval", req.t_admit or telemetry.now_ns(),
                                telemetry.now_ns(), slot=adm.slot, n_tokens=n)
        self.flight.note("eval_done", req.rid, slot=adm.slot, n_tokens=n)
        req.done.set()

    def _prefill_step(self, adm: _Admission) -> bool:
        """Run the admission's next bucketed prefill chunk (a scoring chunk
        for an eval request); True once its whole prompt is prefilled."""
        rest = adm.req.prompt_ids[:-1]
        if adm.pos < len(rest):
            n_b = self.eng._prefill_chunk_size(len(rest) - adm.pos)
            chunk = rest[adm.pos:adm.pos + n_b]
            pad_to = min(n_b, self.cfg.seq_len - adm.pos)
            padded = chunk + [0] * (pad_to - len(chunk))
            if adm.req.score:
                self._prefill_nll_chunk(adm, padded, len(chunk))
            else:
                self._prefill_chunk(adm, padded, len(chunk))
            self.eng._note_bucket(pad_to)  # the dispatched width
            adm.pos += len(chunk)
        return adm.pos >= len(rest)

    def _prefill_chunk(self, adm: _Admission, padded: list[int], n_valid: int) -> None:
        """One timed prefill chunk under the watchdog, with attribution: the
        admission's own ``prefill`` wall, every decode-armed slot's preempt
        stall, the tick's prefill tokens, and a ``prefill_chunk`` span. The
        time is the host window of the chunk's launches (no readback)."""
        t0 = telemetry.now_ns()
        with self.eng.guarded("batch_prefill"):
            self._run_prefill("prefill", len(padded), lambda: self._exec_prefill(adm, padded))
        t1 = telemetry.now_ns()
        ms = (t1 - t0) / 1e6
        adm.req.ms_prefill += ms
        for s in self.slots:
            if s is not None:
                s.ms_preempt += ms
        self._tenancy.note_prefill_tokens(adm.req.tenant, n_valid)
        self.flight.note_prefill(adm.req.rid, ms, n_valid)
        telemetry.tracer().emit(adm.req.rid, "prefill_chunk", t0, t1, slot=adm.slot,
                                n_tokens=n_valid)

    def _record_step(self, n_active: int, ms: float, emitted: int) -> None:
        """Per-dispatch telemetry: occupancy, step latency, emitted tokens,
        KV occupancy, the tick's dispatch record."""
        self._m_occupancy.set(n_active)
        self._m_step_ms.record(ms)
        if emitted:
            self._m_tokens.inc(emitted)
        self._m_kv.set(self._kv_fraction())
        self.flight.note_dispatch(ms, n_active, emitted)

    def _attrib_decode(self, active: list[int], ms: float) -> None:
        """Charge one decode dispatch's wall to every active request (before
        the tripwire and emit retires clear slots)."""
        for i in active:
            if self.slots[i] is not None:
                self.slots[i].ms_decode_steps += ms

    def _attrib_verify(self, active: list[int], ms: float) -> None:
        """Charge one verify dispatch's wall to every active request (the
        ``verify`` ITL cause)."""
        for i in active:
            if self.slots[i] is not None:
                self.slots[i].ms_verify += ms

    def _safe_draft(self, i: int) -> list[int] | None:
        """Slot ``i``'s proposer draft through the ``draft`` failpoint: a
        proposer that raises DEGRADES the slot to plain decode for this step
        (None; ``dllama_spec_degraded_total``) instead of failing the
        request."""
        try:
            failpoints.fire("draft")
            return self._proposers[i].draft()
        except Exception as e:  # noqa: BLE001 — degrade, never fail the request
            self._tm.counter(telemetry.SPEC_DEGRADED).inc()
            self.flight.note("spec_degraded", self.slots[i].rid, reason=type(e).__name__,
                             slot=i)
            return None

    def _kv_fraction(self) -> float:
        """Live-context share of the KV storage (the occupancy gauge)."""
        raise NotImplementedError

    def _kv_store(self):
        """The KV storage the steps read (the dense pool or the block pool)."""
        raise NotImplementedError

    def flight_blocks(self) -> dict | None:
        """Block-pool occupancy for the tick record (paged pool only)."""
        return None

    def kv_blocks_by_slot(self, slot: int) -> float:
        """KV blocks slot ``slot`` holds now, for the tenant observatory's
        block-second charge: one synthetic block per column in the dense
        pool (the whole column is reserved); the paged pool counts its
        real blocks."""
        return 1.0

    def _handle_nonfinite(self, active: list[int], nf: np.ndarray) -> set[int]:
        """Non-finite tripwire tail of one dispatch: count each poisoned
        row's event (``dllama_nonfinite_total{site="batch"}``); with
        fail-fast armed, fail THAT request explicitly (503-shaped, naming the
        site) instead of emitting garbage tokens and retire its slot, leaving
        the rest of the batch untouched. Returns the retired rows."""
        failed: set[int] = set()
        for i in active:
            n = int(nf[i])
            if n <= 0:
                continue
            numerics.record_nonfinite(n, "batch")
            if self.eng.nf_failfast:
                req = self.slots[i]
                req.error = str(numerics.nonfinite_error("batch", n))
                req.server_error = True
                self._retire(i, "nonfinite")
                failed.add(i)
        return failed

    def _sweep_cancelled(self) -> list[int]:
        """Retire client-cancelled slots; return the active row list."""
        for i, s in enumerate(self.slots):
            if s is not None and s.cancel.is_set():
                self._retire(i, "cancel")
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _sampling_rows(self, active: list[int]) -> np.ndarray:
        """Per-row sampling knobs ``[3, n_slots]`` (temperature, top-p,
        coin) for one dispatch: one xorshift coin drawn and committed per
        temperature > 0 row."""
        knobs = np.zeros((3, self.n_slots), dtype=np.float32)
        for i in active:
            req = self.slots[i]
            knobs[0, i] = req.temperature
            knobs[1, i] = req.topp
            if req.temperature > 0.0:
                knobs[2, i], req.rng_state = xorshift_random_f32(req.rng_state)
        return knobs

    def _emit_run(self, i: int, run: list[int]) -> int:
        """Deliver a run of tokens to slot ``i``'s request: append, stream,
        advance the position, retire on EOS / max_tokens / full context.
        Returns tokens emitted."""
        req = self.slots[i]
        tok = self.eng.tokenizer
        n_keep = min(len(run), req.max_tokens - len(req.tokens))
        if n_keep <= 0:
            self._retire(i, "max_tokens")
            return 0
        retire = n_keep < len(run)
        hit_eos = False
        for j in range(n_keep):
            if req.stop_on_eos and tok is not None and tok.is_eos(run[j]):
                n_keep, retire, hit_eos = j + 1, True, True
                break
        run = run[:n_keep]
        self.pos[i] += len(run)
        self.next_token[i] = run[-1]
        t_emit = telemetry.now_ns()
        if req.t_first_token == 0:
            # first emitted token: stamp it and publish the TTFT breakdown
            req.t_first_token = t_emit
            self.flight.note("first_token", req.rid, slot=i)
            bd = req.ttft_breakdown()
            if bd is not None:
                flightrec.record_ttft(self._m_ttft_attrib, bd)
            if req.t_submit:
                self._tenancy.note_ttft(req.tenant, (t_emit - req.t_submit) / 1e6)
        elif req.t_last_emit:
            # later runs: the run's mean inter-token gap, weighted by its
            # token count (a spec-accepted burst records its per-token gap)
            self._tenancy.note_itl(req.tenant, (t_emit - req.t_last_emit) / 1e6 / len(run),
                                   n=len(run))
        req.t_last_emit = t_emit
        self._tenancy.note_decode_tokens(req.tenant, len(run))
        req.tokens.extend(run)
        if self._proposers[i] is not None:
            self._proposers[i].extend(run)
        for t in run:
            piece = req.decoder.decode(t) if req.decoder is not None else None
            if req.on_token is not None:
                req.on_token(t, piece)
        if (retire or len(req.tokens) >= req.max_tokens
                or self.pos[i] >= self.cfg.seq_len):
            self._retire(i, "eos" if hit_eos
                         else "max_tokens" if len(req.tokens) >= req.max_tokens
                         else "ctx_full")
        return len(run)


class BatchedGenerator(_GeneratorCore):
    """The dense slot pool (the JAX package's ``BatchedGenerator``): one KV
    cache of ``n_slots`` columns, ``[L, n_slots, n_kv, S, hd]``, and ONE
    ragged decode step per tick for every slot
    (:func:`~dllama_tpu_torch.models.llama.ragged_sampled_step`: K2 at ``M =
    n_slots``, K3 over the pool with a start position per row), replayed
    from a CUDA graph on the card. Retired and admitting slots ride along
    every dispatch as temperature-0 rows whose writes land at or past their
    position; their outputs are never read.

    Admission prefills a slot's own column in place (``kv.k[:, s:s+1]`` is
    a contiguous ``[L, 1, n_kv, S, hd]`` view, so K1 and K3 take it as
    they take the engine's cache) in the engine's bucketed chunks,
    interleaved with the other slots' steps. A prompt whose prefix matches
    the prefill context of any slot, live or retired, copies those rows
    from that slot and skips their prefill (cross-slot prefix reuse, the
    batched twin of the single-sequence API's NaiveCache). Only
    prefill-built rows are matched: a decode-built row may differ in its
    last ulp from the prefill a solo run would compute.

    ``step_chunk(k)`` (``--decode-chunk K``) runs ``k`` replays of the step
    with the picked tokens fed back on the device and one readback; under
    ``spec`` the tick's dispatch is the ragged verify step
    (:func:`~dllama_tpu_torch.models.llama.ragged_verify_step` at width
    ``K + 1``, also a replayed graph): greedy rows draft from their n-gram
    tables and keep the run their argmax agrees with, sampled rows emit one
    token."""

    PROGRAM_PREFIX = "slot"

    def __init__(self, engine: "InferenceEngine", n_slots: int = 4):
        if engine.sp > 1:
            raise ValueError("the dense slot pool runs at sp = 1: --sp under api "
                             "is not ported yet")
        if engine.tp > 1:
            raise ValueError("the dense slot pool runs at tp = 1: --tp needs "
                             "--kv-block-size (the paged pool) in this package")
        # the device-memory guard (runtime/hbm.py): a pool that would not fit
        # the card shrinks to the largest that does, with a warning; only a
        # pool where one slot does not fit is refused. The estimate charges
        # the engine's own batch-1 cache, which stays allocated beside it
        n_fit, est = fit_batch_slots(engine.cfg, n_slots, weight_repr=engine.hbm_weight_repr,
                                     kv_dtype_bytes=engine.kv_dtype.itemsize,
                                     device=engine.device)
        if n_fit == 0:
            check_budget(est["need_per_device"], f"batched serving ({n_slots} slots)",
                         engine.device)
        if n_fit < n_slots:
            print(f"⚠️ HBM admission guard: --batch-slots {n_slots} does not fit the "
                  f"device budget — degrading to {n_fit} slots instead of risking an "
                  f"OOM (runtime/hbm.py)", flush=True)
            n_slots = n_fit
        super().__init__(engine, n_slots)
        cfg = self.cfg
        self.hbm_need = est["need_per_device"]  # the submit-time guard's base
        self.pool_bytes = (2 * cfg.n_layers * n_slots * cfg.n_kv_heads
                           * padded_cache_len(cfg.seq_len) * cfg.head_dim
                           * engine.kv_dtype.itemsize)
        self.kv = KVCache.create(cfg, batch_size=n_slots, dtype=engine.kv_dtype,
                                 device=engine.device)
        # per-slot PREFILL context: _ctx[s][p] is the prompt token whose KV
        # row sits at position p of slot s, for the prefill-built region
        # only. It outlives retirement: a retired slot keeps riding along
        # every dispatch, but its writes land at or past pos[s] >=
        # len(_ctx[s]), so its prefix rows stay reusable. An admission
        # clears it first, since prefill then rewrites the column in place.
        self._ctx: list[list[int] | None] = [None] * n_slots
        # the step graph's coin rows: a chunk of --decode-chunk K replays
        self.chunk = engine.decode_chunk
        self._graph: StepGraph | None = None   # the ragged step, built at first use
        self._verify: StepGraph | None = None  # the ragged verify step

    def _prime(self, inp: torch.Tensor, pos_col: int):
        """Warm-up inputs of a captured step: token 0 at the last context
        row of every slot. Writes there are harmless: a live slot rewrites
        that row before it becomes visible, and a prefill context never
        reaches it."""
        def prime() -> None:
            inp.zero_()
            inp[:, pos_col].fill_(self.cfg.seq_len - 1)
        return prime

    def step_graph(self) -> StepGraph:
        """The ragged step on static buffers, captured on the card at the
        first call, on the calling thread: ``[n_slots, 3]`` int64 (next
        token, position, step index), ``[3 + chunk, n_slots]`` f32
        (temperature, top-p, one coin row per step of a chunk, the poison
        selector in the last row's first lane); out ``[2, chunk, n_slots]``
        int64 (token and non-finite lanes of each step).
        A replay writes its picks to row ``step`` of ``out``, feeds them
        back as the next tokens and advances the positions and the step
        index on the device, so a chunk of ``k`` tokens is ``k`` replays
        and one readback. A row past the context (a retired slot) reads and
        writes at the last context row."""
        if self._graph is None:
            dev, C, last = self.eng.device, self.chunk, self.cfg.seq_len - 1
            inp = self._in = torch.zeros((self.n_slots, 3), dtype=torch.long, device=dev)
            knobs = self._knobs = torch.zeros((3 + C, self.n_slots), dtype=torch.float32,
                                              device=dev)
            out = self._out = torch.zeros((2, C, self.n_slots), dtype=torch.long,
                                          device=dev)
            self._in_host, self._knobs_host = staging(inp), staging(knobs)
            # the body closes over tensors, never over self (no cycle that
            # would keep the pool alive past close() until a collection)
            params, cfg, kv = self.eng.params, self.cfg, self.kv

            def body() -> None:
                i = inp[:1, 2]
                nxt, nf = ragged_sampled_step(
                    params, cfg, inp[:, :1], inp[:, 1].clamp(max=last), kv, knobs[0],
                    knobs[1], knobs[2:2 + C].index_select(0, i)[0], knobs[2 + C, :1])
                out[0].index_copy_(0, i, nxt[None])
                out[1].index_copy_(0, i, nf[None].long())
                inp[:, 0].copy_(nxt)
                inp[:, 1:].add_(1)

            self._graph = StepGraph(body, dev, prime=self._prime(inp, 1),
                                    program=self.programs["step"],
                                    sig=self._graph_sig(inp, knobs, out))
        return self._graph

    def verify_graph(self) -> StepGraph:
        """The ragged verify step on static buffers, captured once for
        this pool (``n_slots``, ``K + 1``) at the first call, on the calling
        thread: ``[n_slots, K + 2]`` int64 (the K + 1 tokens, position),
        ``[4, n_slots]`` f32 (temperature, top-p, coin, the poison selector in
        the first lane of the last row); out ``[K + 3,
        n_slots]`` int64 (accepted drafts, non-finite lanes, the K + 1
        picks). A row past ``seq_len - K - 1`` (a retired slot) reads and
        writes from there."""
        if self._verify is None:
            dev, W = self.eng.device, self.spec + 1
            inp = self._vin = torch.zeros((self.n_slots, W + 1), dtype=torch.long, device=dev)
            knobs = self._vknobs = torch.zeros((4, self.n_slots), dtype=torch.float32,
                                               device=dev)
            out = self._vout = torch.zeros((W + 2, self.n_slots), dtype=torch.long,
                                           device=dev)
            self._vin_host, self._vknobs_host = staging(inp), staging(knobs)
            params, cfg, kv = self.eng.params, self.cfg, self.kv  # tensors, not self
            cap = self.cfg.seq_len - W

            def body() -> None:
                n_acc, preds, nf = ragged_verify_step(
                    params, cfg, inp[:, :W], inp[:, W].clamp(max=cap), kv, knobs[0],
                    knobs[1], knobs[2], knobs[3, :1])
                out[0].copy_(n_acc)
                out[1].copy_(nf)
                out[2:].copy_(preds.t())

            self._verify = StepGraph(body, dev, prime=self._prime(inp, W),
                                     program=self.programs["verify"],
                                     sig=self._graph_sig(inp, knobs, out))
        return self._verify

    # -- admission ----------------------------------------------------------

    def _column(self, slot: int) -> KVCache:
        """Slot ``slot``'s column of the pool, ``[L, 1, n_kv, S, hd]``: a
        view, so a forward over it writes the pool in place."""
        return KVCache(k=self.kv.k[:, slot:slot + 1], v=self.kv.v[:, slot:slot + 1])

    def _best_prefix(self, rest: list[int]) -> tuple[int, int]:
        """(source slot, longest shared prefill-context prefix) over all slots."""
        best, best_k = 0, 0
        for s, ctx in enumerate(self._ctx):
            if not ctx:
                continue
            k = 0
            for a, b in zip(rest, ctx):
                if a != b:
                    break
                k += 1
            if k > best_k:
                best, best_k = s, k
        return best, best_k

    def begin_admit(self, req: Request, slot: int) -> _Admission:
        """Start admitting into ``slot``: reuse the longest prefill-context
        prefix of any slot (its rows copied into this slot's column), then
        prefill the rest in place, one chunk per :meth:`continue_admit`."""
        ids = req.prompt_ids
        if not ids:
            raise ValueError("empty prompt")
        limit = self.cfg.seq_len - self.spec  # spec: K + 1 rows past the prompt
        if len(ids) >= limit:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds the usable context "
                f"({limit} = seq_len {self.cfg.seq_len}"
                + (f" - spec-lookup {self.spec}" if self.spec else "") + ")")
        rest = ids[:-1]
        # teacher-forced eval: every position must be scored, so cross-slot
        # prefix reuse is off — a matched prefix would skip its NLL terms
        src, k = (0, 0) if req.score else self._best_prefix(rest)
        if k and src != slot:
            for c in (cache_bits(self.kv.k), cache_bits(self.kv.v)):
                c[:, slot, :, :k] = c[:, src, :, :k]
        # prefill rewrites the column from row k on: its old context is no
        # longer reusable, and its ride-along writes go past the prompt
        self._ctx[slot] = None
        self.pos[slot] = len(rest)
        self.reused_tokens += k
        self._note_admitted(req, slot, k)
        return _Admission(req=req, slot=slot, col=self._column(slot), pos=k, reused=k)

    def _exec_prefill(self, adm: _Admission, padded: list[int]) -> None:
        tokens = torch.tensor([padded], dtype=torch.long, device=self.eng.device)
        forward(self.eng.params, self.cfg, tokens, adm.pos, adm.col)

    def continue_admit(self, adm: _Admission) -> bool:
        """One admission step: one bucketed prefill chunk into the slot's
        column; the last step records the prefill context and arms decode.
        An eval sequence retires instead: no prefix context (its rows hold
        eval KV no admission may match), no proposer, no decode. Returns
        True once committed."""
        if not self._prefill_step(adm):
            return False
        adm.col = None
        if adm.req.score:
            self._finish_score(adm)
            return True
        rest = adm.req.prompt_ids[:-1]
        self._ctx[adm.slot] = list(rest)
        if self.spec:
            self._proposers[adm.slot] = NgramProposer(self.spec)
            self._proposers[adm.slot].extend(adm.req.prompt_ids)
        self._arm_decode(adm)
        return True

    def reset_state(self) -> None:
        """Crash recovery: every slot, cached prefix and proposer
        forgotten, so no later admission can match rows a half-finished
        dispatch may have corrupted."""
        self.slots = [None] * self.n_slots
        self._ctx = [None] * self.n_slots
        self._proposers = [None] * self.n_slots
        self.pos[:] = 0
        self.next_token[:] = 0
        self._m_occupancy.set(0)
        self._m_kv.set(0.0)

    def _kv_store(self):
        return self.kv

    def _kv_fraction(self) -> float:
        """Rows holding LIVE requests' context over the pool's rows (retired
        slots keep their stale positions for prefix reuse, but their rows
        are reclaimable)."""
        live = sum(int(self.pos[i]) for i, s in enumerate(self.slots) if s is not None)
        return live / (self.n_slots * self.cfg.seq_len)

    # -- decode -------------------------------------------------------------

    def _assert_ctx_intact(self) -> None:
        if __debug__:
            # cross-slot prefix reuse: every write cursor sits at or past
            # its slot's prefill context, so ride-along writes never touch
            # reusable rows
            for i, ctx in enumerate(self._ctx):
                assert ctx is None or self.pos[i] >= len(ctx), (i, int(self.pos[i]), len(ctx))

    def _dispatch(self, knobs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """``k`` replays of :meth:`step_graph` from every slot's next token
        and position, ``knobs`` ``[2 + k, n_slots]`` (temperature, top-p,
        one coin row per step) and the poison selector: one host→device copy
        each for the inputs and the knobs, one readback, all under the
        watchdog's guard. Returns ``(tokens [n_slots, k], non-finite lanes
        [n_slots])``."""
        graph = self.step_graph()
        poison = self._poison()
        with self.eng.guarded("batch_step" if k == 1 else "batch_chunk"):
            load(self._in, self._in_host, np.stack(
                [self.next_token, self.pos, np.zeros_like(self.pos)], axis=1))
            full = np.zeros((3 + self.chunk, self.n_slots), dtype=np.float32)
            full[:2 + k] = knobs
            full[2 + self.chunk, 0] = poison
            load(self._knobs, self._knobs_host, full)
            for _ in range(k):
                graph.replay()
            out = self._out[:, :k].cpu().numpy()
        return out[0].T, out[1].sum(axis=0)

    def step(self) -> int:
        """One ragged decode step for every active slot (one replay of
        :meth:`step_graph`; under ``spec`` the verify step,
        :meth:`_spec_step`). Returns the tokens emitted."""
        active = self._sweep_cancelled()
        if self.spec:
            # the K+1-wide write would run past the context: slots that
            # close to the cap retire before the dispatch, as in the JAX
            # package (spec trades the last K positions for run dispatches)
            for i in list(active):
                if self.pos[i] + self.spec + 1 > self.cfg.seq_len:
                    self._retire(i, "ctx_full")
                    active.remove(i)
        if not active:
            return 0
        self._assert_ctx_intact()
        knobs = self._sampling_rows(active)
        if self.spec:
            return self._spec_step(active, knobs)
        t0 = time.perf_counter()
        toks, nf = self._dispatch(knobs, 1)
        ms = (time.perf_counter() - t0) * 1000.0
        self._attrib_decode(active, ms)
        poisoned = self._handle_nonfinite(active, nf)
        emitted = sum(self._emit_run(i, [int(toks[i, 0])]) for i in active
                      if i not in poisoned)
        self._record_step(len(active), ms, emitted)
        return emitted

    def step_chunk(self, k: int) -> int:
        """``k`` ragged decode steps in one dispatch: ``k`` replays of
        :meth:`step_graph` and one readback. Falls back to :meth:`step`
        for ``k <= 1``, under ``spec``, or when an active slot lacks ``k``
        rows of context or ``k`` tokens of budget (the tail runs single
        steps, as the engine's chunked decode does). Each sampled row's
        coins are drawn from a COPY of its RNG state, which then advances
        by exactly the tokens kept, so every coin stream equals the
        single-step one."""
        if k <= 1 or self.spec:
            return self.step()
        if k > self.chunk:
            raise ValueError(f"step_chunk({k}) exceeds the captured chunk of {self.chunk}")
        active = self._sweep_cancelled()
        if not active:
            return 0
        if any(self.pos[i] + k > self.cfg.seq_len
               or self.slots[i].max_tokens - len(self.slots[i].tokens) < k for i in active):
            return self.step()
        self._assert_ctx_intact()
        knobs = np.zeros((2 + k, self.n_slots), dtype=np.float32)
        for i in active:
            req = self.slots[i]
            knobs[0, i], knobs[1, i] = req.temperature, req.topp
            if req.temperature > 0.0:
                st = req.rng_state  # a COPY: committed after truncation
                for j in range(k):
                    knobs[2 + j, i], st = xorshift_random_f32(st)
        t0 = time.perf_counter()
        toks, nf = self._dispatch(knobs, k)
        ms = (time.perf_counter() - t0) * 1000.0
        self._attrib_decode(active, ms)
        poisoned = self._handle_nonfinite(active, nf)
        emitted = 0
        for i in active:
            if i in poisoned:
                continue
            req = self.slots[i]
            n = self._emit_run(i, [int(t) for t in toks[i]])
            emitted += n
            if req.temperature > 0.0:
                st = req.rng_state
                for _ in range(n):
                    _, st = xorshift_random_f32(st)
                req.rng_state = st
        self._record_step(len(active), ms, emitted)
        return emitted

    def _spec_step(self, active: list[int], knobs: np.ndarray) -> int:
        """One ragged verify step for every active slot: one replay of
        :meth:`verify_graph`. Greedy rows verify their proposer's K drafts
        and emit the accepted run; sampled rows emit exactly one token for
        the one coin they drew. A greedy row whose proposer raised (the
        ``draft`` failpoint) carries its committed token as filler, emits
        only its verified token and counts no drafts. Returns the tokens
        emitted."""
        W = self.spec + 1
        toks = np.zeros((self.n_slots, W), dtype=np.int64)
        degraded: set[int] = set()
        for i in active:
            toks[i, 0] = self.next_token[i]
            if self.slots[i].temperature <= 0.0:
                d = self._safe_draft(i)
                if d is None:
                    degraded.add(i)
                    toks[i, 1:] = toks[i, 0]
                else:
                    toks[i, 1:] = d
        graph = self.verify_graph()
        poison = np.zeros((1, self.n_slots), dtype=np.float32)
        poison[0, 0] = self._poison()
        t0 = time.perf_counter()
        with self.eng.guarded("batch_verify"):
            load(self._vin, self._vin_host, np.concatenate([toks, self.pos[:, None]], axis=1))
            load(self._vknobs, self._vknobs_host, np.concatenate([knobs, poison]))
            graph.replay()
            out = self._vout.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000.0
        self._attrib_verify(active, ms)
        drafted = sum(self.spec for i in active
                      if self.slots[i].temperature <= 0.0 and i not in degraded)
        if drafted:
            self._tm.counter(telemetry.SPEC_DRAFT_TOKENS).inc(drafted, generator="dense")
        poisoned = self._handle_nonfinite(active, out[1])
        emitted = accepted = 0
        for i in active:
            if i in poisoned:
                continue
            req = self.slots[i]
            acc = 0 if i in degraded else int(out[0, i])
            if req.temperature <= 0.0 and i not in degraded:
                req.spec_drafted += self.spec
                req.spec_accepted += acc
                accepted += acc
                if acc:
                    self._tm.counter(telemetry.SPEC_ACCEPTED_TOKENS).inc(
                        acc, generator="dense")
            emitted += self._emit_run(i, [int(t) for t in out[2:acc + 3, i]])
        self.flight.note_spec(drafted, accepted)
        self._record_step(len(active), ms, emitted)
        return emitted


class PagedGenerator(_GeneratorCore):
    """Block-granular paged KV + the paged ragged decode step. Not
    thread-safe by itself (the scheduler's loop thread owns it).

    KV lives in a block pool ``[L, n_blocks, n_kv, block_size, hd]`` of
    ``n_slots * table_width + 1`` blocks (the null block included). A
    sequence holds exactly the blocks its context needs (lazy growth at
    decode), and admission reserves each request's worst case, so organic
    mid-decode exhaustion cannot happen."""

    PROGRAM_PREFIX = "paged"

    def __init__(self, engine: "InferenceEngine", n_slots: int = 4):
        block_size = int(engine.kv_block_size or 0)
        if block_size <= 0:
            raise ValueError("PagedGenerator needs an engine built with "
                             "kv_block_size (--kv-block-size N)")
        super().__init__(engine, n_slots)
        self.block_size = block_size
        self.table_width = blocks_per_seq(self.cfg.seq_len, block_size)
        # pool sizing through the device-memory guard (runtime/hbm.py): want
        # every slot at full context + the null block; degrade to the largest
        # pool that fits (at least one full sequence), block by block
        want = n_slots * self.table_width + 1
        n_blocks, est = fit_block_pool(self.cfg, want, block_size=block_size,
                                       min_blocks=self.table_width + 1,
                                       weight_repr=engine.hbm_weight_repr,
                                       kv_dtype_bytes=engine.kv_dtype.itemsize,
                                       device=engine.device, n_shards=engine.n_shards)
        if n_blocks == 0:
            check_budget(est["need_per_device"],
                         f"paged serving ({want} blocks of {block_size})", engine.device)
        if n_blocks < want:
            print(f"⚠️ HBM admission guard: {want} KV blocks do not fit the device "
                  f"budget — degrading to {n_blocks} blocks "
                  f"({(n_blocks - 1) * block_size} cache rows) instead of risking an "
                  f"OOM (runtime/hbm.py)", flush=True)
        self.hbm_need = est["need_per_device"]  # the submit-time guard's base
        self.pool_bytes = estimate_block_pool_bytes(self.cfg, n_blocks, block_size,
                                                    engine.kv_dtype.itemsize)
        # tiered KV memory (--kv-host-blocks): a host mirror pool sized
        # through the host DRAM budget — cold cached blocks spill there under
        # pressure instead of dropping, resumed sessions page them back in
        want_host = engine.kv_host_blocks
        n_host = fit_host_pool(self.cfg, want_host, block_size=block_size,
                               kv_dtype_bytes=engine.kv_dtype.itemsize)
        if n_host < want_host:
            print(f"⚠️ host KV tier: {want_host} host blocks exceed the host DRAM "
                  f"budget — degrading to {n_host} (runtime/hbm.py fit_host_pool)",
                  flush=True)
        self.pool = BlockPool(n_blocks, block_size, n_host_blocks=n_host)
        # at tp > 1 one pool per shard, split over kv heads, under this one
        # allocator and these tables (parallel/sharding.py); the steps run
        # eagerly there, one shard's kernels after another's
        self.plan = engine.plan if engine.tp > 1 else None
        self.pkv = (paged_kv_sharding(self.plan, self.cfg, n_blocks, block_size,
                                      dtype=engine.kv_dtype) if self.plan else
                    PagedKVCache.create(self.cfg, n_blocks, block_size,
                                        dtype=engine.kv_dtype, device=engine.device))
        # the one per-block size formula: the spill/page-in byte counters
        # price blocks as the host budget does
        self._block_bytes = estimate_block_pool_bytes(self.cfg, 1, block_size,
                                                      engine.kv_dtype.itemsize)
        self.mirror: HostKVMirror | None = None
        if n_host:
            # chunk-accounted RAM cap: fragmentation costs capacity, never an
            # overshoot of the budget fit_host_pool granted. The warmup
            # allocates every host buffer and runs both copies once; unlike
            # the JAX generator, which serves untiered after a failed warmup,
            # a failure here fails the start-up: a tier that was asked for is
            # never quietly absent
            self.mirror = HostKVMirror(max_chunks=max(1, n_host // SPILL_BATCH))
            self.mirror.warmup(self.pkv)
            self.pool.spill_fn = self._exec_spill
            self.pool.host_drop_fn = self.mirror.drop
            self.pool.host_room_fn = self.mirror.has_room
        # per-slot block tables (host truth; shipped with pos and the next
        # token in one host→device copy per step)
        self.tables = np.zeros((n_slots, self.table_width), dtype=np.int64)
        self._seq_bids: list[list[int]] = [[] for _ in range(n_slots)]
        # shared-prefix length (in blocks) per slot: the commit scatter skips
        # those entries, so a shared block is never written
        self._n_shared = [0] * n_slots
        # per-slot RESERVATION: worst-case blocks the slot's request may
        # still allocate at decode boundaries; can_admit subtracts the
        # outstanding total so concurrent sequences can't double-spend
        self._reserve = [0] * n_slots
        self._graph: StepGraph | None = None  # the paged step, built at first use
        self._verify: StepGraph | None = None  # the paged verify step, built at first use
        # block-pool gauges: read from the allocator's host counts
        self._m_blocks_used = self._tm.gauge(telemetry.KV_BLOCKS_USED)
        self._m_blocks_shared = self._tm.gauge(telemetry.KV_BLOCKS_SHARED)
        self._m_host_used = self._tm.gauge(telemetry.KV_BLOCKS_HOST_USED)
        self._m_spill_blocks = self._tm.counter(telemetry.KV_SPILL_BLOCKS)
        self._m_spill_bytes = self._tm.counter(telemetry.KV_SPILL_BYTES)
        self._m_spill_ms = self._tm.counter(telemetry.KV_SPILL_MS)
        self._m_pagein_blocks = self._tm.counter(telemetry.KV_PAGEIN_BLOCKS)
        self._m_pagein_bytes = self._tm.counter(telemetry.KV_PAGEIN_BYTES)
        self._m_pagein_ms = self._tm.counter(telemetry.KV_PAGEIN_MS)
        self._tm.gauge(telemetry.KV_BLOCKS_TOTAL).set(n_blocks - 1)
        self._tm.gauge(telemetry.KV_BLOCKS_HOST_TOTAL).set(self.pool.n_host_blocks)
        self._update_block_gauges()

    def _update_block_gauges(self) -> None:
        self._m_blocks_used.set(self.pool.used_blocks())
        self._m_blocks_shared.set(self.pool.shared_blocks())
        if self.pool.n_host_blocks:
            self._m_host_used.set(self.pool.host_used_blocks())

    def _kv_fraction(self) -> float:
        return self.pool.used_blocks() / max(1, self.pool.n_blocks - 1)

    def _kv_store(self):
        return self.pkv

    def flight_blocks(self) -> dict | None:
        d = {"total": self.pool.n_blocks - 1, "used": self.pool.used_blocks(),
             "shared": self.pool.shared_blocks()}
        if self.pool.n_host_blocks:
            d["host_total"] = self.pool.n_host_blocks
            d["host_used"] = self.pool.host_used_blocks()
        return d

    def kv_blocks_by_slot(self, slot: int) -> float:
        return float(len(self._seq_bids[slot]))

    def step_graph(self) -> StepGraph:
        """The paged step on static buffers (``[n_slots, 2 + table_width]``
        int64: next token, position, block table; ``[4, n_slots]`` f32:
        temperature, top-p, coin, and the poison selector in the first lane
        of the last row; out ``[2, n_slots]``: token, non-finite lanes),
        captured on the card at the first call, on the calling
        thread. The warm-up runs with every input 0: all-null tables, so
        its writes land in the null block."""
        if self._graph is None:
            dev = self.eng.device
            inp = self._in = torch.zeros((self.n_slots, 2 + self.table_width),
                                         dtype=torch.long, device=dev)
            knobs = self._knobs = torch.zeros((4, self.n_slots), dtype=torch.float32,
                                              device=dev)
            out = self._out = torch.zeros((2, self.n_slots), dtype=torch.long, device=dev)
            self._in_host, self._knobs_host = staging(inp), staging(knobs)
            # the body closes over tensors, never over self (no cycle that
            # would keep the pool alive past close() until a collection)
            params, cfg, pkv, plan = self.eng.params, self.cfg, self.pkv, self.plan

            def body() -> None:
                nxt, nf = paged_sampled_step(params, cfg, inp[:, :1], inp[:, 1], pkv,
                                             inp[:, 2:], knobs[0], knobs[1], knobs[2],
                                             knobs[3, :1], plan=plan)
                out[0].copy_(nxt)
                out[1].copy_(nf)

            self._graph = StepGraph(body, dev, eager=plan is not None,
                                    program=self.programs["step"],
                                    sig=self._graph_sig(inp, knobs, out))
        return self._graph

    def verify_graph(self) -> StepGraph:
        """The paged verify step on static buffers, captured once for this
        pool geometry (``n_slots``, ``K + 1``, table width) at the first
        call, on the calling thread: ``[n_slots, K + 3 + table_width]``
        int64 (the K+1 tokens, position, draft length, block table),
        ``[K + 4, n_slots]`` f32 (temperature, top-p, the K draft coins,
        the bonus coin, the poison selector in the first lane of the last
        row); out ``[K + 3, n_slots]`` int64 (accepted drafts,
        non-finite lanes, the K+1 emitted candidates). The warm-up runs
        with every input 0: all-null tables, so its writes land in the
        null block."""
        if self._verify is None:
            dev, W = self.eng.device, self.spec + 1
            inp = self._vin = torch.zeros((self.n_slots, W + 2 + self.table_width),
                                          dtype=torch.long, device=dev)
            knobs = self._vknobs = torch.zeros((W + 3, self.n_slots), dtype=torch.float32,
                                               device=dev)
            out = self._vout = torch.zeros((W + 2, self.n_slots), dtype=torch.long,
                                           device=dev)
            self._vin_host, self._vknobs_host = staging(inp), staging(knobs)
            # tensors, not self
            params, cfg, pkv, plan = self.eng.params, self.cfg, self.pkv, self.plan

            def body() -> None:
                n_acc, toks, nf = paged_verify_step(
                    params, cfg, inp[:, :W], inp[:, W], pkv, inp[:, W + 2:], inp[:, W + 1],
                    knobs[0], knobs[1], knobs[2:W + 1].t(), knobs[W + 1], knobs[W + 2, :1],
                    plan=plan)
                out[0].copy_(n_acc)
                out[1].copy_(nf)
                out[2:].copy_(toks.t())

            self._verify = StepGraph(body, dev, eager=plan is not None,
                                     program=self.programs["verify"],
                                     sig=self._graph_sig(inp, knobs, out))
        return self._verify

    # -- slot lifecycle -----------------------------------------------------

    def _worst_case_blocks(self, prompt_len: int, max_tokens: int) -> int:
        """Admission price in blocks: every position the request could ever
        write (prompt prefill + decode growth, capped at seq_len). Under
        speculative serving a verify step writes up to ``pos + lens``
        (``lens <= spec``), so the frontier can run ``spec`` rows past the
        committed need: the ``+ spec`` keeps organic mid-verify exhaustion
        impossible (``lens`` is clamped to ``seq_len - 1 - pos``, so the cap
        holds)."""
        rows = min(prompt_len - 1 + max_tokens + self.spec, self.cfg.seq_len)
        return max(1, -(-rows // self.block_size))

    def can_admit(self, req: Request) -> bool:
        """Free (+ evictable) blocks minus every live sequence's outstanding
        worst-case growth must cover this request's own worst case."""
        return (self.pool.free_blocks() - sum(self._reserve)
                >= self._worst_case_blocks(len(req.prompt_ids), req.max_tokens))

    def _retire(self, slot: int, reason: str = "done") -> None:
        self._release_blocks(slot)
        super()._retire(slot, reason)

    def _release_blocks(self, slot: int) -> None:
        """Drop every block reference ``slot`` holds and forget its
        bookkeeping (the all-null table row sends ride-along writes to the
        null block)."""
        for b in self._seq_bids[slot]:
            self.pool.release(b)
        self._seq_bids[slot] = []
        self._n_shared[slot] = 0
        self._reserve[slot] = 0
        self.tables[slot, :] = self.pool.NULL

    # -- device block movement (plain torch indexing, not kernels) ----------

    def _exec_take(self, bids: list[int]):
        """The sequence's dense column ``[L, 1, n_kv, M * bs, hd]``: its
        blocks gathered in table order, zeros behind them (finite, and
        position-masked); at tp > 1 one column a shard, the
        :class:`~dllama_tpu_torch.runtime.kvcache.HeadShardedKVCache` the
        prefill forward takes."""
        cols = []
        for pkv in self.pkv.pools:
            L, _, n_kv, bs, hd = pkv.k.shape
            idx = torch.tensor(bids, dtype=torch.long, device=pkv.k.device)

            def view(pool: torch.Tensor) -> torch.Tensor:
                bits = cache_bits(pool)
                col = torch.zeros((L, n_kv, self.table_width, bs, hd), dtype=bits.dtype,
                                  device=pool.device)
                col[:, :, :len(bids)] = bits[:, idx].transpose(1, 2)
                return col.view(pool.dtype).reshape(L, 1, n_kv, self.table_width * bs, hd)

            cols.append(KVCache(k=view(pkv.k), v=view(pkv.v)))
        return HeadShardedKVCache(cols) if self.plan else cols[0]

    def _exec_put(self, col, bids: list[int], n_shared: int) -> None:
        """Scatter the slot's OWN blocks of ``col`` back into the pool (every
        shard's); the shared prefix blocks are skipped, so a shared block is
        never a write target."""
        own = bids[n_shared:]
        if not own:
            return
        cols = col.shards if self.plan else [col]
        for pkv, c_kv in zip(self.pkv.pools, cols):
            L, _, n_kv, bs, hd = pkv.k.shape
            idx = torch.tensor(own, dtype=torch.long, device=pkv.k.device)
            for pool, c in ((pkv.k, c_kv.k), (pkv.v, c_kv.v)):
                blocks = c.reshape(L, n_kv, self.table_width, bs, hd)[:, :, n_shared:len(bids)]
                cache_bits(pool)[:, idx] = cache_bits(blocks).transpose(1, 2)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src`` into ``dst``, in every shard's pool."""
        for pkv in self.pkv.pools:
            for pool in (cache_bits(pkv.k), cache_bits(pkv.v)):
                pool[:, dst] = pool[:, src]

    # -- KV tier: spill (device->host) and page-in (host->device) -----------

    def _exec_spill(self, devs: list[int], hosts: list[int]) -> bool:
        """The pool's ``spill_fn``: one batched device->host copy moving the
        LRU cached blocks ``devs`` into the mirror's ``hosts`` lanes. Any
        failure (the ``spill`` failpoint or a real copy error) returns
        False and the pool falls back to drop-evict: a broken host tier
        costs resume work, never availability. The copy is enqueued, not
        waited for (``ms`` is its host window)."""
        if not self.mirror.has_room():
            # the chunk budget is full on fragmented chunks: capacity loss,
            # never an overshoot — the pool drop-evicts as if the tier were off
            self.flight.note("spill_failed", reason="host_budget_full", n_blocks=len(devs))
            return False
        t0 = telemetry.now_ns()
        try:
            failpoints.fire("spill")
            self.mirror.store(self.pkv, devs, hosts)
        except Exception as e:  # noqa: BLE001 — degrade to drop-evict
            self.flight.note("spill_failed", reason=type(e).__name__, n_blocks=len(devs))
            return False
        ms = (telemetry.now_ns() - t0) / 1e6
        self._m_spill_blocks.inc(len(devs))
        self._m_spill_bytes.inc(len(devs) * self._block_bytes)
        self._m_spill_ms.inc(ms)
        self.flight.note("spill", n_blocks=len(devs), ms=round(ms, 3))
        return True

    def _rollback_pagein(self, adm: _Admission) -> None:
        """Undo every UNcopied page-in pair of ``adm`` — the one rollback of
        both failure paths (a failed restore in :meth:`_exec_pagein`, an
        admission aborted in :meth:`abort_admit`): the staged device blocks
        leave the slot's blocks, a CoW whose source never materialised is
        cancelled, and ``abort_pagein`` frees the device blocks and restores
        the host pins — content intact and registered for the next try."""
        uncopied = list(adm.pagein)
        adm.pagein = []
        if not uncopied:
            return
        pair_devs = {dev for _, dev in uncopied}
        self._seq_bids[adm.slot] = [b for b in self._seq_bids[adm.slot]
                                    if b not in pair_devs]
        if adm.cow_release in pair_devs:
            adm.cow_release = 0
            adm.cow = None  # its source never materialised
        self.pool.abort_pagein(uncopied)

    def _exec_pagein(self, adm: _Admission) -> None:
        """Drain one SPILL_BATCH of ``adm``'s pending page-in pairs: restore
        the host copies into the freshly allocated device blocks and commit
        the rebind. A failure (the ``pagein`` failpoint or a real copy
        error) rolls back every uncopied pair (host content stays intact and
        registered for a retry) and raises :class:`PageInError`, which fails
        only this request, 503-shaped; committed earlier batches stay owned
        by the slot and are released with it."""
        batch = adm.pagein[:SPILL_BATCH]
        req = adm.req
        t0 = telemetry.now_ns()
        try:
            failpoints.fire("pagein")
            self.mirror.load(self.pkv, batch)
        except Exception as e:
            self._rollback_pagein(adm)
            self._update_block_gauges()
            raise PageInError(f"KV page-in failed for request {req.rid}: "
                              f"{type(e).__name__}: {e}") from e
        self.pool.commit_pagein(batch)
        adm.pagein = adm.pagein[len(batch):]
        t1 = telemetry.now_ns()
        ms = (t1 - t0) / 1e6
        req.ms_pagein += ms
        self._m_pagein_blocks.inc(len(batch))
        self._m_pagein_bytes.inc(len(batch) * self._block_bytes)
        self._m_pagein_ms.inc(ms)
        self.flight.note("pagein", req.rid, slot=adm.slot, n_blocks=len(batch),
                         ms=round(ms, 3))
        telemetry.tracer().emit(req.rid, "pagein", t0, t1, slot=adm.slot,
                                n_tokens=len(batch) * self.block_size)
        self._update_block_gauges()

    # -- KV migration wire: export (peer pull) / ingest (local commit) -------

    def wire_geometry(self) -> dict:
        """The layout facts a KV-wire transfer must agree on bit for bit
        (``runtime/kvwire.GEOMETRY_KEYS``), ``dtype`` spelled as the JAX
        package spells it (numpy's names), so a JAX replica and a port
        replica can migrate to each other. Config reads only: any thread."""
        return {"n_layers": self.cfg.n_layers, "n_kv_heads": self.cfg.n_kv_heads,
                "block_size": self.block_size, "head_dim": self.cfg.head_dim,
                "dtype": str(self.eng.kv_dtype).removeprefix("torch.")}

    def export_prefix(self, tokens: list[int]) -> tuple[int, list]:
        """Gather the device-resident shared-prefix blocks matching
        ``tokens`` for a peer's ``/v1/kv/export`` pull: ``(n_tokens,
        [(k, v), ...])``, each plane ``[L, n_kv, bs, hd]`` float32 numpy.
        The match stops at the first HOST-resident block (the exporter
        spends no page-in on a peer's behalf). One ``index_select`` of the
        matched blocks and ONE device->host copy per export; the blocks are
        pinned (shared) across it, so no admission's pressure can spill or
        evict them midway, and released after."""
        shared, _n, _cow, _r = self.pool.match_prefix(list(tokens))
        dev: list[int] = []
        for b in shared:
            if self.pool.is_host(b):
                break
            dev.append(b)
        if not dev:
            return 0, []
        t0 = telemetry.now_ns()
        for b in dev:
            self.pool.share(b)
        try:
            ck, cv = gather_kv_blocks(self.pkv, dev)
            both = torch.stack((ck, cv)).cpu()  # the one readback
        finally:
            for b in dev:
                self.pool.release(b)
        planes = both.view(self.eng.kv_dtype).float().numpy()  # [2, L, n, n_kv, bs, hd]
        self.flight.note("kv_export", n_blocks=len(dev),
                         ms=round((telemetry.now_ns() - t0) / 1e6, 3))
        return len(dev) * self.block_size, [(planes[0][:, j], planes[1][:, j])
                                            for j in range(len(dev))]

    def ingest_prefix(self, tokens: list[int], blocks: list) -> int:
        """Commit peer-migrated KV into the pool: one fresh device block per
        received ``(k, v)`` pair (float32 planes, cast to the pool's dtype
        as the JAX package casts them), scattered in place and registered
        under the prompt's prefix, so the next ``begin_admit`` reuses them
        like locally computed blocks. Atomic: exhaustion midway releases
        every staged block and re-raises (the caller's ``exhaustion``
        fallback); nothing registers until every block is resident. Returns
        the prefix tokens now resident (0 when already matched locally: a
        duplicate migration burns no blocks)."""
        n_tokens = len(blocks) * self.block_size
        usable = list(tokens[:n_tokens])
        if len(usable) < n_tokens:
            # the peer sent more blocks than this prompt has prefill
            # positions (a mismatched transfer): refuse the surplus
            n_full = len(usable) // self.block_size
            blocks = blocks[:n_full]
            n_tokens = n_full * self.block_size
            usable = usable[:n_tokens]
        if not blocks:
            return 0
        _, already, _c, _r = self.pool.match_prefix(usable)
        if already >= n_tokens:
            return 0
        bids: list[int] = []
        try:
            for _ in blocks:
                bids.append(self.pool.alloc())
        except BlockPoolExhausted:
            for b in bids:
                self.pool.release(b)
            raise
        dev, dtype = self.pkv.k.device, self.eng.kv_dtype
        chunk = [cache_bits(to_cache(torch.from_numpy(np.stack(
            [np.asarray(blk[i], np.float32) for blk in blocks], axis=1)).to(dev), dtype))
            for i in (0, 1)]
        scatter_kv_blocks(self.pkv, chunk[0], chunk[1], bids)
        self.pool.register_prompt(bids, usable)
        for b in bids:
            # refcount 0 parks each registered block in the cached LRU:
            # matchable by the admission that asked for the migration,
            # evictable or spillable like any cached prefix
            self.pool.release(b)
        self._update_block_gauges()
        return n_tokens

    # -- admission ----------------------------------------------------------

    def begin_admit(self, req: Request, slot: int) -> _Admission:
        """Start admitting into ``slot``: match the prompt against the block
        prefix index (share full blocks, copy-on-write the partial tail),
        allocate the remaining prompt blocks and gather the sequence's
        column for chunked prefill. Atomic: any failure (exhaustion, a
        device error) releases every reference taken and re-raises; on
        :class:`BlockPoolExhausted` the scheduler keeps the request queued."""
        ids = req.prompt_ids
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) >= self.cfg.seq_len:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds the usable context "
                f"(seq_len {self.cfg.seq_len})")
        t_begin = telemetry.now_ns()  # the "admit" span: block bookkeeping
        rest = ids[:-1]
        # teacher-forced eval: every position must be scored, so block-level
        # prefix reuse is off — a matched prefix would skip its NLL terms
        shared, n_tok, cow_src, cow_r = (([], 0, None, 0) if req.score
                                         else self.pool.match_prefix(rest))
        # KV tier: matched blocks may be HOST-resident (a resumed session
        # whose cold blocks spilled). Their page-in is staged now (device
        # blocks allocated atomically, the same exhaustion → requeue
        # contract), the copies — and what depends on the restored content:
        # the CoW copy, the column gather — wait for continue_admit, which
        # drains one batch a tick so bystander decode interleaves
        cow_wanted = cow_src is not None and cow_r > 0
        host_need = [b for b in shared if self.pool.is_host(b)]
        cow_host = cow_wanted and self.pool.is_host(cow_src)
        if cow_host:
            host_need.append(cow_src)
        pairs: list[tuple[int, int]] = []
        bids: list[int] = []
        pinned: list[int] = []  # device shares taken on matched blocks
        cow_exec: tuple | None = None
        cow_release = 0
        try:
            # pin every DEVICE-resident match FIRST: the page-in (and CoW,
            # growth) allocations below resolve pressure against the cached
            # LRU, and an unpinned match there could be spilled or evicted
            # right out from under this admission
            for b in shared:
                if not self.pool.is_host(b):
                    self.pool.share(b)
                    pinned.append(b)
            if cow_wanted and not cow_host:
                self.pool.share(cow_src)  # pin across every alloc below
                pinned.append(cow_src)
            if host_need:
                pairs = self.pool.begin_pagein(host_need)
            devmap = dict(pairs)
            # paged-in blocks carry refcount 1 from begin_pagein, device
            # ones the pin taken above
            bids.extend(devmap.get(b, b) for b in shared)
            reused = n_tok
            if cow_wanted:
                # copy-on-write: the partially matching block cannot be
                # shared (this sequence overwrites rows >= cow_r), so copy
                # it and reuse its first cow_r rows
                if cow_host:
                    src = devmap[cow_src]  # refcount 1 held; released after the copy
                    dst = self.pool.alloc()
                    bids.append(dst)
                    cow_exec, cow_release = (src, dst), src
                else:
                    try:
                        dst = self.pool.alloc()
                    finally:
                        self.pool.release(cow_src)
                        pinned.remove(cow_src)
                    bids.append(dst)
                    self._copy_block(cow_src, dst)
                reused += cow_r
            while len(bids) < -(-len(rest) // self.block_size):
                bids.append(self.pool.alloc())
            # a fully reused prompt has no rows to build: no column at all
            need_take = reused < len(rest)
            col = self._exec_take(bids) if need_take and not pairs else None
        except Exception as e:
            # every reference taken is released exactly once: the pins, the
            # paged-in devices (through abort_pagein, which also restores the
            # host pins) and the fresh blocks left in bids
            pair_devs = {dev for _, dev in pairs}
            for b in bids:
                if b not in pair_devs and b not in pinned:
                    self.pool.release(b)
            for b in pinned:
                self.pool.release(b)
            if pairs:
                self.pool.abort_pagein(pairs)
            if isinstance(e, BlockPoolExhausted):
                self._tm.counter(telemetry.KV_BLOCK_EXHAUSTION).inc()
            raise
        self._seq_bids[slot] = bids
        self._n_shared[slot] = len(shared)
        self._reserve[slot] = max(
            0, self._worst_case_blocks(len(ids), req.max_tokens) - len(bids))
        # the slot's table goes live only at commit: until then the slot
        # rides along decode dispatches as an inactive row (with whatever
        # stale pos the previous occupant left), and its writes must keep
        # landing in the null block, never in a shared block
        self.tables[slot, :] = self.pool.NULL
        self.reused_tokens += reused
        telemetry.tracer().emit(req.rid, "admit", t_begin, telemetry.now_ns(), slot=slot,
                                n_tokens=reused)
        self._note_admitted(req, slot, reused)
        self._update_block_gauges()
        return _Admission(req=req, slot=slot, col=col, pos=reused, reused=reused,
                          pagein=pairs, cow=cow_exec, cow_release=cow_release,
                          need_take=col is None and need_take)

    def _exec_prefill(self, adm: _Admission, padded: list[int]) -> None:
        tokens = torch.tensor([padded], dtype=torch.long, device=self.eng.device)
        _, adm.col = forward(self.eng.params, self.cfg, tokens, adm.pos, adm.col, self.plan)

    def continue_admit(self, adm: _Admission) -> bool:
        """One admission step: drain a page-in batch (a resumed session's
        spilled blocks, one SPILL_BATCH a tick so bystander decode
        interleaves), then the deferred CoW copy and column gather once the
        content is resident, then one bucketed prefill chunk over the
        gathered column; the last step commits — scatters the slot's own
        blocks back, registers the prompt's blocks for sharing, publishes
        the table and arms decode. An eval sequence retires instead: its
        blocks are released unregistered (eval KV never seeds the prefix
        index) and the scored column is dropped. Returns True once
        committed; raises :class:`PageInError` when a page-in fails."""
        if adm.pagein:
            self._exec_pagein(adm)
            if adm.pagein:
                return False  # more batches: keep interleaving
        if adm.cow is not None:
            # the deferred copy-on-write: its source is a paged-in block,
            # resident only now
            src, dst = adm.cow
            self._copy_block(src, dst)
            adm.cow = None
            if adm.cow_release:
                # drop the page-in reference: the source parks in the device
                # cached LRU, registered and shareable again
                self.pool.release(adm.cow_release)
                adm.cow_release = 0
        if adm.need_take:
            adm.col = self._exec_take(self._seq_bids[adm.slot])
            adm.need_take = False
        if not self._prefill_step(adm):
            return False
        slot = adm.slot
        rest = adm.req.prompt_ids[:-1]
        if adm.req.score:
            adm.col = None
            self._release_blocks(slot)
            self._finish_score(adm)
            return True
        bids = self._seq_bids[slot]
        if adm.col is not None:
            self._exec_put(adm.col, bids, self._n_shared[slot])
            adm.col = None
        self.pool.register_prompt(bids, rest)
        self.tables[slot, :len(bids)] = bids
        adm.pos = len(rest)
        if self.spec:
            # every slot drafts: sampled rows verify by exact match
            self._proposers[slot] = NgramProposer(self.spec)
            self._proposers[slot].extend(adm.req.prompt_ids)
        self._arm_decode(adm)
        return True

    def abort_admit(self, adm: _Admission) -> None:
        """Release everything ``begin_admit`` took for an admission that will
        never commit (client cancel mid-prefill, or a prefill that raised).
        Page-in pairs whose copies never ran roll back through
        :meth:`_rollback_pagein` (host content stays registered for the next
        resume); a paged-in CoW source still held releases into the cached
        LRU."""
        adm.col = None
        self._rollback_pagein(adm)
        if adm.cow_release:
            self.pool.release(adm.cow_release)
            adm.cow_release = 0
        self._release_blocks(adm.slot)

    def reset_state(self) -> None:
        """Crash recovery: every slot forgotten, the whole pool (refcounts
        AND the prefix index) reset — nothing can match blocks a
        half-finished dispatch may have corrupted."""
        self.slots = [None] * self.n_slots
        self._proposers = [None] * self.n_slots
        self._seq_bids = [[] for _ in range(self.n_slots)]
        self._n_shared = [0] * self.n_slots
        self._reserve = [0] * self.n_slots
        self.pool.reset()
        if self.mirror is not None:
            self.mirror.drop_all()  # the host buffers follow the pool's reset
        self.tables[:, :] = self.pool.NULL
        self.pos[:] = 0
        self.next_token[:] = 0
        self._m_occupancy.set(0)
        self._m_kv.set(0.0)
        self._update_block_gauges()

    # -- decode -------------------------------------------------------------

    def _ensure_blocks(self, i: int, last_pos: int) -> None:
        """Lazy growth: slot ``i`` gets physical blocks for every write
        position up to ``last_pos`` (inclusive) before the dispatch: the
        block at ``pos`` for a decode step, those covering ``pos .. pos +
        lens`` for a verify step."""
        for idx in range(int(self.pos[i]) // self.block_size,
                         last_pos // self.block_size + 1):
            if self.tables[i, idx] == self.pool.NULL:
                bid = self.pool.alloc()
                self._seq_bids[i].append(bid)
                self._reserve[i] = max(0, self._reserve[i] - 1)
                self.tables[i, idx] = bid

    def _grow_or_fail(self, active: list[int], grow) -> None:
        """Lazy growth for one dispatch over each active slot's write range
        ``pos .. pos + grow[i]``; a slot whose growth finds no block
        (admission reservations make the organic case impossible; the
        ``kv_alloc`` failpoint injects it) fails THAT request (503-shaped),
        leaves a flight-recorder postmortem naming it, and the rest of the
        batch keeps going."""
        for i in list(active):
            try:
                self._ensure_blocks(i, int(self.pos[i]) + int(grow[i]))
            except BlockPoolExhausted as e:
                self._tm.counter(telemetry.KV_BLOCK_EXHAUSTION).inc()
                req = self.slots[i]
                req.error = str(e)
                req.server_error = True
                self._retire(i, "kv_block_exhaustion")
                active.remove(i)
                self.flight.dump("kv_block_exhaustion", victims=[req.rid],
                                 info={"error": str(e), "slot": i})

    def _assert_writable(self, active: list[int], grow) -> None:
        if __debug__:
            # copy-on-write safety: a write target is never a shared block,
            # over the whole verify width under speculation
            for i in active:
                for p in range(int(self.pos[i]), int(self.pos[i]) + int(grow[i]) + 1):
                    bid = int(self.tables[i, p // self.block_size])
                    assert self.pool.refcount(bid) == 1, (i, p, bid)

    def step(self) -> int:
        """One paged ragged decode step for every active slot: one replay
        of :meth:`step_graph`. Inactive slots ride along with all-null
        tables (their writes land in the null block). One host→device copy
        carries the next tokens, positions and tables, one the sampling
        knobs, and one device→host copy brings the tokens back. Returns the
        tokens emitted. Under ``spec`` the dispatch is the verify step
        (:meth:`_spec_step`)."""
        active = self._sweep_cancelled()
        if not active:
            return 0
        if self.spec:
            return self._spec_step(active)
        zeros = [0] * self.n_slots
        self._grow_or_fail(active, zeros)
        if not active:
            return 0
        self._assert_writable(active, zeros)
        knobs = np.zeros((4, self.n_slots), dtype=np.float32)
        knobs[:3] = self._sampling_rows(active)
        knobs[3, 0] = self._poison()
        graph = self.step_graph()
        t0 = time.perf_counter()
        with self.eng.guarded("batch_step"):
            load(self._in, self._in_host, np.concatenate(
                [self.next_token[:, None], self.pos[:, None], self.tables], axis=1))
            load(self._knobs, self._knobs_host, knobs)
            graph.replay()
            out = self._out.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000.0
        self._attrib_decode(active, ms)
        poisoned = self._handle_nonfinite(active, out[1])
        emitted = 0
        for i in active:
            if i not in poisoned:
                emitted += self._emit_run(i, [int(out[0, i])])
        self._record_step(len(active), ms, emitted)
        self._update_block_gauges()
        return emitted

    def _spec_step(self, active: list[int]) -> int:
        """One ragged paged verify step for every active slot: one replay
        of :meth:`verify_graph`.

        Each row's draft length ``lens[i]`` is its proposer's K drafts
        clamped to the context tail (``seq_len - 1 - pos``) and to the
        request's remaining budget, so near-cap and near-done slots keep
        decoding at width 1 instead of retiring early. Sampled rows draw
        their coins in POSITION order (the K draft-position coins, then the
        bonus coin) from a copy of their RNG state and commit one coin per
        emitted token (:func:`~dllama_tpu_torch.runtime.speculative.spec_coins_consumed`),
        so coin ``i`` of a request's stream always belongs to its emitted
        token ``i`` and no request's stream depends on its batch-mates. A row
        whose proposer raised (the ``draft`` failpoint) drafts nothing this
        step (``lens`` 0). Returns the tokens emitted."""
        spec, B = self.spec, self.n_slots
        toks = np.zeros((B, spec + 1), dtype=np.int64)
        lens = np.zeros(B, dtype=np.int64)
        knobs = np.zeros((spec + 4, B), dtype=np.float32)  # temp, top-p, coins, poison
        for i in active:
            req = self.slots[i]
            toks[i, 0] = self.next_token[i]
            knobs[0, i], knobs[1, i] = req.temperature, req.topp
            cap = min(spec, self.cfg.seq_len - 1 - int(self.pos[i]),
                      max(0, req.max_tokens - len(req.tokens) - 1))
            if cap > 0:
                d = self._safe_draft(i)
                if d is None:
                    cap = 0  # degraded: plain decode for this step
                else:
                    toks[i, 1:cap + 1] = d[:cap]
            lens[i] = cap
            if req.temperature > 0.0:
                st = req.rng_state
                for j in range(spec + 1):
                    knobs[2 + j, i], st = xorshift_random_f32(st)
        self._grow_or_fail(active, lens)
        if not active:
            return 0
        self._assert_writable(active, lens)
        drafted = int(lens.sum())
        knobs[spec + 3, 0] = self._poison()
        graph = self.verify_graph()
        t0 = time.perf_counter()
        with self.eng.guarded("batch_verify"):
            load(self._vin, self._vin_host, np.concatenate(
                [toks, self.pos[:, None], lens[:, None], self.tables], axis=1))
            load(self._vknobs, self._vknobs_host, knobs)
            graph.replay()
            out = self._vout.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000.0
        self._attrib_verify(active, ms)
        if drafted:
            self._tm.counter(telemetry.SPEC_DRAFT_TOKENS).inc(drafted, generator="paged")
        poisoned = self._handle_nonfinite(active, out[1])
        emitted = accepted = 0
        for i in active:
            if i in poisoned:
                continue
            req = self.slots[i]
            acc = int(out[0, i])
            accepted += acc
            req.spec_drafted += int(lens[i])
            req.spec_accepted += acc
            if req.temperature > 0.0:
                st = req.rng_state
                for _ in range(spec_coins_consumed(acc)):
                    _, st = xorshift_random_f32(st)
                req.rng_state = st
            emitted += self._emit_run(i, [int(t) for t in out[2:acc + 3, i]])
        if accepted:
            self._tm.counter(telemetry.SPEC_ACCEPTED_TOKENS).inc(accepted, generator="paged")
        self.flight.note_spec(drafted, accepted)
        self._record_step(len(active), ms, emitted)
        self._update_block_gauges()
        return emitted


class BatchScheduler:
    """Thread-safe front end: a queue beyond the slots + a step loop.

    HTTP handler threads call :meth:`submit` (+ wait on the request's
    ``done``) or :meth:`generate`; one background thread owns the
    generator and runs admissions and steps.

    Fault tolerance (nothing may leave a waiter hanging on ``done``):

    * **deadlines** — ``submit(..., timeout_s=...)``: past it a queued
      request fails at once and an in-flight one is cancelled at the next
      step boundary, both marked ``timed_out``;
    * **bounded admission** — ``max_queue > 0`` sheds submits beyond the
      bound with :class:`QueueFullError`;
    * **fair share** — the queue is per-tenant FIFOs drained by weighted
      round-robin; ``tenant_limits`` (``--tenant-limits``, applied to the
      process-wide tenant registry) caps a tenant's concurrent slots and
      sheds a tenant over its token rate with :class:`TenantOverBudgetError`;
    * **supervision** — an exception in the loop fails every queued and
      in-flight request, resets the generator's pool and restarts; past
      ``max_restarts`` the scheduler goes permanently unready and submits
      raise :class:`SchedulerUnavailableError`;
    * **step watchdog** — a dispatch past the engine watchdog's budget
      fails every request from the monitor thread (:meth:`_on_stall`) and
      marks the scheduler permanently unready: the loop thread is the one
      that is stuck;
    * **graceful drain** — :meth:`close` (optionally after
      :meth:`begin_drain`) stops admitting, lets active slots finish up to
      ``drain_s``, then fails the remainder explicitly.
    """

    def __init__(self, engine: "InferenceEngine", n_slots: int = 4, *,
                 max_queue: int = 0, max_restarts: int = 3,
                 tenant_limits: dict | None = None,
                 _start_thread: bool = True):
        # --kv-block-size picks the paged block pool, else the dense slot
        # pool; the queue, deadlines and supervision are the same over both
        self.gen: _GeneratorCore = (PagedGenerator(engine, n_slots) if engine.kv_block_size
                                    else BatchedGenerator(engine, n_slots))
        self.n_slots = self.gen.n_slots  # the device-memory guard may shrink the pool
        # the retrace sentinel (runtime/introspection): the engine's scope is
        # marked steady after STEADY_TICKS work ticks with no capture and no
        # new signature
        self._introspect_scope = engine.introspection_scope
        self._quiet_ticks = 0
        # interleaved chunked prefill: per tick the first admission always
        # advances one chunk, further ones only while this budget lasts, so
        # decode latency of active slots stays bounded
        self.prefill_budget = max(engine.prefill_buckets)
        # flight recorder: the scheduler owns the tick framing
        self.flight = self.gen.flight
        self.max_queue = max_queue
        self.max_restarts = max_restarts
        # the tenant observatory: the process-wide accounting registry, with
        # this scheduler's --tenant-limits applied (tests build a limited
        # scheduler without the CLI)
        self._tenancy = tenancy.registry()
        if tenant_limits is not None:
            self._tenancy.set_limits(tenant_limits)
        # shared state: written by handler threads (submit), the loop
        # thread, the closer and the watchdog monitor — every write outside
        # __init__ holds _lock. The wait queue is per-tenant FIFOs drained by
        # weighted round-robin (FIFO within a tenant)
        self._lock = threading.Lock()
        self._queue = tenancy.FairQueue(
            weight_of=lambda t: self._tenancy.limit_for(t).weight)
        self._admissions: list[_Admission] = []
        # KV migration (runtime/kvwire): requests parked mid-transfer and peer
        # export gathers awaiting the loop thread, under the lock so
        # _fail_all (any thread) can drain the parked requests
        self._migrating: list[_KVMigration] = []
        self._export_jobs: list[_KVExportJob] = []
        self._loop_jobs: list[_LoopJob] = []
        self._wake = threading.Event()
        self._next_rid = 0
        self._stop = False
        self._draining = False
        self._drain_ended = False
        self._healthy = True
        self._crashes = 0
        # step watchdog: a wedged dispatch blocks the loop thread inside a
        # step, so its monitor thread supervises instead
        self._watchdog = engine.watchdog
        self._watchdog.on_stall.append(self._on_stall)
        # tick-usage clock: KV block-seconds and the fairness window are
        # charged per tick as (now - last tick); the idle path resets it so
        # a quiet stretch is billed to nobody
        self._t_last_tick = time.monotonic()
        # the loop thread dispatches on the engine's device: resolved here,
        # on the creating thread, when the engine names no index ("cuda")
        dev = engine.device
        self._cuda_index = (None if dev.type != "cuda" else
                            dev.index if dev.index is not None else torch.cuda.current_device())
        self._thread: threading.Thread | None = None
        if _start_thread:
            # the loop thread captures the tick's step first; the scheduler
            # is handed out (and a server listens) only after that capture
            started = threading.Event()
            failed: list[Exception] = []
            self._thread = threading.Thread(target=self._loop, args=(started, failed),
                                            daemon=True, name="dllama-batch-scheduler")
            self._thread.start()
            started.wait()
            if failed:
                self._thread.join()
                self._watchdog.on_stall.remove(self._on_stall)
                raise failed[0]

    # -- admission-side API (handler threads) -------------------------------

    def submit(self, prompt_ids: list[int], max_tokens: int, *,
               temperature: float = 0.0, topp: float = 0.9,
               seed: int = 0xB1A5, stop_on_eos: bool = True,
               timeout_s: float | None = None, on_token=None,
               kv_peer: str | None = None, score: bool = False, resume_from: int = 0,
               tenant: str = tenancy.ANON) -> Request:
        """Queue a request. ``score=True`` makes it a teacher-forced eval
        sequence (``runtime/evalharness.py``): prefilled through
        ``prefill_nll``, retired after its last chunk with its NLL values in
        ``nll_parts``, no token emitted. (The JAX scheduler refuses scoring
        on a multihost engine, which has no replicated ``prefill_nll``; the
        port has no multihost engine yet.) ``resume_from = n`` marks the
        last ``n`` prompt tokens as a dead replica's emitted history (a
        stream resume); ``tenant`` is the caller's label. ``kv_peer``
        (``host:port``) names a replica whose paged pool holds the prompt's
        prefix: the scheduler pulls it over the KV wire before admission,
        recomputing on any failure (paged pool only; the dense pool ignores
        it)."""
        # resolved before the lock: the cardinality bound and its overflow
        # counter live in the tenant registry, not in scheduler state
        tenant = self._tenancy.resolve(tenant)
        with self._lock:
            if self._stop or self._draining or not self._healthy or (
                    self._thread is not None and not self._thread.is_alive()):
                raise SchedulerUnavailableError(
                    "scheduler is draining" if self._draining
                    else "scheduler is not running")
            if self.max_queue and len(self._queue) >= self.max_queue:
                telemetry.registry().counter(telemetry.REQUESTS_SHED).inc()
                self._tenancy.note_shed(tenant, "queue_full")
                self.flight.note("shed", reason="queue_full", tenant=tenant)
                raise QueueFullError(
                    f"queue full ({len(self._queue)} waiting, "
                    f"--max-queue {self.max_queue}); retry later")
            # the tenant's token-rate budget: the request's worst case
            # (prompt + decode limit) is charged up front, and a 429 here
            # sheds only THIS tenant's request; the global queue bound
            # above comes first, so a full queue never reads as a budget
            # problem
            if not self._tenancy.try_charge_tokens(tenant, len(prompt_ids) + max_tokens):
                telemetry.registry().counter(telemetry.REQUESTS_SHED).inc()
                self._tenancy.note_shed(tenant, "tenant_rate_budget")
                self.flight.note("shed", reason="tenant_rate_budget", tenant=tenant)
                raise TenantOverBudgetError(
                    f"tenant {tenant!r} is over its token-rate budget "
                    f"({self._tenancy.limit_for(tenant).tokens_per_s:g} tok/s); "
                    f"retry later")
            # the device-memory admission guard: refuse a request that would
            # push the card past its limit instead of failing mid-step
            check_hbm_admission(self.gen.eng, len(prompt_ids), self.gen.hbm_need)
            rid = self._next_rid
            self._next_rid += 1
            if not 0 <= resume_from < len(prompt_ids):
                raise ValueError(f"resume_from {resume_from} out of range for a "
                                 f"{len(prompt_ids)}-token prompt+history")
            req = Request(rid=rid, prompt_ids=list(prompt_ids),
                          max_tokens=max_tokens, temperature=temperature,
                          topp=topp, seed=seed, stop_on_eos=stop_on_eos,
                          on_token=on_token, score=score, resume_from=resume_from,
                          tenant=tenant)
            # at tp > 1 the prefix is recomputed, the fallback of every
            # failed migration: the KV wire is not sharded over tp yet
            if kv_peer and isinstance(self.gen, PagedGenerator) and self.gen.plan is None:
                req.kv_peer = kv_peer
            req.t_submit = telemetry.now_ns()
            if timeout_s is not None and timeout_s > 0:
                req.deadline_ns = req.t_submit + int(timeout_s * 1e9)
            # rid → tenant is bound before the loop thread can find the
            # request, so every span it emits carries the attribution
            telemetry.tracer().bind_tenant(rid, tenant)
            self._queue.push(req)
            telemetry.registry().gauge(telemetry.QUEUE_DEPTH).set(len(self._queue))
            self.flight.note("submit", rid, n_prompt=len(prompt_ids), max_tokens=max_tokens,
                             tenant=tenant)
            if resume_from:
                self.flight.note("resume", rid, n_history=resume_from, peer=kv_peer or "",
                                 tenant=tenant)
        self._wake.set()
        return req

    def generate(self, prompt_ids: list[int], max_tokens: int, **kw) -> list[int]:
        req = self.submit(prompt_ids, max_tokens, **kw)
        req.done.wait()
        return req.tokens

    def is_alive(self) -> bool:
        """Loop thread running and not crash-exhausted."""
        return (self._healthy and not self._stop
                and (self._thread is None or self._thread.is_alive()))

    def eval_resident(self) -> int:
        """Teacher-forced eval sequences queued or mid-prefill right now
        (``runtime/evalharness.py``), surfaced on ``/readyz``: eval work
        counts in the queue depth without producing tokens, and this says
        why the depth is up."""
        with self._lock:
            return (sum(1 for r in self._queue if r.score)
                    + sum(1 for a in self._admissions if a.req.score))

    def readiness(self) -> tuple[bool, str, str]:
        """(ready, human reason, machine code) for ``GET /readyz``."""
        if self._watchdog.stalled:
            return False, "step watchdog tripped (wedged device dispatch)", "crashed"
        if not self._healthy:
            return False, "scheduler crashed (restart budget exhausted)", "crashed"
        if self._thread is not None and not self._thread.is_alive():
            return False, "scheduler thread is not running", "crashed"
        if self._stop or self._draining:
            return False, "draining", "draining"
        if self.max_queue and len(self._queue) >= self.max_queue:
            return False, "queue full (shedding)", "queue_full"
        return True, "ok", "ok"

    # -- shutdown ------------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting (submits raise 503-shaped errors, ``/readyz``
        flips) while in-flight work keeps stepping."""
        with self._lock:
            already = self._draining
            self._draining = True
            n_queued = len(self._queue)
        telemetry.registry().gauge(telemetry.SERVER_DRAINING).set(1)
        if not already:
            self.flight.note("drain_begin", n_queued=n_queued, n_active=self.gen.n_active)
        self._wake.set()

    def _pending(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._admissions)

    def close(self, drain_s: float = 0.0) -> None:
        """Stop admitting, drain active work up to ``drain_s`` seconds, then
        stop the loop and fail whatever remains — every waiter's ``done`` is
        set by the time this returns."""
        self.begin_drain()
        if drain_s > 0 and self._thread is not None and self._thread.is_alive():
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline and (self._pending() or self.gen.n_active):
                time.sleep(0.01)
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # the drain bracket closes before the remainder fails, so the
        # lifecycle ring reads drain_begin ... drain_end (once)
        with self._lock:
            ended, self._drain_ended = self._drain_ended, True
        if not ended:
            remainder = self._pending() + self.gen.n_active
            self.flight.note("drain_end", n_failed=remainder,
                             reason=("clean" if remainder == 0
                                     else "drain_timeout" if drain_s > 0 else "aborted"))
            # the final ledger line at drain: the cumulative totals a
            # consumer reconciles against are never lost to the interval
            tenancy.ledger().maybe_write(self._tenancy, force=True)
        self._fail_all("server shutting down")
        if self._on_stall in self._watchdog.on_stall:
            self._watchdog.on_stall.remove(self._on_stall)
        self.gen.close()

    # -- failure plumbing ----------------------------------------------------

    @staticmethod
    def _fail_request(req: Request, msg: str) -> None:
        if not req.done.is_set():
            if not req.timed_out:
                req.error = msg
                req.server_error = True
            req.done.set()

    def _timeout_request(self, req: Request) -> None:
        req.timed_out = True
        telemetry.registry().counter(telemetry.REQUEST_TIMEOUTS).inc()
        # same site, same count: per-tenant timeouts reconcile exactly
        self._tenancy.note_timeout(req.tenant)

    def _fail_all(self, msg: str) -> None:
        """Fail every queued, admitting and in-flight request with ``msg``
        (idempotent; timed-out requests keep their flag). Admissions are not
        rolled back here: this runs on foreign threads too (close, the
        watchdog monitor) that must not touch the loop thread's pool, and
        every caller resets the pool right after (crash restart) or stops
        serving for good (stall, drain)."""
        with self._lock:
            # parked migrations hold no pool state (the fetch thread writes
            # only its holder): failing them leaks nothing, and an orphaned
            # fetch's result is simply dropped
            victims = (list(self._queue) + [a.req for a in self._admissions]
                       + [m.req for m in self._migrating])
            self._queue.clear()
            self._admissions.clear()
            self._migrating.clear()
            telemetry.registry().gauge(telemetry.QUEUE_DEPTH).set(0)
        victims += [s for s in list(self.gen.slots) if s is not None]
        for req in victims:
            self._fail_request(req, msg)

    def _check_deadlines(self) -> None:
        """Queued requests past their deadline fail now; in-flight ones are
        cancelled (their slot retires at the next step boundary)."""
        now = telemetry.now_ns()
        with self._lock:
            expired = [r for r in self._queue if r.deadline_ns and now >= r.deadline_ns]
            for r in expired:
                self._queue.remove(r)
            if expired:
                telemetry.registry().gauge(telemetry.QUEUE_DEPTH).set(len(self._queue))
            holders = [a.req for a in self._admissions]
        for req in expired:
            self._timeout_request(req)
            self.flight.note("timeout", req.rid, reason="queued", tenant=req.tenant)
            req.done.set()
        for reason, reqs in (("admitting", holders),
                             ("in_flight", [s for s in self.gen.slots if s is not None])):
            for req in reqs:
                if req.deadline_ns and now >= req.deadline_ns and not req.timed_out:
                    self._timeout_request(req)
                    self.flight.note("timeout", req.rid, reason=reason, tenant=req.tenant)
                    req.cancel.set()

    # -- KV migration (runtime/kvwire): peer pull before admission -----------

    def _spawn_migration(self, mig: _KVMigration) -> None:
        """Start the fetch thread of a freshly parked migration. The transfer
        deadline, ``kvwire.DEFAULT_DEADLINE_S`` (read at call time), is
        bounded by the request's own remaining deadline."""
        deadline_s = kvwire.DEFAULT_DEADLINE_S
        if mig.req.deadline_ns:
            remaining = (mig.req.deadline_ns - telemetry.now_ns()) / 1e9
            deadline_s = max(0.05, min(deadline_s, remaining))
        self.flight.note("kvmigrate_begin", mig.req.rid, peer=mig.peer)
        threading.Thread(target=self._migrate_worker, args=(mig, deadline_s), daemon=True,
                         name=f"dllama-kvwire-{mig.req.rid}").start()

    def _migrate_worker(self, mig: _KVMigration, deadline_s: float) -> None:
        """The fetch thread: stream and verify the peer's frames. Writes ONLY
        the migration holder, so a fetch that outlives a fail-all sweep is
        harmless."""
        try:
            _, blocks = kvwire.fetch_kv(mig.peer, mig.req.prompt_ids[:-1],
                                        self.gen.wire_geometry(), deadline_s=deadline_s)
            mig.blocks = [(k, v) for _i, k, v in sorted(blocks, key=lambda t: t[0])]
        except BaseException as e:  # noqa: BLE001 — every failure falls back to recompute
            mig.error = e
        mig.finished = True
        self._wake.set()

    def _service_migrations(self) -> None:
        """Commit or fall back every finished migration: success ingests the
        blocks (the request's own admission then reuses them like any shared
        prefix); ANY failure — a wire error, injected chaos, an exhausted
        destination — counts its reason in ``dllama_kvwire_fallback_total``
        and requeues the request at its tenant's head for ordinary chunked
        prefill. Either way the parked wall lands in the request's
        ``kvmigrate`` TTFT phase and span: the user never sees an error."""
        with self._lock:
            finished = [m for m in self._migrating if m.finished]
            for m in finished:
                self._migrating.remove(m)
        for mig in finished:
            req = mig.req
            if req.done.is_set():
                continue  # failed (shutdown, deadline) while parked
            n_tokens, reason = 0, None
            if mig.error is None:
                try:
                    n_tokens = self.gen.ingest_prefix(req.prompt_ids[:-1], mig.blocks)
                except BlockPoolExhausted:
                    reason = "exhaustion"
                except Exception as e:  # noqa: BLE001 — a bad ingest degrades to recompute
                    reason = kvwire.classify_failure(e)
            else:
                reason = kvwire.classify_failure(mig.error)
            now = telemetry.now_ns()
            req.ms_kvmigrate += (now - mig.t0_ns) / 1e6
            telemetry.tracer().emit(req.rid, "kvmigrate", mig.t0_ns, now, n_tokens=n_tokens)
            reg = telemetry.registry()
            if reason is None:
                reg.counter(telemetry.KVWIRE_MIGRATIONS).inc(outcome="migrated")
                self.flight.note("kvmigrate", req.rid, n_tokens=n_tokens, peer=mig.peer)
            else:
                reg.counter(telemetry.KVWIRE_MIGRATIONS).inc(outcome="fallback")
                reg.counter(telemetry.KVWIRE_FALLBACK).inc(reason=reason)
                self.flight.note("kvmigrate_fallback", req.rid, reason=reason, peer=mig.peer)
            with self._lock:
                # the head of its tenant's queue, where it was when it parked
                # (push_front refunds the pass the park's pop charged)
                self._queue.push_front(req)
                telemetry.registry().gauge(telemetry.QUEUE_DEPTH).set(len(self._queue))
            self._wake.set()

    # -- KV export (the peer-pull source side) -------------------------------

    def request_kv_export(self, tokens: list[int],
                          timeout_s: float = 5.0) -> tuple[int, list]:
        """Gather the device-resident prefix blocks matching ``tokens`` for a
        peer's ``/v1/kv/export`` pull: the calling handler thread parks while
        the loop thread (the pool's owner) runs
        :meth:`PagedGenerator.export_prefix` between ticks. Returns
        ``(n_tokens, [(k, v), ...])``; raises
        :class:`SchedulerUnavailableError` when the loop cannot serve it."""
        if not isinstance(self.gen, PagedGenerator):
            raise SchedulerUnavailableError(
                "KV export needs the paged block pool (--kv-block-size)")
        job = _KVExportJob(tokens=list(tokens))
        with self._lock:
            if self._stop or not self._healthy or (
                    self._thread is not None and not self._thread.is_alive()):
                raise SchedulerUnavailableError("scheduler is not running")
            self._export_jobs.append(job)
        self._wake.set()
        if not job.done.wait(timeout_s):
            raise SchedulerUnavailableError(f"KV export gather timed out after {timeout_s:g}s")
        if job.error is not None:
            raise job.error
        return job.n_tokens, job.blocks

    def run_on_loop(self, fn: Callable[[], object], timeout_s: float = 30.0):
        """``fn()`` on the loop thread, the one that dispatches every step,
        between two ticks; returns its result or raises its error. A
        profiler session starts and stops there (``POST /debug/profile``),
        never beside a step in flight. Without a loop thread (a test driving
        ``_tick``) ``fn`` runs on the caller's."""
        if self._thread is None:
            return fn()
        job = _LoopJob(fn=fn)
        with self._lock:
            if self._stop or not self._healthy or not self._thread.is_alive():
                raise SchedulerUnavailableError("scheduler is not running")
            self._loop_jobs.append(job)
        self._wake.set()
        if not job.done.wait(timeout_s):
            with self._lock:
                pending = job in self._loop_jobs
                if pending:
                    self._loop_jobs.remove(job)
            if pending:
                raise SchedulerUnavailableError(
                    f"the loop thread took no call within {timeout_s:g}s")
            job.done.wait()  # started: a loop call is short, let it finish
        if job.error is not None:
            raise job.error
        return job.result

    def _service_loop_jobs(self) -> None:
        with self._lock:
            jobs, self._loop_jobs = list(self._loop_jobs), []
        for job in jobs:
            try:
                job.result = job.fn()
            except Exception as e:  # noqa: BLE001 — the caller gets the error
                job.error = e
            job.done.set()

    def _service_exports(self) -> None:
        """Drain pending export gathers (the loop thread, the only one that
        touches the pool). A failed gather answers THAT export with its
        error; serving is untouched."""
        with self._lock:
            jobs, self._export_jobs = list(self._export_jobs), []
        for job in jobs:
            try:
                job.n_tokens, job.blocks = self.gen.export_prefix(job.tokens)
            except Exception as e:  # noqa: BLE001 — the export answers with the error
                job.error = e
            job.done.set()

    def _on_stall(self, info: dict) -> None:
        """Watchdog trip, on the MONITOR thread (the loop thread is the one
        stuck inside a dispatch, and this touches no device state): flip
        unready first, under the lock, so no submit slips in after the fail
        sweep; fail every queued, admitting and in-flight request (503s,
        never a hang); leave a flight-recorder postmortem. The stall is
        permanent: a dispatch that wedged once is not trusted again."""
        with self._lock:
            self._healthy = False
            self._stop = True
            victims = [r.rid for r in self._queue] + [a.req.rid for a in self._admissions]
        victims += [s.rid for s in self.gen.slots if s is not None]
        self._fail_all(f"step watchdog: device dispatch {info.get('label')!r} stalled "
                       f"past its {info.get('budget_s') or 0:.1f}s budget")
        self.flight.dump("watchdog_stall", victims=victims,
                         info={"label": info.get("label"), "budget_s": info.get("budget_s"),
                               "waited_s": info.get("waited_s")})
        self._wake.set()

    def _on_crash(self, exc: BaseException) -> None:
        """Supervision: fail every pending request with the crash, then
        restart with a fresh pool — or go permanently unready once the
        restart budget is spent."""
        self._crashes += 1
        telemetry.registry().counter(telemetry.SCHEDULER_CRASHES).inc()
        msg = f"scheduler crashed: {type(exc).__name__}: {exc}"
        print(f"🛑 {msg} (crash {self._crashes}/{self.max_restarts})", flush=True)
        with self._lock:
            victims = [r.rid for r in self._queue] + [a.req.rid for a in self._admissions]
        victims += [s.rid for s in self.gen.slots if s is not None]
        self.flight.dump("scheduler_crash", victims=victims,
                         info={"error": msg, "crash_n": self._crashes})
        dead = self._crashes > self.max_restarts

        def go_unready() -> None:
            with self._lock:  # before the fail sweep: no submit slips in after it
                self._healthy = False
                self._stop = True

        if dead:
            go_unready()
        self._fail_all(msg)
        if dead:
            print("🛑 scheduler restart budget exhausted — marking unready", flush=True)
            return
        try:
            self.gen.reset_state()
        except Exception as e:  # noqa: BLE001 — a failed reset goes unready
            go_unready()
            self._fail_all(msg)
            print(f"🛑 scheduler state reset failed ({e}) — marking unready", flush=True)
            return
        telemetry.registry().counter(telemetry.SCHEDULER_RESTARTS).inc()

    # -- the loop ------------------------------------------------------------

    def _loop(self, started: threading.Event, failed: list) -> None:
        if self._cuda_index is not None:
            # this thread dispatches every kernel: on the engine's device
            # (and so on that device's current stream, as the wrappers read it)
            torch.cuda.set_device(self._cuda_index)
        try:
            # captured here, on the thread that replays it, while no other
            # thread of the process dispatches (the creator waits)
            self.gen.capture()
        except Exception as exc:  # noqa: BLE001 — re-raised by the creator
            failed.append(exc)
            return
        finally:
            started.set()
        while not self._stop:
            try:
                self._tick()
            except Exception as exc:  # noqa: BLE001 — supervised: fail-all + bounded restart
                self._on_crash(exc)

    def _tick(self) -> None:
        """One loop tick inside a flight-recorder tick record (idle ticks
        are dropped by ``end_tick``; the ``finally`` closes the tick on a
        crash too, so the postmortem holds the dying tick)."""
        self.flight.begin_tick(queue_depth=len(self._queue),
                               n_admissions=len(self._admissions))
        try:
            self._tick_body()
        except BaseException as e:
            self.flight.note("crash", reason=type(e).__name__)
            raise
        finally:
            self.flight.end_tick(blocks=self.gen.flight_blocks(),
                                 slots=[s.rid if s is not None else None
                                        for s in self.gen.slots],
                                 prefill_budget=self.prefill_budget)

    STEADY_TICKS = 2  # quiet work ticks before the scope is declared steady

    def _mark_steady_if_quiet(self, compiles_before: int) -> None:
        led = introspection.ledger()
        scope = self._introspect_scope
        if led.steady(scope):
            return
        if led.compile_count(scope) == compiles_before:
            self._quiet_ticks += 1
            if self._quiet_ticks >= self.STEADY_TICKS:
                led.mark_steady(scope)
        else:
            self._quiet_ticks = 0

    def _tick_body(self) -> None:
        """Deadlines, the KV wire's service points, admissions (block-priced
        in the paged pool; a head with a ``kv_peer`` hint parks while its
        prefix is fetched), the cancel sweep, interleaved prefill chunks
        under the token budget, then one decode dispatch for every active
        slot."""
        compiles_before = introspection.ledger().compile_count(self._introspect_scope)
        self._check_deadlines()
        # peer export gathers run here (the loop thread owns the pool), and
        # finished peer pulls commit or fall back before this tick's
        # admissions, so a just-migrated prefix is matchable by its own
        # request's begin_admit below
        if self._loop_jobs:
            self._service_loop_jobs()
        if self._export_jobs:
            self._service_exports()
        if self._migrating:
            self._service_migrations()
        reserved = {a.slot for a in self._admissions}
        started: list[_KVMigration] = []
        with self._lock:
            # admit into free, unreserved slots in weighted-round-robin order
            # across tenants (FairQueue: FIFO within a tenant); on the paged
            # pool each request is priced in BLOCKS first (worst-case need vs
            # free + evictable blocks) — an unaffordable head stays queued at
            # its tenant's head. A tenant at its --tenant-limits slot cap is
            # skipped for this tick, not a barrier: the others keep admitting
            blocked: set[str] = set()
            while True:
                head = self._queue.peek(blocked)
                if head is None:
                    break
                if head.kv_peer:
                    # peer-KV pull: the request parks while a fetch thread
                    # streams frames across ticks; bystanders keep admitting
                    # and decoding
                    self._queue.pop(head)
                    mig = _KVMigration(req=head, peer=head.kv_peer, t0_ns=telemetry.now_ns())
                    head.kv_peer = None  # one attempt, ever
                    self._migrating.append(mig)
                    started.append(mig)
                    continue
                free = [s for s in self.gen.free_slots() if s not in reserved]
                if not free:
                    break
                lim = self._tenancy.limit_for(head.tenant)
                if lim.max_slots and self._tenant_active(head.tenant) >= lim.max_slots:
                    self.flight.note("defer", head.rid, reason="tenant_slot_cap",
                                     tenant=head.tenant)
                    blocked.add(head.tenant)
                    continue
                if not self.gen.can_admit(head):
                    # blocks unaffordable: the head stays queued, and the
                    # tick record says why nothing admitted
                    self.flight.note("defer", head.rid, reason="blocks_unaffordable",
                                     tenant=head.tenant)
                    break
                self._queue.pop(head)
                try:
                    failpoints.fire("admit")
                    adm = self.gen.begin_admit(head, free[0])
                except BlockPoolExhausted:
                    # back-pressure: the request goes back to its tenant's
                    # head (the pop's pass refunded) and waits for
                    # retirements to free blocks
                    self._queue.push_front(head)
                    now = telemetry.now_ns()
                    telemetry.tracer().emit(head.rid, "requeue", now, now)
                    self.flight.note("requeue", head.rid, reason="kv_block_exhaustion",
                                     tenant=head.tenant)
                    break
                except Exception as e:  # noqa: BLE001 — reject, don't wedge
                    head.error = f"{type(e).__name__}: {e}"
                    # a failed page-in is the server's failure: 503-shaped
                    head.server_error = isinstance(e, PageInError)
                    self.flight.note("reject", head.rid, reason=type(e).__name__,
                                     tenant=head.tenant)
                    head.done.set()
                    continue
                self._admissions.append(adm)
                reserved.add(adm.slot)
            telemetry.registry().gauge(telemetry.QUEUE_DEPTH).set(len(self._queue))
        # fetch threads start outside the lock (a worker's first wake must
        # not re-enter it)
        for mig in started:
            self._spawn_migration(mig)
        # cancel sweep over EVERY admission before the budgeted prefill loop:
        # a cancelled client behind the budget cutoff must not keep its blocks
        for adm in list(self._admissions):
            if adm.req.cancel.is_set():
                with self._lock:
                    if adm not in self._admissions:
                        continue  # a concurrent _fail_all already took it
                    self._admissions.remove(adm)
                self.gen.abort_admit(adm)
                # counted as admitted: balance admissions - retires
                telemetry.registry().counter(telemetry.RETIRES).inc()
                self.flight.note("cancel", adm.req.rid, reason="admitting",
                                 tenant=adm.req.tenant)
                adm.req.done.set()
        spent = 0
        for adm in list(self._admissions):
            if spent >= self.prefill_budget:
                # prefills on later ticks: the preemption ITL attribution
                # is built from these decisions
                self.flight.note("preempt", adm.req.rid, reason="prefill_budget",
                                 tenant=adm.req.tenant)
                continue
            remaining = len(adm.req.prompt_ids) - 1 - adm.pos
            spent += self.gen.eng._prefill_chunk_size(max(1, remaining))
            try:
                committed = self.gen.continue_admit(adm)
            except Exception as e:  # noqa: BLE001 — reject, don't wedge
                committed = True
                self.gen.abort_admit(adm)
                telemetry.registry().counter(telemetry.RETIRES).inc()
                adm.req.error = f"{type(e).__name__}: {e}"
                # a failed KV page-in fails ONLY this request, 503-shaped:
                # bystander slots keep decoding
                adm.req.server_error = isinstance(e, PageInError)
                self.flight.note("reject", adm.req.rid, reason=type(e).__name__)
                adm.req.done.set()
            if committed:
                with self._lock:
                    if adm in self._admissions:
                        self._admissions.remove(adm)
        # the canary sentinel (runtime/numerics): a time-gated fixed-seed
        # replay on this thread, the one that owns every dispatch, so it
        # never races a step
        canary = self.gen.eng.canary
        if canary is not None:
            canary.maybe_run()
        if self.gen.n_active == 0 and not self._admissions:
            # idle: nobody holds KV, so the usage clock restarts (a quiet
            # stretch is billed to nobody); the ledger keeps its cadence
            self._t_last_tick = time.monotonic()
            tenancy.ledger().maybe_write(self._tenancy)
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        failpoints.fire("step")
        # --decode-chunk K (dense pool only; the engine refuses it with
        # --kv-block-size): K steps per tick, admissions interleave per K
        if self.gen.eng.decode_chunk > 1:
            self.gen.step_chunk(self.gen.eng.decode_chunk)
        else:
            self.gen.step()
        # only work ticks advance the steady countdown: an idle server must
        # not declare itself steady before it ran anything
        self._mark_steady_if_quiet(compiles_before)
        self._note_tick_usage()

    def _tenant_active(self, tenant: str) -> int:
        """Slots ``tenant`` occupies or is admitting into — the count its
        ``max_slots`` cap gates on (the caller holds ``_lock``)."""
        return (sum(1 for s in self.gen.slots if s is not None and s.tenant == tenant)
                + sum(1 for a in self._admissions if a.req.tenant == tenant))

    def _note_tick_usage(self) -> None:
        """Charge this tick's wall to each tenant's KV residency (device
        tier: the blocks its live slots hold, one per column in the dense
        pool; host tier: the spilled blocks its admissions' outstanding
        page-ins still reference), feed the fairness window, and give the
        usage ledger its chance to append. Host bookkeeping only: dict
        updates and at most one small file append."""
        now = time.monotonic()
        dt = now - self._t_last_tick
        self._t_last_tick = now
        device: dict[str, float] = {}
        for i, s in enumerate(self.gen.slots):
            if s is not None:
                device[s.tenant] = device.get(s.tenant, 0.0) + self.gen.kv_blocks_by_slot(i)
        host: dict[str, float] = {}
        with self._lock:
            for a in self._admissions:
                if a.pagein:
                    host[a.req.tenant] = host.get(a.req.tenant, 0.0) + len(a.pagein)
        if device or host:
            self._tenancy.note_tick(dt, device, host)
        tenancy.ledger().maybe_write(self._tenancy)
