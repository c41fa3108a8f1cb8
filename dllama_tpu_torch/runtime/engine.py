"""InferenceEngine on one device (the port of the JAX package's
``runtime/engine.py``, single-sequence path).

Holds the config, the device parameters and the dense KV cache, and drives
the model functions of :mod:`dllama_tpu_torch.models.llama`: bucketed
chunked prefill (:data:`PREFILL_BUCKETS`), one forward + on-device argmax or
sample per decode token, perplexity and teacher-forced NLL. The method names
and signatures are the JAX engine's, so the same callers (the golden replay
protocol in the tests) run both. With ``kv_block_size`` the engine also
serves paged continuous batching (:mod:`dllama_tpu_torch.runtime.serving`
builds the block pool and reuses ``prefill_buckets`` and
``_prefill_chunk_size``). With ``sp > 1`` the KV cache is split along the
sequence over ``sp`` devices (:class:`~dllama_tpu_torch.runtime.kvcache.ShardedKVCache`)
and attention runs sequence-parallel (:mod:`dllama_tpu_torch.parallel.ring`);
the weights and everything else stay on the lead device. With ``tp > 1``
(``--tp``) every matmul weight is cut over ``tp`` shards (an MoE layer's
expert stacks over their hidden axis, turbo planes like the Q40 planes they
come from) and the cache over kv heads
(:mod:`dllama_tpu_torch.parallel.sharding`); the shards' kernels
launch one shard after another from this process, and the rest stays on
the lead device.

Decode at ``sp == 1`` replays the step captured as a CUDA graph on the card
(:class:`~dllama_tpu_torch.runtime.graphs.DecodeGraph`, captured at the
engine's first decode of each kind, greedy or sampled; on the CPU the same
step runs on the same buffers). ``decode_chunk=K`` (``--decode-chunk``)
decodes ``K`` tokens per dispatch with the tokens fed back on the device and
one readback per chunk: ``K`` replays of the graph, or at ``sp > 1`` or
``tp > 1``, whose steps cross shards and stay eager,
:func:`~dllama_tpu_torch.models.llama.greedy_steps` /
:func:`~dllama_tpu_torch.models.llama.sampled_steps`.

``spec_lookup=K`` (``--spec-lookup``) is prompt-lookup speculative decoding
at temperature 0: each dispatch verifies K drafts from the token history
(:class:`~dllama_tpu_torch.runtime.speculative.NgramProposer`) in one
forward over K+1 positions (:func:`~dllama_tpu_torch.models.llama.verify_step`)
and keeps the run the model agrees with — a replay of
:class:`~dllama_tpu_torch.runtime.graphs.VerifyGraph` at sp == 1, the eager
step through the ring / merge path at sp > 1. Rows written for rejected
drafts stay where they are: past the committed position they are
invisible to the causal mask and the next dispatch rewrites them. At
temperature > 0 the flag is ignored, as in the JAX engine.

``kv_dtype`` (``--kv-dtype``) stores the cache as f32, bf16 or float8 e4m3
(``"f8"``: half of bf16's bytes, rounded at the write to the JAX package's
bits, :func:`~dllama_tpu_torch.runtime.kvcache.to_cache`); ``weight_mode``
(``--weight-mode f32|bf16``) loads every matmul weight dequantized to a
dense matrix, so the products run as plain matrix products and the
quantized-matmul kernels are not launched; an f32 product never runs in
TF32 (:func:`~dllama_tpu_torch.ops.linear.linear`). ``host_sampling``
(``--host-sampling``) is the parity oracle of sampled decode: one eager
forward a token, its logits to the host and
:meth:`~dllama_tpu_torch.tokenizer.sampler.Sampler.sample`. With
``verify_weights`` every tensor is crc-checked against the ``.m.sums``
manifest before anything is staged on the device; a constructor that
raises leaves no device memory behind.

``quant_mode`` (``--quant-mode auto|exact|fast|turbo|turbo16``) fixes the
quantized matmuls' numerics in the config (``ops/linear.py``). Under
``turbo``/``turbo16`` the weights load like fast, then every Q40/Q80 plane
is requantized to per-column int8 (``ops/turbo.py::turbo_layer``, one leaf
at a time, each layer as it loads and before a tp cut), with the JAX
engine's refusals: a dense ``weight_mode`` before the load, a file that
loaded dense after it. The JAX engine re-reads its
``DLLAMA_TPU_QUANT_MODE`` at every dispatch and refuses a change after the
load; the port reads no environment variable for the mode, so the mode
cannot change under a loaded engine and that guard has no counterpart.
Mixture-of-experts files (Mixtral, Qwen3-MoE) run on every path: the expert
FFN sits in the model's one FFN site.

Observability (:mod:`~dllama_tpu_torch.runtime.telemetry`,
:mod:`~dllama_tpu_torch.runtime.flightrec`,
:mod:`~dllama_tpu_torch.runtime.watchdog`, at the JAX engine's sites): every
dispatch runs under the engine's :class:`~dllama_tpu_torch.runtime.watchdog.StepWatchdog`
guard with the ``step_hang`` failpoint inside it. On the card the guard
spans a graph replay AND its readback (the replay returns at once; a wedged
kernel blocks the readback), and a step's first capture runs before the
guard is entered. Prefill chunks, decode steps and verify steps feed the
``dllama_prefill_*`` / ``dllama_decode_*`` histograms and counters, and the
spans and flight events the serving layer reads; all of it is host code
around the replays, and adds no device synchronisation.

Numerics (:mod:`~dllama_tpu_torch.runtime.numerics`, at the JAX engine's
sites): every decode, chunk and verify step returns its non-finite logits
count with its tokens (no extra readback) and takes the ``logits``
failpoint's poison selector, a device scalar filled before the replay; the
count feeds ``dllama_nonfinite_total{site}`` and, with
``numerics_failfast``, raises :class:`~dllama_tpu_torch.runtime.numerics.NumericsError`.
Prefill checks the one logits row it reads back; ``numerics_taps`` runs
prefill through :func:`~dllama_tpu_torch.models.llama.forward_with_taps`.
``canary`` holds the serving layer's
:class:`~dllama_tpu_torch.runtime.numerics.CanarySentinel`, if any.

Device memory (:mod:`~dllama_tpu_torch.runtime.hbm`): before anything is
staged the engine estimates its bytes (``hbm_estimate``) and refuses a
model that does not fit the card; ``seen_buckets`` and the compile ledger's
measured bytes (the allocator's peak after each prefill width's first
dispatch and each graph's capture) feed the serving layer's admission
guard.

Compile ledger and profiling (:mod:`~dllama_tpu_torch.runtime.introspection`,
:mod:`~dllama_tpu_torch.runtime.profiling`): the engine's programs
(``programs``: prefill, decode, verify, ...) are registered in the ledger
under its scope, the watchdog's name; each graph capture and each first
run at a new signature (a prefill width, a tp > 1 step) is filed there with
what K1-K5 move in it. ``profile_split`` (``--profile-split``) measures the
Eval/Sync split of the tp merges once (:meth:`measure_split`) and fills each
step's ``sync_ms``.

Padded prefill tails are safe without masking: pad-position garbage lands in
KV slots strictly beyond the current position, is invisible to the causal
mask (``s <= pos``), and every slot is rewritten by its real token before it
ever becomes visible.
"""

from __future__ import annotations

import itertools
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..formats.mfile import ModelFile
from ..formats.quants import F32, Q40, Q80
from ..models.config import ModelConfig
from ..models.llama import (Params, forward, forward_with_taps, greedy_steps, prefill_nll,
                            sampled_steps, verify_step)
from ..parallel.api import MeshPlan, default_devices, make_mesh
from ..parallel.sharding import default_tp, validate_tp
from ..tokenizer.bpe import Tokenizer
from ..tokenizer.sampler import Sampler, xorshift_random_f32
from . import failpoints, flightrec, introspection, numerics, telemetry
from .graphs import DecodeGraph, VerifyGraph
from .hbm import check_budget, estimate_device_bytes
from .kvblocks import validate_block_size
from .kvcache import F8, HeadShardedKVCache, KVCache, ShardedKVCache, padded_cache_len
from .profiling import capture_active
from .speculative import NgramProposer
from .watchdog import StepWatchdog
from .weights import WeightIntegrityError, load_params, verify_weights as _verify_all

DEFAULT_N_BATCHES = 32  # reference default nBatches (app.cpp:28)

# engine names: the watchdog's and the compile ledger's scope (the JAX
# engine's introspection scopes)
_ENGINE_SEQ = itertools.count(1)

# prefill chunk sizes, largest first: the prompt is evaluated in the largest
# bucket it fills, and the tail pads into the smallest (the JAX engine's
# buckets; an explicit n_batches pins one fixed chunk size)
PREFILL_BUCKETS = (256, 128, 64, 32)

# widest dispatch of the decode regime (the JAX package's _OVERLAP_MAX_WIDTH
# and quant_matmul's FUSED_MAX_M): the paged verify width K+1 stays within it
DECODE_MAX_WIDTH = 16


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA on a machine
    without a usable GPU raises: nothing silently carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            f"False (no usable NVIDIA GPU or a CPU-only PyTorch build); pass "
            f"--device cpu (device='cpu') to run on the CPU")
    return dev


@dataclass
class StepMetrics:
    """Per-dispatch timing (reference console metrics, dllama.cpp:59-67):
    ``ms`` is host wall time of a dispatch that ends in a device sync."""

    kind: str  # "eval" (prefill chunk) or "pred" (decode)
    ms: float
    n_tokens: int
    # token WIDTH of the dispatch (a decode chunk always runs its full k,
    # even when EOS truncation keeps fewer: n_tokens is the kept count)
    width: int = 1
    # the tp merges' share of ``ms`` (``profile_split``: the measured
    # program's sync fraction applied to the step's wall)
    sync_ms: float | None = None

    @property
    def eval_only_ms(self) -> float | None:
        return None if self.sync_ms is None else self.ms - self.sync_ms


@dataclass
class GenerationResult:
    tokens: list[int]
    text: str
    prompt_tokens: int
    steps: list[StepMetrics] = field(default_factory=list)

    def _rate(self, kind: str) -> float:
        n = sum(s.n_tokens for s in self.steps if s.kind == kind)
        ms = sum(s.ms for s in self.steps if s.kind == kind)
        return n / (ms / 1000.0) if n > 0 and ms > 0.0 else 0.0

    @property
    def eval_ms(self) -> float:
        return sum(s.ms for s in self.steps if s.kind == "eval")

    @property
    def pred_ms(self) -> float:
        return sum(s.ms for s in self.steps if s.kind == "pred")

    @property
    def pred_tok_per_s(self) -> float:
        return self._rate("pred")

    @property
    def eval_tok_per_s(self) -> float:
        return self._rate("eval")


def mesh_plan(device, sp: int = 1, sp_devices=None, tp: int = 1,
              tp_devices=None) -> MeshPlan | None:
    """The ``sp`` or ``tp`` mesh of an engine (None when both are 1): the
    named devices, or :func:`~dllama_tpu_torch.parallel.api.default_devices`
    — ``cuda:0 .. cuda:n-1`` on the card (fewer visible cards fail with the
    JAX engine's "mesh … needs N devices, found M"), ``[cpu] * n`` on the
    CPU. An explicit list may repeat a device (several shards on one card)
    and must be of ``device``'s type. ``sp`` and ``tp`` both above 1 raise
    (not ported)."""
    for name, n in (("sp", sp), ("tp", tp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if sp == 1 and tp == 1:
        return None
    if sp > 1 and tp > 1:
        raise ValueError(f"--sp {sp} together with --tp {tp} is not ported to the "
                         f"PyTorch/CUDA package yet (one of them at a time)")
    name, n, named = ("sp", sp, sp_devices) if sp > 1 else ("tp", tp, tp_devices)
    kind = torch.device(device).type
    devices = (default_devices(device, sp, tp) if named is None
               else [torch.device(d) for d in named])
    if len(devices) != n or any(d.type != kind for d in devices):
        raise ValueError(f"{name}={n} needs {n} {kind} devices, got "
                         f"{[str(d) for d in devices]}")
    for d in devices:
        resolve_device(d)
    return make_mesh({name: n}, devices)



class InferenceEngine:
    """Owns config, parameters and KV cache: on one device, or with ``sp > 1``
    the weights on the lead device and the cache split over ``sp``, or with
    ``tp > 1`` the matmul weights and the cache split over ``tp`` shards
    (``parallel/sharding.py``) and the rest on the lead."""

    def __init__(self, model_path: str, tokenizer_path: str | None = None, *,
                 device="cuda", max_seq_len: int = 0, sync_type: int = F32,
                 compute_dtype: str = "float32", n_batches: int | None = None,
                 temperature: float = 0.0, topp: float = 0.9, seed: int = 0xB1A5,
                 attn_impl: str = "auto", quant_impl: str = "auto",
                 kv_block_size: int = 0, sp: int = 1, sp_devices=None,
                 tp: int | None = None, tp_devices=None,
                 decode_chunk: int = 1, spec_lookup: int = 0, kv_dtype: str = "auto",
                 weight_mode: str = "auto", host_sampling: bool = False,
                 verify_weights: bool = False, numerics_taps: bool = False,
                 numerics_failfast: bool = False, kv_host_blocks: int = 0,
                 quant_mode: str = "auto", profile_split: bool = False):
        from ..ops.linear import QUANT_MODES, turbo_mode

        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, got {compute_dtype!r}")
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {'|'.join(QUANT_MODES)}, "
                             f"got {quant_mode!r}")
        if turbo_mode(quant_mode) is not None and weight_mode != "auto":
            # before the load: turbo requantizes the resident quantized
            # planes, and a dense weight mode has none
            raise ValueError(
                f"--quant-mode turbo/turbo16 requires --weight-mode auto "
                f"with a quantized model (got --weight-mode {weight_mode})")
        self.quant_mode = quant_mode
        # KV cache dtype: "auto" rides the compute dtype; "f8" stores e4m3
        kv_dtypes = {"auto": getattr(torch, compute_dtype), "f32": torch.float32,
                     "bf16": torch.bfloat16, "f8": F8}
        if kv_dtype not in kv_dtypes:
            raise ValueError(f"kv_dtype must be one of {sorted(kv_dtypes)}, got {kv_dtype!r}")
        self.weight_mode = weight_mode  # checked by the loader, before any staging
        # sampling on the host from downloaded logits (the parity oracle):
        # one token a dispatch
        self.host_sampling = bool(host_sampling)
        # multi-step decode: K tokens per dispatch (--decode-chunk)
        self.decode_chunk = 1 if self.host_sampling else max(1, int(decode_chunk))
        # prompt-lookup speculative decode (--spec-lookup, greedy only): K
        # drafted tokens verified per dispatch
        self.spec_lookup = max(0, int(spec_lookup))
        if self.spec_lookup and self.host_sampling:
            raise ValueError("--spec-lookup requires the fused device path "
                             "(drop --host-sampling)")
        if self.spec_lookup and self.decode_chunk > 1:
            raise ValueError("--spec-lookup and --decode-chunk are exclusive "
                             "(both multiply tokens per dispatch)")
        # paged KV serving (--kv-block-size, runtime/kvblocks.py): the
        # combinations the JAX engine refuses are refused before the load
        self.kv_block_size = max(0, int(kv_block_size or 0))
        unsupported = [(f"--spec-lookup > {DECODE_MAX_WIDTH - 1} (verify width K+1 "
                        f"must stay within the decode regime's "
                        f"{DECODE_MAX_WIDTH}-wide dispatches)",
                        self.spec_lookup + 1 > DECODE_MAX_WIDTH),
                       ("--decode-chunk > 1", self.decode_chunk > 1),
                       ("--sp > 1", sp > 1),
                       ("attn_impl='flash' (forced)", attn_impl == "flash")]
        bad = [name for name, hit in unsupported if hit]
        if self.kv_block_size and bad:
            raise ValueError(
                f"--kv-block-size (paged KV serving) does not support "
                f"{', '.join(bad)} yet — drop those flags or drop "
                f"--kv-block-size to use the dense slot pool")
        # tiered KV memory (--kv-host-blocks, runtime/kvblocks.py): a host
        # mirror pool under the paged block pool, validated here and built
        # (and fitted to the host budget) by serving.PagedGenerator
        self.kv_host_blocks = max(0, int(kv_host_blocks or 0))
        if self.kv_host_blocks and not self.kv_block_size:
            raise ValueError(
                "--kv-host-blocks is the paged pool's host spill tier — "
                "it needs --kv-block-size (block-granular KV) to have "
                "blocks to spill")
        self.model_file = ModelFile.open(model_path, max_seq_len=max_seq_len,
                                         sync_type=sync_type)
        self.cfg = replace(ModelConfig.from_header(self.model_file.header,
                                                   compute_dtype=compute_dtype),
                           attn_impl=attn_impl, quant_impl=quant_impl,
                           quant_mode=quant_mode)
        # the block geometry is checked before the load; the pool (built by
        # serving.PagedGenerator) holds K/V at kv_dtype, as the dense cache
        # does
        self.kv_dtype = kv_dtypes[kv_dtype]
        try:
            # sequence parallelism (--sp, parallel/ring.py): the lead device
            # holds the weights, the cache is split over the plan's devices.
            # Tensor parallelism (--tp, parallel/sharding.py): the matmul
            # weights and the cache split over the plan's devices; without
            # --tp the JAX engine's rule picks the largest power of two that
            # the visible cards and the shapes take (1 on the CPU), and 1
            # where tp > 1 is not ported
            self.sp = int(sp)
            gaps = self._tp_gaps(kv_host_blocks)
            if tp is None:
                cards = (torch.cuda.device_count() if torch.device(device).type == "cuda"
                         else 1)
                tp = (len(tp_devices) if tp_devices is not None
                      else 1 if gaps else default_tp(self.cfg, cards, self.sp))
            self.tp = int(tp)
            if self.tp > 1:
                validate_tp(self.cfg, self.tp)
                if gaps:
                    raise ValueError(f"--tp {self.tp} does not support {', '.join(gaps)} "
                                     f"yet (not ported to the PyTorch/CUDA package)")
            self.plan = mesh_plan(device, self.sp, sp_devices, self.tp, tp_devices)
            self.device = self.plan.lead if self.plan else resolve_device(device)
            if self.kv_block_size:
                validate_block_size(self.cfg.seq_len, self.kv_block_size)
            if padded_cache_len(self.cfg.seq_len) % self.sp != 0:
                raise ValueError(
                    f"cache rows {padded_cache_len(self.cfg.seq_len)} not "
                    f"divisible by sp={self.sp} (adjust --max-seq-len)")
        except (ValueError, RuntimeError):
            self.model_file.close()
            raise
        self.n_batches = min(n_batches or DEFAULT_N_BATCHES, self.cfg.seq_len)
        if n_batches is None:
            self.prefill_buckets = tuple(
                b for b in PREFILL_BUCKETS if b <= self.cfg.seq_len) or (self.n_batches,)
        else:
            self.prefill_buckets = (self.n_batches,)
        self.tokenizer = Tokenizer.load(tokenizer_path) if tokenizer_path else None
        self.sampler = Sampler(self.cfg.vocab_size, temperature, topp, seed)
        # the device representation of the weights, for the memory estimate
        wt = self.model_file.header.weight_type
        self.hbm_weight_repr = (weight_mode if weight_mode in ("f32", "bf16")
                                else "q40" if wt == Q40 else "q80" if wt == Q80
                                else "bf16" if self.cfg.compute_dtype == "bfloat16"
                                else "f32")
        # numerics observatory: taps are opt-in (prefill and canary
        # forwards); the tripwire is always on, fail-fast decides whether a
        # poisoned dispatch raises. The JAX engine's refusals of the taps
        # (multihost, pp > 1) have no counterpart here: neither is ported
        self.numerics_taps = bool(numerics_taps)
        self.nf_failfast = bool(numerics_failfast)
        self.canary = None  # numerics.CanarySentinel, wired by the serving layer
        # prefill widths dispatched so far (runtime/hbm.py): the admission
        # guard charges a width not run yet
        self.seen_buckets: set[int] = set()
        # step watchdog: every dispatch below runs under its guard; the batch
        # scheduler registers its fail-all in watchdog.on_stall. Budget shape
        # from the DLLAMA_WATCHDOG* knobs (README, "Failure semantics")
        self.watchdog = StepWatchdog(name=f"engine-{next(_ENGINE_SEQ)}")
        # the compile ledger's scope: every program this engine can run is
        # registered now, as the JAX engine's jitted wrappers are
        self.introspection_scope = self.watchdog.name
        names = ["prefill", "prefill_nll", "decode", "sampled_decode"]
        names += ["prefill_taps"] * self.numerics_taps + ["verify"] * bool(self.spec_lookup)
        self.programs = {n: introspection.Program(self.introspection_scope, n)
                         for n in names}
        # the Eval/Sync split (--profile-split): measured once, at the end
        # of the first generation (measure_split)
        self.profile_split = bool(profile_split)
        self.split = None          # the decode program's EvalSyncSplit
        self.split_prefill = None  # the prefill program's
        self.traffic = None        # one decode step's tp merges (TrafficStats)
        # telemetry: cached metric handles (no registry lookups per step)
        self._tm = telemetry.registry()
        self._m_prefill_ms = self._tm.histogram(telemetry.PREFILL_CHUNK_MS)
        self._m_prefill_tok = self._tm.counter(telemetry.PREFILL_TOKENS)
        self._m_step_ms = self._tm.histogram(telemetry.DECODE_STEP_MS)
        self._m_decode_tok = self._tm.counter(telemetry.DECODE_TOKENS)
        self._m_kv = self._tm.gauge(telemetry.KV_OCCUPANCY)
        # request id stamped onto trace spans by the serving layer (-1 =
        # unattributed); the flight recorder takes the prefill chunk events
        self.trace_rid = -1
        self._flight = flightrec.recorder()
        self.params: Params | None = None
        self.kv = None
        try:
            # the device-memory budget before anything is staged: a model
            # that cannot fit is refused with a clean message, not an
            # out-of-memory error halfway through the load
            est = estimate_device_bytes(self.cfg, weight_repr=self.hbm_weight_repr,
                                        kv_dtype_bytes=self.kv_dtype.itemsize,
                                        n_shards=self.n_shards)
            self.hbm_estimate = est
            limit = check_budget(est["need_per_device"],
                                 f"model {model_path} ({weight_mode})", self.device)
            self._tm.gauge(telemetry.HBM_NEED_BYTES).set(est["need_per_device"])
            self._tm.gauge(telemetry.HBM_LIMIT_BYTES).set(limit or 0)
            if verify_weights:
                # the full sweep before anything is staged on the device
                res = _verify_all(self.model_file)
                if res["corrupt"]:
                    raise WeightIntegrityError(
                        f"--verify-weights: {len(res['corrupt'])} of {res['tensors']} "
                        f"tensors corrupt in {model_path}: " + ", ".join(res["corrupt"]))
            t_load = time.perf_counter()
            self.params = load_params(self.model_file, self.cfg, self.device, weight_mode,
                                      self.plan if self.tp > 1 else None,
                                      turbo=turbo_mode(quant_mode))
            if turbo_mode(quant_mode) is not None:
                from ..ops.turbo import TurboWeight

                wq = self.params.layers[0].wq
                if not isinstance(wq.shards[0] if self.tp > 1 else wq, TurboWeight):
                    raise ValueError(
                        "--quant-mode turbo/turbo16 requires a quantized (Q40/Q80) "
                        "model file — this one loaded dense weights, so there is "
                        "nothing to requantize and reports would mislabel plain "
                        "dense numerics as turbo")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.load_s = time.perf_counter() - t_load  # load (+ turbo derivation)
            self.kv = self._fresh_kv()
        except BaseException as e:
            # atomic failure: no half-built engine, and no device buffer
            # kept alive by the frames of the traceback the caller holds
            self.params = self.kv = None
            self.watchdog.close()
            self.model_file.close()
            traceback.clear_frames(e.__traceback__)
            raise
        self.pos = 0
        # the captured decode steps, keyed by "sampled", and the captured
        # verify step (sp == 1 only)
        self._graphs: dict[bool, DecodeGraph] = {}
        self._verify_graph: VerifyGraph | None = None

    def _tp_gaps(self, kv_host_blocks) -> list[str]:
        """What runs with this engine that ``tp > 1`` does not take yet:
        each is refused at ``--tp N`` and keeps the default tp at 1."""
        gaps = [("--sp > 1", self.sp > 1), ("--kv-host-blocks", bool(kv_host_blocks))]
        return [name for name, hit in gaps if hit]

    @property
    def n_shards(self) -> int:
        """The memory guard's divisor of the weight and KV bytes: a device's
        share of the ``tp`` shards (``[cuda:0] * tp`` holds them all: 1)."""
        if self.tp == 1:
            return 1
        return self.tp // self.plan.shards_per_device

    def _fresh_kv(self):
        """A zeroed cache of the engine's geometry (the canary's scratch)."""
        if self.sp > 1:
            return ShardedKVCache.create(self.cfg, self.plan.devices, dtype=self.kv_dtype)
        if self.tp > 1:
            return HeadShardedKVCache.create(self.cfg, self.plan.devices, dtype=self.kv_dtype)
        return KVCache.create(self.cfg, dtype=self.kv_dtype, device=self.device)

    def _note_bucket(self, width: int) -> None:
        """A prefill chunk of ``width`` rows was dispatched (the padded,
        dispatched width, as the JAX engine records it)."""
        self.seen_buckets.add(width)

    def run_program(self, name: str, tokens: torch.Tensor, fn, **static):
        """``fn()`` as one dispatch of the engine's program ``name`` at the
        width of ``tokens``, filed in the compile ledger the first time it
        runs at that signature (its wall, what K1-K5 move in it and the
        allocator's peak after it, which the admission guard reads)."""
        prog = self.programs[name]
        key = (tuple(tokens.shape), *static.values())
        return prog.run(key, fn, device=self.device, sig=lambda: introspection.signature(
            tokens=tokens, kv=self.kv, **static,
            mesh=introspection.plan_desc(self.plan)))

    def reset(self) -> None:
        self.kv.zero_()
        self.pos = 0
        if self.tokenizer is not None:
            self.tokenizer.reset_decoder()

    def close(self) -> None:
        """Release the device buffers and the model file (the graphs first:
        they hold the parameters' and the cache's addresses)."""
        self._graphs.clear()
        self._verify_graph = None
        self.params = None  # type: ignore[assignment]
        self.kv = None  # type: ignore[assignment]
        self.watchdog.close()
        self.model_file.close()

    # -- low-level steps ----------------------------------------------------

    @contextmanager
    def guarded(self, label: str):
        """One dispatch under the step watchdog, with the ``step_hang``
        failpoint inside the guard (the JAX engine's ``_dispatch``). The
        caller puts the readback inside it too."""
        with self.watchdog.guard(label):
            failpoints.fire("step_hang")
            yield

    def _tokens(self, ids: list[int]) -> torch.Tensor:
        return torch.tensor([ids], dtype=torch.long, device=self.device)

    def _forward(self, ids: list[int], start_pos: int) -> torch.Tensor:
        """One forward over ``ids`` at ``start_pos``: logits ``[1, T, vocab]``."""
        logits, self.kv = forward(self.params, self.cfg, self._tokens(ids),
                                  start_pos, self.kv, self.plan)
        return logits

    def _prefill_chunk_size(self, remaining: int) -> int:
        """Largest prefill bucket that ``remaining`` fills, else the smallest."""
        for b in self.prefill_buckets:  # descending
            if remaining >= b:
                return b
        return self.prefill_buckets[-1]

    def _chunks(self, n: int):
        """``(i, valid, pad_to)`` prefill chunks over ``n`` tokens starting
        at ``self.pos`` (the caller advances ``self.pos``). Padding never
        spills past seq_len: at the context tail it stops at the room left."""
        i, pos = 0, self.pos
        while i < n:
            size = self._prefill_chunk_size(n - i)
            valid = min(size, n - i)
            yield i, valid, min(size, self.cfg.seq_len - pos)
            i += valid
            pos += valid

    def prefill(self, token_ids: list[int]) -> tuple[np.ndarray, list[StepMetrics]]:
        """Evaluate the prompt in bucketed chunks; returns the logits of the
        final prompt token and per-chunk metrics. Advances ``self.pos``."""
        if self.pos + len(token_ids) > self.cfg.seq_len:
            raise ValueError(f"prompt of {len(token_ids)} tokens at position "
                             f"{self.pos} exceeds seq_len {self.cfg.seq_len}")
        metrics: list[StepMetrics] = []
        last = None
        # the span feeds the always-on /debug/requests ring too
        trace_t0 = telemetry.now_ns()
        for i, valid, pad_to in self._chunks(len(token_ids)):
            chunk = token_ids[i:i + valid]
            t0 = time.perf_counter()
            taps = None
            with self.guarded("dispatch"):
                padded = self._tokens(chunk + [0] * (pad_to - valid))
                if self.numerics_taps:
                    def run():
                        (logits, taps), self.kv = forward_with_taps(
                            self.params, self.cfg, padded, self.pos, self.kv, self.plan)
                        return logits[0, valid - 1].cpu().numpy(), numerics.taps_to_host(taps)

                    last, taps = self.run_program("prefill_taps", padded, run)
                else:
                    def run():
                        logits, self.kv = forward(self.params, self.cfg, padded, self.pos,
                                                  self.kv, self.plan)
                        return logits[0, valid - 1].cpu().numpy()  # syncs the device

                    last = self.run_program("prefill", padded, run)
            if taps is not None:
                numerics.record_taps(taps)
            # the host-side tripwire on the one row the next token derives
            # from (already on the host)
            bad = int(last.size - np.count_nonzero(np.isfinite(last)))
            if bad:
                numerics.check_nonfinite(bad, "prefill", failfast=self.nf_failfast)
            self._note_bucket(pad_to)
            ms = (time.perf_counter() - t0) * 1000.0
            metrics.append(StepMetrics("eval", ms, valid))
            self._m_prefill_ms.record(ms)
            self._flight.note("prefill_chunk", self.trace_rid,
                              ms=round(ms, 3), n_tokens=valid, pos=self.pos)
            self.pos += valid
        self._m_prefill_tok.inc(len(token_ids))
        self._m_kv.set(self.pos / self.cfg.seq_len)
        telemetry.tracer().emit(self.trace_rid, "prefill", trace_t0,
                                telemetry.now_ns(), n_tokens=len(token_ids))
        return last, metrics

    def decode_step(self, token: int) -> np.ndarray:
        """One-token decode at the current position; returns logits [vocab]."""
        if self.pos >= self.cfg.seq_len:
            raise ValueError(f"position {self.pos} reached seq_len {self.cfg.seq_len}")
        with self.guarded("dispatch"):
            logits = self._forward([token], self.pos)
            row = logits[0, 0].cpu().numpy()
        self.pos += 1
        bad = int(row.size - np.count_nonzero(np.isfinite(row)))
        if bad:
            numerics.check_nonfinite(bad, "decode", failfast=self.nf_failfast)
        return row

    def next_token(self, token: int) -> int:
        """Forward + argmax (temperature 0) or forward + temperature/top-p
        sample on the device, with the host stepping the xorshift* coin:
        one replay of the captured step (sp == 1) and one 8-byte
        device→host transfer per token."""
        if self.pos >= self.cfg.seq_len:
            raise ValueError(f"position {self.pos} reached seq_len {self.cfg.seq_len}")
        greedy = self.sampler.temperature == 0.0
        t0 = time.perf_counter()
        tok = self._run_chunk(token, self.pos, 1, greedy, self.sampler.temperature,
                              self.sampler.topp, None if greedy else self._coins(1),
                              label="dispatch")
        self._m_step_ms.record((time.perf_counter() - t0) * 1000.0)
        self.commit_chunk(1)
        return tok[0]

    def _coins(self, k: int) -> np.ndarray:
        """The next ``k`` xorshift* coins, the RNG NOT advanced (see
        :meth:`commit_chunk`)."""
        coins = np.empty(k, dtype=np.float32)
        st = self.sampler.rng_state
        for i in range(k):
            coins[i], st = xorshift_random_f32(st)
        return coins

    def decode_step_graph(self, sampled: bool) -> DecodeGraph:
        """The captured single-sequence step (sp == 1), built at its first
        use: on the card the capture warms up at the current position."""
        g = self._graphs.get(sampled)
        if g is None:
            g = DecodeGraph(self.params, self.cfg, self.kv, self.device,
                            sampled=sampled, pos=self.pos,
                            program=self.programs["sampled_decode" if sampled else "decode"])
            self._graphs[sampled] = g
        return g

    def decode_chunk_tokens(self, token: int, k: int) -> list[int]:
        """``k`` decode steps in ONE dispatch (multi-step decode), with each
        picked token fed back on the device and one readback.

        Returns all ``k`` tokens; the caller decides how many to keep (EOS
        truncation) and then calls :meth:`commit_chunk` with that count —
        until committed, ``self.pos`` and the sampler RNG are NOT advanced.
        Overshoot KV rows beyond the committed count are invisible (causal
        mask) and rewritten by the next tokens at those positions — the same
        safety argument as padded prefill tails (module docstring)."""
        k = min(k, self.cfg.seq_len - self.pos)
        if k < 1:
            raise ValueError(f"position {self.pos} reached seq_len {self.cfg.seq_len}")
        greedy = self.sampler.temperature == 0.0
        t0 = time.perf_counter()
        toks = self._run_chunk(token, self.pos, k, greedy, self.sampler.temperature,
                               self.sampler.topp, None if greedy else self._coins(k))
        self._m_step_ms.record((time.perf_counter() - t0) * 1000.0)
        return toks

    def _run_chunk(self, token: int, start_pos: int, k: int, greedy: bool,
                   temp: float, topp: float, coins, label: str = "chunk") -> list[int]:
        """Dispatch ``k`` decode steps from ``token`` at ``start_pos``: ``k``
        replays of the captured step without a mesh, the eager loop at sp > 1
        or tp > 1 (whose shards' steps are not captured yet);
        a sampled token under ``host_sampling`` (``k == 1``) is one eager
        forward whose logits the host samples. The RNG is left for
        :meth:`commit_chunk` to advance in every case. The dispatch and its
        readback run under the watchdog's ``label`` guard; a graph's capture
        (the first decode of its kind) runs before it. The step's non-finite
        count comes back with the tokens (the ``decode`` tripwire site)."""
        if self.host_sampling and not greedy:
            with self.guarded("dispatch"):
                logits, self.kv = forward(self.params, self.cfg, self._tokens([token]),
                                          start_pos, self.kv, self.plan)
                row = logits[0, 0].cpu().numpy()
            bad = int(row.size - np.count_nonzero(np.isfinite(row)))
            if bad:
                numerics.check_nonfinite(bad, "decode", failfast=self.nf_failfast)
            st = self.sampler.rng_state
            tok = self.sampler.sample(row)
            self.sampler.rng_state = st
            return [tok]
        poison = numerics.poison_code()
        if self.plan is None:
            g = self.decode_step_graph(sampled=not greedy)
            with self.guarded(label):
                g.launch(token, start_pos, k, temp, topp, coins, poison)
                toks = g.tokens()
            numerics.check_nonfinite(g.nonfinite, "decode", failfast=self.nf_failfast)
            return toks
        tok0 = torch.tensor([token], dtype=torch.long, device=self.device)

        def run() -> list[int]:
            if greedy:
                toks, nf, self.kv = greedy_steps(self.params, self.cfg, tok0, start_pos,
                                                 self.kv, k, self.plan, poison)
            else:
                toks, nf, self.kv = sampled_steps(self.params, self.cfg, tok0, start_pos,
                                                  self.kv, temp, topp,
                                                  torch.from_numpy(coins).to(self.device),
                                                  k, self.plan, poison)
            return torch.cat([toks[0], nf.long()]).tolist()

        with self.guarded(label):
            got = self.run_program("decode" if greedy else "sampled_decode", tok0, run,
                                   steps=k)
        numerics.check_nonfinite(got[-1], "decode", failfast=self.nf_failfast)
        return got[:-1]

    @property
    def spec_active(self) -> bool:
        """Whether generation uses speculative verify dispatches (the one
        eligibility rule: ``spec_lookup`` set and greedy sampling)."""
        return bool(self.spec_lookup) and self.sampler.temperature == 0.0

    def speculative_tokens(self, token: int, drafts: list[int]) -> list[int]:
        """One speculative verify dispatch (greedy only): returns the
        accepted run of 1..K+1 tokens, what that many single greedy steps
        would emit. Uncommitted like :meth:`decode_chunk_tokens`: the caller
        truncates at EOS and calls :meth:`commit_chunk` with the kept
        count. Rejected-draft KV rows sit past the committed point:
        causal-masked, then overwritten by the next dispatch's K+1 writes,
        which start where they begin."""
        assert self.sampler.temperature == 0.0
        toks = [int(token), *map(int, drafts)]
        assert self.pos + len(toks) <= self.cfg.seq_len
        t0 = time.perf_counter()
        trace_t0 = telemetry.now_ns()
        n_acc, preds = self._run_verify(toks, self.pos)
        telemetry.tracer().emit(self.trace_rid, "verify", trace_t0,
                                telemetry.now_ns(), n_tokens=n_acc + 1)
        self._m_step_ms.record((time.perf_counter() - t0) * 1000.0)
        self._tm.counter(telemetry.SPEC_DRAFT_TOKENS).inc(len(drafts), generator="engine")
        self._tm.counter(telemetry.SPEC_ACCEPTED_TOKENS).inc(n_acc, generator="engine")
        return preds[: n_acc + 1]

    def verify_step_graph(self) -> VerifyGraph:
        """The captured verify step of ``spec_lookup + 1`` tokens (sp == 1),
        built at its first use: on the card the capture warms up at the
        current position."""
        if self._verify_graph is None:
            self._verify_graph = VerifyGraph(self.params, self.cfg, self.kv, self.device,
                                             width=self.spec_lookup + 1, pos=self.pos,
                                             program=self.programs["verify"])
        return self._verify_graph

    def _run_verify(self, tokens: list[int], start_pos: int) -> tuple[int, list[int]]:
        """Dispatch one verify step: a replay of the captured step without
        a mesh, the eager step at sp > 1 (ring / merge attention) or tp > 1.
        Returns ``(n_acc, preds)``. The dispatch and its readback run under
        the watchdog's ``verify`` guard; the graph's capture before it. The
        non-finite count of the K+1 logits rows comes back with them (the
        ``verify`` tripwire site)."""
        poison = numerics.poison_code()
        if self.plan is None:
            g = self.verify_step_graph()
            with self.guarded("verify"):
                n_acc, preds, nf = g.run(tokens, start_pos, poison)
        else:
            toks = self._tokens(tokens)

            def run() -> list[int]:
                n_acc, preds, nf, self.kv = verify_step(self.params, self.cfg, toks,
                                                        start_pos, self.kv, self.plan, poison)
                return torch.cat([n_acc, preds[0], nf.long()]).tolist()

            with self.guarded("verify"):
                got = self.run_program("verify", toks, run)
            n_acc, preds, nf = got[0], got[1:-1], got[-1]
        numerics.check_nonfinite(nf, "verify", failfast=self.nf_failfast)
        return int(n_acc), preds

    def commit_chunk(self, n_keep: int) -> None:
        """Advance position and sampler RNG by the kept prefix of a chunk."""
        self.pos += n_keep
        if self.sampler.temperature != 0.0:
            st = self.sampler.rng_state
            for _ in range(n_keep):
                _, st = xorshift_random_f32(st)
            self.sampler.rng_state = st
        self._m_decode_tok.inc(n_keep)
        self._m_kv.set(self.pos / self.cfg.seq_len)

    # -- the Eval/Sync split (runtime/profiling.py) --------------------------

    def _scratch_step(self, pos: int) -> None:
        """One greedy decode step at ``pos`` that advances nothing, ended by
        a synchronisation: it writes cache row ``pos``, which the next real
        step at ``pos`` rewrites before anything attends it (the argument of
        the JAX engine's scratch dispatches)."""
        tok0 = torch.zeros(1, dtype=torch.long, device=self.device)
        _, nf, self.kv = greedy_steps(self.params, self.cfg, tok0, pos, self.kv, 1,
                                      self.plan, 0.0)
        nf.cpu()

    def collect_traffic(self):
        """The tp merges' traffic of one decode step (``TrafficStats``),
        counted once by ``merge_shards`` over a scratch step at the current
        position; nothing at ``tp == 1``."""
        if self.traffic is None:
            from .profiling import TrafficStats, merge_counts

            if self.tp == 1:
                self.traffic = TrafficStats(0.0, 0.0, 0, {})
            else:
                before = merge_counts()
                self._scratch_step(min(self.pos, self.cfg.seq_len - 1))
                self.traffic = TrafficStats.between(before, merge_counts())
        return self.traffic

    def measure_split(self, n_steps: int = 3):
        """The Eval/Sync split of the decode step and of the widest prefill
        chunk that fits the tail (``--profile-split``), each from a short
        profiler capture of scratch dispatches at the current position that
        advance nothing (:meth:`_scratch_step`; the chunk's rows past
        ``pos`` are rewritten before they become visible). At ``tp == 1``
        no merge runs: the split is 0 and no trace runs, as in the JAX
        engine. Cached on the engine (``split``, ``split_prefill``,
        ``traffic``) and published as the sync and collective gauges."""
        from .profiling import EvalSyncSplit, measure_eval_sync

        self.collect_traffic()
        if not self.traffic:
            self.split = self.split_prefill = EvalSyncSplit(0.0, 0.0, 0, 0)
            self._publish_split_metrics()
            return self.split
        pos = min(self.pos, self.cfg.seq_len - 1)
        self.split = measure_eval_sync(lambda: self._scratch_step(pos), n_steps)
        chunk = next((b for b in self.prefill_buckets if b <= self.cfg.seq_len - pos), None)
        if chunk is not None:
            tokens = torch.zeros((1, chunk), dtype=torch.long, device=self.device)

            def scratch_chunk() -> None:
                logits, self.kv = forward(self.params, self.cfg, tokens, pos, self.kv,
                                          self.plan)
                logits[0, -1, :1].cpu()

            self.split_prefill = measure_eval_sync(scratch_chunk, n_steps)
        self._publish_split_metrics()
        return self.split

    def fill_split(self, steps: list[StepMetrics]) -> None:
        """Each step's ``sync_ms``: its program's sync fraction (decode for
        pred steps, prefill for eval steps) of its wall, the split measured
        once per engine."""
        if self.split is None:
            self.measure_split()
        pfrac = self.split_prefill.sync_frac if self.split_prefill is not None else None
        for s in steps:
            if s.kind == "pred":
                s.sync_ms = s.ms * self.split.sync_frac
            elif pfrac is not None:
                s.sync_ms = s.ms * pfrac

    def _publish_split_metrics(self) -> None:
        """The split and the traffic into the registry: a ``/metrics``
        scrape then carries the reference's per-token picture."""
        if self.traffic is not None:
            self._tm.gauge(telemetry.COLLECTIVE_SENT_KB).set(self.traffic.sent_kb)
            self._tm.gauge(telemetry.COLLECTIVE_RECV_KB).set(self.traffic.recv_kb)
            self._tm.gauge(telemetry.COLLECTIVE_OPS).set(self.traffic.n_collectives)
        if self.split is not None:
            self._tm.gauge(telemetry.SYNC_FRACTION).set(self.split.sync_frac)
            self._tm.gauge(telemetry.COMM_EXPOSED_MS).set(self.split.exposed_ms)
        if self.split_prefill is not None:
            self._tm.gauge(telemetry.SYNC_FRACTION_PREFILL).set(self.split_prefill.sync_frac)

    # -- generation ---------------------------------------------------------

    def generate(self, prompt: str | list[int], max_tokens: int,
                 on_token=None, stop_on_eos: bool = True) -> GenerationResult:
        """Prefill + decode loop (reference flow: dllama.cpp:13-116).

        ``on_token(token_id, piece)`` streams decoded text; ``max_tokens``
        caps generated tokens (the cache cap also applies)."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("a tokenizer is required for str prompts")
            ids = self.tokenizer.encode(prompt, is_start=self.pos == 0)
        else:
            ids = list(prompt)
        if not ids:
            raise ValueError("empty prompt")
        steps: list[StepMetrics] = []
        # evaluate all but the last prompt token; the last one seeds decode
        if len(ids) > 1:
            steps.extend(self.prefill(ids[:-1])[1])
        out_tokens: list[int] = []
        pieces: list[str] = []
        token = ids[-1]
        limit = min(self.cfg.seq_len - self.pos, max_tokens)

        def emit(tok: int) -> bool:
            """Record/stream one token; True when generation should stop."""
            out_tokens.append(tok)
            piece = self.tokenizer.decode(tok) if self.tokenizer else None
            if piece is not None:
                pieces.append(piece)
            if on_token is not None:
                on_token(tok, piece)
            return (stop_on_eos and self.tokenizer is not None
                    and self.tokenizer.is_eos(tok))

        proposer = None
        if self.spec_active:
            proposer = NgramProposer(self.spec_lookup)
            proposer.extend(ids)

        stop = False
        while len(out_tokens) < limit and not stop:
            t0 = time.perf_counter()
            if proposer is not None and self.cfg.seq_len - self.pos >= self.spec_lookup + 1:
                run = self.speculative_tokens(token, proposer.draft())
                width = self.spec_lookup + 1
            else:
                # full-size chunks only (the JAX engine's rule: there a
                # smaller chunk is a fresh compile); tails run chunks of one
                k = self.decode_chunk
                if limit - len(out_tokens) < k or self.cfg.seq_len - self.pos < k:
                    k = 1
                run = self.decode_chunk_tokens(token, k)
                width = len(run)
            run = run[: limit - len(out_tokens)]
            n_keep = len(run)
            if stop_on_eos and self.tokenizer is not None:
                for j, tok in enumerate(run):
                    if self.tokenizer.is_eos(tok):
                        n_keep = j + 1
                        break
            self.commit_chunk(n_keep)
            steps.append(StepMetrics("pred", (time.perf_counter() - t0) * 1000.0, n_keep,
                                     width=width))
            for tok in run[:n_keep]:
                stop = emit(tok)
            if proposer is not None:
                proposer.extend(run[:n_keep])
            token = run[n_keep - 1]
        if self.profile_split and out_tokens and not capture_active():
            # inside a caller's capture (--profile) the caller fills them
            # after it: one profiler session at a time
            self.fill_split(steps)
        return GenerationResult(tokens=out_tokens, text="".join(pieces),
                                prompt_tokens=len(ids), steps=steps)

    def perplexity(self, token_ids: list[int]) -> float:
        """Perplexity of a token sequence (reference mode: dllama.cpp:132-172):
        mean negative log-likelihood of each next token given its prefix.
        The log-softmax runs on the device in float64; only the per-chunk
        sum comes back."""
        if len(token_ids) < 2:
            raise ValueError("perplexity needs at least 2 tokens")
        if len(token_ids) > self.cfg.seq_len:
            raise ValueError("sequence longer than seq_len")
        self.reset()
        nll, count = 0.0, 0
        for i, valid, pad_to in self._chunks(len(token_ids) - 1):
            padded = self._tokens(token_ids[i:i + valid] + [0] * (pad_to - valid))
            targets = torch.tensor(token_ids[i + 1:i + 1 + valid], device=self.device)

            def run() -> float:
                logits, self.kv = forward(self.params, self.cfg, padded, self.pos, self.kv,
                                          self.plan)
                rows = logits[0, :valid].double()
                logp = rows.gather(-1, targets[:, None])[:, 0] - torch.logsumexp(rows, dim=-1)
                return float(logp.sum())

            with self.guarded("dispatch"):
                nll -= self.run_program("prefill", padded, run)
            count += valid
            self.pos += valid
        return float(np.exp(nll / count))

    def score_nll(self, token_ids: list[int]) -> np.ndarray:
        """Teacher-forced per-token NLL of ``token_ids`` — the quality
        observatory's single-sequence oracle (``runtime/evalharness.py``).

        Chunks ``token_ids[:-1]`` through
        :func:`~dllama_tpu_torch.models.llama.prefill_nll` with the bucket
        boundaries and zero padding the batched serving prefill uses, which
        is what makes the batched path's per-token values bit-identical to
        this oracle's. Returns the ``len(token_ids) - 1`` float32 values in
        position order; non-finite values count at the ``eval`` tripwire
        site. Resets the cache and advances ``self.pos``."""
        if len(token_ids) < 2:
            raise ValueError("scoring needs at least 2 tokens")
        if len(token_ids) > self.cfg.seq_len:
            raise ValueError("sequence longer than seq_len")
        self.reset()
        rest = token_ids[:-1]
        out: list[np.ndarray] = []
        for i, valid, pad_to in self._chunks(len(rest)):
            pad = [0] * (pad_to - valid)
            targets = token_ids[i + 1:i + 1 + valid]
            padded = self._tokens(rest[i:i + valid] + pad)

            def run() -> np.ndarray:
                nll, self.kv = prefill_nll(self.params, self.cfg, padded,
                                           self._tokens(targets + pad), self.pos, self.kv,
                                           self.plan)
                return nll[0, :valid].float().cpu().numpy()

            with self.guarded("dispatch"):
                vals = self.run_program("prefill_nll", padded, run)
            bad = int(vals.size - np.count_nonzero(np.isfinite(vals)))
            if bad:
                numerics.check_nonfinite(bad, "eval", failfast=self.nf_failfast)
            out.append(vals)
            self._note_bucket(pad_to)
            self.pos += valid
        return np.concatenate(out)
