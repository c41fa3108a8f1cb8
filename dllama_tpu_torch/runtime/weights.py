"""Weight loader: ``.m`` tensors → device parameters (the port of the JAX
package's ``runtime/weights.py`` ``load_params`` and its streaming loader).

Each tensor is read once from the memory-mapped file and shipped to the
device as raw bytes; Q40/Q80 blocks are unpacked there into the K-major
planes of :class:`~dllama_tpu_torch.ops.linear.QuantizedWeight` (codes int8
``[in, out]``, scales ``[in/32, out]``), so the host never holds more than
one tensor's bytes and the unpack/transpose runs at device speed. Layout and
numerics follow the JAX loader:

* Q40/Q80 matmul weights stay quantized; scales are f32 in exact configs
  and bf16 in fast configs (fast numerics round the dequant to bf16 anyway);
* the logits head follows the dense-vs-quantized rule (:func:`dense_logits_wanted`):
  fast configs hold it as a dense bf16 ``[vocab, dim]`` matrix, exact
  configs keep the Q40 planes;
* dense (F32/F16) weights load as f32 ``[out, in]``;
* the embedding is stored at the compute dtype (it is only ever read as
  ``embedding[tokens].to(compute_dtype)``), norms as f32;
* mixture-of-experts layers load the router (``block_moe_gate``, f32 ``[E,
  dim]``) and each expert projection as one IN-major stack ``[E, in, out]``
  (:meth:`_Loader.experts`): Q40/Q80 experts stay quantized (a stacked
  QuantizedWeight, ~1.125 bytes a weight on the device), their E tensors
  copied into one device buffer and unpacked together there; dense files load the stacks at the compute dtype. A file
  without router tensors (the reference converter's layout) is refused.

The quant mode (``cfg.quant_mode``, :func:`fast_numerics_resolved`) decides
the fast/exact storage above; turbo modes load like fast (bf16 scales, dense
head), and the engine then derives the turbo planes (``ops/turbo.py``).

``weight_mode`` (``--weight-mode``) is ``"auto"`` (the above) or
``"f32"``/``"bf16"``: every matmul weight dequantized to a dense ``[out,
in]`` matrix, the JAX loader's values bit for bit (f32 is ``code * scale``
in f32, bf16 that product rounded to nearest even), the head bf16 under
fast numerics. Each tensor is dequantized on the device right after its
planes are unpacked and the planes are dropped before the next one, so the
peak is the dense model plus one tensor's planes. ``"offload"`` (host-DRAM
weight streaming) is not ported and is refused.

On a card every tensor's bytes go from the file's memory map into one of
two page-locked staging slots (:data:`STAGE_BYTES` each) and from there to
the device without blocking, so the copy of one slot overlaps the transfer
of the other: one host copy a byte, and no pageable transfer.

Integrity: every tensor is read through :class:`ResilientReader`, which
crc-checks it against the ``.m.sums`` manifest once, before its first read,
and retries a read that raises ``OSError`` (the ``load_read`` failpoint
injects one; ``dllama_weight_io_retries_total`` counts the retries, and
``dllama_load_corruption_total`` every tensor that fails its checksum);
:func:`verify_weights` is the offline sweep of ``verify`` and
``--verify-weights``.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..formats.mfile import ArchType, ModelFile
from ..formats.quants import (F16, F32, Q40, Q40_BLOCK_BYTES, Q80, Q80_BLOCK_BYTES,
                              QUANT_BLOCK_SIZE)
from ..models.config import ModelConfig
from ..models.llama import LayerParams, Params, rope_tables
from ..ops.linear import (Q40_CODES, Q80_CODES, QuantizedWeight, dequantize_weight,
                          fast_numerics_resolved)
from . import failpoints, telemetry


WEIGHT_MODES = ("auto", "f32", "bf16")
# bytes of each of the loader's two page-locked staging slots
STAGE_BYTES = 32 << 20


class WeightIntegrityError(RuntimeError):
    """A weight tensor's bytes do not match the checksum manifest. The
    message names the tensor. Not retried: the bytes are wrong, not the
    read."""


class WeightLoadError(RuntimeError):
    """A weight read kept failing past the bounded retry budget."""


class ResilientReader:
    """Integrity and transient-retry layer over :class:`ModelFile` reads (the
    JAX package's ``ResilientReader``): every tensor the loader reads goes
    through it.

    * With a ``.m.sums`` manifest, each tensor's on-disk bytes are
      crc32-verified once, before its first read; a mismatch raises
      :class:`WeightIntegrityError` naming the tensor.
    * An ``OSError`` out of a read is retried up to ``max_retries`` times
      with doubling backoff; exhaustion raises :class:`WeightLoadError`
      carrying the original error. Other failures propagate at once."""

    def __init__(self, mf: ModelFile, *, max_retries: int = 3, backoff_s: float = 0.05):
        self.mf = mf
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._verified: set[str] = set()

    def _verify(self, key: str) -> None:
        sums = self.mf.checksums
        if sums is None or key in self._verified:
            return
        want = sums.get(key)
        if want is None:
            raise WeightIntegrityError(
                f"weight tensor {key!r} has no entry in the checksum manifest "
                f"({self.mf.path}.sums) — the manifest does not belong to this "
                f"file; regenerate it or delete it to load unverified")
        got = self.mf.tensor_crc32(key)
        if got != want:
            telemetry.registry().counter(telemetry.LOAD_CORRUPTION).inc()
            raise WeightIntegrityError(
                f"weight tensor {key!r} is corrupt: crc32 {got:#010x} != "
                f"manifest {want:#010x} ({self.mf.path}) — the file is "
                f"damaged; re-download or reconvert it")
        self._verified.add(key)

    def _read(self, key: str, fn: Callable, *args):
        delay, attempt = self.backoff_s, 0
        while True:
            try:
                failpoints.fire("load_read")
                self._verify(key)
                return fn(key, *args)
            except OSError as e:
                if attempt >= self.max_retries:
                    raise WeightLoadError(
                        f"reading weight tensor {key!r} failed after {attempt} "
                        f"retries: {type(e).__name__}: {e}") from e
                attempt += 1
                telemetry.registry().counter(telemetry.WEIGHT_IO_RETRIES).inc()
                time.sleep(delay)
                delay *= 2

    def raw(self, key: str) -> np.ndarray:
        """A tensor's on-disk bytes as an owning ``uint8`` array."""
        return self.read(key, lambda view: np.frombuffer(view, dtype=np.uint8).copy())

    def read(self, key: str, fn: Callable):
        """``fn(view)`` of a tensor's on-disk bytes (a zero-copy memoryview
        of the file) under the integrity check and the retry budget."""
        return self._read(key, lambda k: fn(self.mf.raw(k)))


def verify_weights(mf: ModelFile, emit=None) -> dict:
    """Offline full-file verification (``verify``, ``--verify-weights``):
    crc-check every tensor against the manifest. Returns ``{"tensors": n,
    "corrupt": [keys...]}``; raises :class:`WeightIntegrityError` when the
    model has no manifest."""
    if mf.checksums is None:
        raise WeightIntegrityError(
            f"{mf.path} has no checksum manifest ({mf.path}.sums) — generate "
            f"one with: python -m dllama_tpu_torch verify --model {mf.path} --write")
    corrupt: list[str] = []
    for key in mf.tensors:
        want = mf.checksums.get(key)
        got = mf.tensor_crc32(key)
        ok = want is not None and got == want
        if not ok:
            corrupt.append(key)
            telemetry.registry().counter(telemetry.LOAD_CORRUPTION).inc()
        if emit is not None:
            emit(f"{'✅' if ok else '❌'} {key}: crc32 {got:#010x}"
                 + ("" if ok else f" != manifest "
                    f"{'-' if want is None else format(want, '#010x')}"))
    return {"tensors": len(mf.tensors), "corrupt": corrupt}


def dense_logits_wanted(fast_numerics: bool) -> bool:
    """Whether the logits head loads as a resident dense bf16 matrix: fast
    configs trade ``vocab*dim`` extra bytes for a dense head; exact configs
    keep the quantized head (their goldens are tied to the f32 dequant)."""
    return fast_numerics


def unpack_planes(raw: torch.Tensor, float_type: int, out_dim: int, in_dim: int,
                  scale_dtype) -> QuantizedWeight:
    """Q40/Q80 wire bytes (``uint8`` on any device, out-major blocks; leading
    axes stack tensors, ``[E, n_bytes]`` for an expert stack) → the K-major
    planes, computed where ``raw`` lives; ``kind`` records the file's type,
    so that Q80 codes are never read as Q40 nibbles."""
    lead = raw.shape[:-1]
    nb = in_dim // QUANT_BLOCK_SIZE
    per = Q40_BLOCK_BYTES if float_type == Q40 else Q80_BLOCK_BYTES
    blocks = raw.reshape(*lead, out_dim, nb, per)
    scales = blocks[..., :2].contiguous().view(torch.float16).reshape(*lead, out_dim, nb)
    payload = blocks[..., 2:]
    if float_type == Q40:
        lo = (payload & 0x0F).to(torch.int8) - 8  # elements 0..15 of the block
        hi = (payload >> 4).to(torch.int8) - 8    # elements 16..31
        codes = torch.cat([lo, hi], dim=-1)
    else:
        codes = payload.contiguous().view(torch.int8)
    return QuantizedWeight(
        scales=scales.transpose(-1, -2).to(scale_dtype).contiguous(),
        codes=codes.reshape(*lead, out_dim, in_dim).transpose(-1, -2).contiguous(),
        kind=Q40_CODES if float_type == Q40 else Q80_CODES)


class _Loader:
    def __init__(self, mf: ModelFile, cfg: ModelConfig, device, weight_mode: str = "auto"):
        if weight_mode not in WEIGHT_MODES:
            raise ValueError(f"weight_mode must be one of {'|'.join(WEIGHT_MODES)}, got "
                             f"{weight_mode!r} (offload is not ported)")
        self.mf, self.cfg, self.device = mf, cfg, torch.device(device)
        self.rd = ResilientReader(mf)
        self.fast = fast_numerics_resolved(cfg.compute_dtype, cfg.quant_mode)
        self.scale_dtype = torch.bfloat16 if self.fast else torch.float32
        # dense modes: every quantized matmul weight dequantized to this dtype
        self.dense = {"auto": None, "f32": torch.float32, "bf16": torch.bfloat16}[weight_mode]
        # the card's two page-locked staging slots, each with the event of
        # its last transfer (:meth:`_to_card`), and the slot to fill next
        self._slots: list = []
        self._next_slot = 0

    def _raw(self, key: str) -> torch.Tensor:
        """A tensor's verified on-disk bytes as a uint8 tensor on the device."""
        if self.device.type == "cuda":
            return self._to_card([key], self.mf.tensors[key].n_bytes)[0]
        return torch.from_numpy(self.rd.raw(key)).to(self.device)

    def _to_card(self, keys: list[str], n_bytes: int) -> torch.Tensor:
        """The verified bytes of ``keys`` (``n_bytes`` each) as ``uint8
        [len(keys), n_bytes]`` on the card, through the staging slots: each
        piece is copied from the memory map into the slot whose previous
        transfer has run, then transferred without blocking."""
        out = torch.empty(len(keys) * n_bytes, dtype=torch.uint8, device=self.device)
        if not self._slots:
            self._slots = [[torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True),
                            None] for _ in range(2)]

        def stage(view, base: int) -> None:
            src = np.frombuffer(view, dtype=np.uint8)
            for off in range(0, src.size, STAGE_BYTES):
                m = min(STAGE_BYTES, src.size - off)
                slot = self._slots[self._next_slot]
                self._next_slot ^= 1
                if slot[1] is not None:
                    slot[1].synchronize()
                np.copyto(slot[0].numpy()[:m], src[off:off + m])
                out[base + off:base + off + m].copy_(slot[0][:m], non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record()

        for i, k in enumerate(keys):
            self.rd.read(k, lambda view, base=i * n_bytes: stage(view, base))
        return out.view(len(keys), n_bytes)

    def f32(self, key: str, dtype=torch.float32) -> torch.Tensor:
        rec = self.mf.tensors[key]
        if rec.float_type != F32:
            raise ValueError(f"{key}: expected F32, file has type {rec.float_type}")
        return self._raw(key).view(torch.float32).reshape(rec.shape).to(dtype)

    def matmul(self, key: str, *, force_dense=None):
        """One matmul weight: Q40/Q80 → planes, or under a dense weight mode
        (or ``force_dense``, a dtype) a dense ``[out, in]`` matrix of that
        dtype; F32/F16 → dense ``[out, in]`` (f32, or the dense mode's
        dtype)."""
        rec = self.mf.tensors[key]
        out_dim, in_dim = rec.shape
        dense = force_dense or self.dense
        if rec.float_type in (Q40, Q80):
            qw = unpack_planes(self._raw(key), rec.float_type, out_dim, in_dim,
                               self.scale_dtype if dense is None else torch.float32)
            if dense is None:
                return qw
            # f32 dequant of the f16 scales (code * scale in f32), then the
            # target dtype: the JAX loader's dense weights
            # (tensor_f32_rows(...).astype(dtype))
            return dequantize_weight(qw, torch.float32).to(dense).t().contiguous()
        raw = self._raw(key)
        if rec.float_type == F32:
            w = raw.view(torch.float32)
        elif rec.float_type == F16:
            w = raw.view(torch.float16).float()
        else:
            raise ValueError(f"{key}: unsupported weight type {rec.float_type}")
        return w.reshape(out_dim, in_dim).to(dense or torch.float32)

    def experts(self, name: str, layer: int):
        """One layer's expert stack of ``name`` (``block_expert_w1|w2|w3``),
        IN-major ``[E, in, out]``: the E tensors' verified bytes in one host
        buffer, one copy to the device, unpacked there together. Q40/Q80
        stays quantized (a stacked QuantizedWeight) unless a dense weight
        mode dequantizes it (f32 ``code * scale``, then the mode's dtype);
        F32/F16 files load at the dense mode's dtype, else the compute
        dtype (the JAX loader's ``expert_stack``)."""
        E = self.mf.header.n_experts
        keys = [f"{name}.{layer}.{e}" for e in range(E)]
        rec = self.mf.tensors[keys[0]]
        out_dim, in_dim = rec.shape
        raw = self._stacked_raw(keys, rec.n_bytes)
        if rec.float_type in (Q40, Q80):
            qw = unpack_planes(raw, rec.float_type, out_dim, in_dim,
                               self.scale_dtype if self.dense is None else torch.float32)
            if self.dense is None:
                return qw
            return dequantize_weight(qw, torch.float32).to(self.dense)
        if rec.float_type == F32:
            w = raw.view(torch.float32)
        elif rec.float_type == F16:
            w = raw.view(torch.float16).float()
        else:
            raise ValueError(f"{keys[0]}: unsupported weight type {rec.float_type}")
        target = self.dense or getattr(torch, self.cfg.compute_dtype)
        return w.reshape(E, out_dim, in_dim).transpose(1, 2).to(target).contiguous()

    def _stacked_raw(self, keys: list[str], n_bytes: int) -> torch.Tensor:
        """The verified bytes of ``keys`` (tensors of ``n_bytes`` each) as a
        ``uint8 [len(keys), n_bytes]`` tensor on the device."""
        if self.device.type == "cuda":
            return self._to_card(keys, n_bytes)
        out = torch.empty((len(keys), n_bytes), dtype=torch.uint8)
        for i, k in enumerate(keys):
            self.rd.read(k, lambda view, row=out[i].numpy(): np.copyto(
                row, np.frombuffer(view, dtype=np.uint8)))
        return out


def load_params(mf: ModelFile, cfg: ModelConfig, device="cpu",
                weight_mode: str = "auto", plan=None, turbo: str | None = None) -> Params:
    """Build device parameters from an open ``.m`` file. ``weight_mode``:
    ``"auto"`` keeps Q40/Q80 weights as planes, ``"f32"``/``"bf16"``
    dequantize them to dense matrices (the JAX loader's rule for the head:
    dense bf16 under fast numerics, else the mode's dtype). ``turbo``
    (``"a8"``/``"a16"``, ``--quant-mode turbo|turbo16``): each layer's
    quantized planes are requantized to turbo planes as soon as the layer is
    loaded (``ops/turbo.py::turbo_layer``), and so is a quantized head. Under
    a ``plan`` (``device`` is its lead) each layer is cut into its shards
    after that (``parallel/sharding.py``: the dense matmuls over ``tp``, an
    MoE layer's expert stacks over the ``(ep, tp)`` grid), and the head
    after the layers, so that no more than one whole layer is resident
    twice."""
    h = mf.header
    moe = h.n_experts > 0
    if moe and not mf.has_moe_router:
        raise ValueError(
            "MoE model file has no router tensors (written by the reference "
            "converter, which never emits block_moe_gate) — reconvert with "
            "python -m dllama_tpu.convert")
    ld = _Loader(mf, cfg, device, weight_mode)
    head_dense = torch.bfloat16 if dense_logits_wanted(ld.fast) else None
    qwen3 = h.arch_type == ArchType.QWEN3
    if plan is not None:
        from ..parallel.sharding import shard_layer, shard_weight
    if turbo is not None:
        from ..ops.turbo import derive_turbo, turbo_layer
    layers = []
    for l in range(h.n_layers):
        lp = LayerParams(
            wq=ld.matmul(f"block_matmul_q.{l}"), wk=ld.matmul(f"block_matmul_k.{l}"),
            wv=ld.matmul(f"block_matmul_v.{l}"), wo=ld.matmul(f"block_matmul_wo.{l}"),
            w1=None if moe else ld.matmul(f"block_matmul_w1.{l}"),
            w2=None if moe else ld.matmul(f"block_matmul_w2.{l}"),
            w3=None if moe else ld.matmul(f"block_matmul_w3.{l}"),
            norm_att=ld.f32(f"block_norm_0.{l}"), norm_ffn=ld.f32(f"block_norm_1.{l}"),
            norm_q=ld.f32(f"block_norm_q.{l}") if qwen3 else None,
            norm_k=ld.f32(f"block_norm_k.{l}") if qwen3 else None,
            moe_gate=ld.f32(f"block_moe_gate.{l}") if moe else None,
            we1=ld.experts("block_expert_w1", l) if moe else None,
            we2=ld.experts("block_expert_w2", l) if moe else None,
            we3=ld.experts("block_expert_w3", l) if moe else None)
        if turbo is not None:
            turbo_layer(lp, a8=turbo == "a8")
        layers.append(shard_layer(plan, lp) if plan is not None else lp)
    logits = ld.matmul("final_matmul_logits", force_dense=head_dense)
    if turbo is not None and isinstance(logits, QuantizedWeight):
        logits = derive_turbo(logits, a8=turbo == "a8")
    if plan is not None and plan.axis_size("tp") > 1:
        logits = shard_weight(plan, logits, "out")
    return Params(
        embedding=ld.f32("embedding", dtype=getattr(torch, cfg.compute_dtype)),
        layers=layers,
        final_norm=ld.f32("final_norm"),
        logits=logits,
        rope=rope_tables(cfg, device),
    )
