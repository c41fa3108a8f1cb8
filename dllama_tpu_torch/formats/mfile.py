""".m model file format — header parse, tensor walker and writer.

The port's own copy of the JAX package's ``formats/mfile.py`` (dense and
mixture-of-experts models, with the ``<model>.m.sums`` checksum sidecar;
the sharded sub-block readers are not ported). Wire-compatible with the reference format (reference:
src/llm.cpp:34-145 for the header parse, src/llm.cpp:499-539 for the tensor
order, converter/writer.py:109-147 for the writer):

    int32 magic = 0xA00ABCD
    int32 headerSize            # total header bytes INCLUDING magic + this field
    (int32 key, int32 value) *  # (headerSize - 8) / 8 pairs
    tensor data ...             # starts at offset headerSize

Tensor order (llm.cpp:499-539): embedding (F32), then per layer
q, k, v, wo, w1(gate), w2(down), w3(up) in the weight float type, Qwen3's
per-head q/k norms (F32), block norms 0/1 (F32); finally final_norm (F32) and
the logits matmul (weight float type).
"""

from __future__ import annotations

import enum
import json
import mmap
import os
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .quants import F16, F32, Q40, Q80, dequantize_q40, dequantize_q80, tensor_bytes

MODEL_MAGIC = 0xA00ABCD

# checksum manifest sidecar (``<model>.m.sums``): per-tensor crc32 of the
# on-disk bytes, verified by the loader. A sidecar (not a trailer) keeps the
# .m byte stream wire-compatible with the reference reader, whose walk
# requires walk-end == file size. The JSON document is the JAX package's, so
# a manifest written by either package loads in the other.
MANIFEST_SUFFIX = ".sums"
MANIFEST_VERSION = 1
MANIFEST_ALGO = "crc32"


class HeaderKey(enum.IntEnum):
    """Header key ids (reference: src/llm.hpp:8-30, plus the JAX package's
    MOE_NORM_TOPK extension)."""

    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHT_FLOAT_TYPE = 13
    ROPE_SCALING_FACTOR = 14
    ROPE_SCALING_LOW_FREQ_FACTOR = 15
    ROPE_SCALING_HIGH_FREQ_FACTORY = 16
    ROPE_SCALING_ORIG_MAX_SEQ_LEN = 17
    ROPE_TYPE = 18
    HEAD_DIM = 19
    NORM_EPSILON = 20
    MOE_NORM_TOPK = 21


class ArchType(enum.IntEnum):
    """Architecture ids (reference: src/llm.hpp:37-40)."""

    LLAMA = 0xABCD00
    QWEN3 = 0xABCD01


class RopeType(enum.IntEnum):
    """RoPE style ids (reference: src/nn/nn-core.hpp rope types)."""

    LLAMA = 0
    FALCON = 1
    LLAMA3_1 = 2


class HiddenAct(enum.IntEnum):
    GELU = 0
    SILU = 1


@dataclass
class ModelHeader:
    """Parsed .m header — the LlmHeader equivalent (reference: src/llm.hpp:42-71)."""

    version: int = 0
    arch_type: ArchType = ArchType.LLAMA
    dim: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    n_experts: int = 0
    n_active_experts: int = 0
    moe_norm_topk: int = 1
    vocab_size: int = 0
    orig_seq_len: int = 0
    seq_len: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    rope_type: RopeType = RopeType.LLAMA
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    norm_epsilon: float = 1e-5
    head_dim: int = 0
    weight_type: int = -1
    sync_type: int = F32
    header_size: int = 0
    file_size: int = 0

    @property
    def q_dim(self) -> int:
        return self.head_dim * self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.n_kv_heads


_NORM_EPS = {5: 1e-5, 6: 1e-6}  # the header stores the exponent (llm.cpp:61-65)

# header key -> (ModelHeader field, decoder)
_FIELDS = {
    HeaderKey.VERSION: ("version", int),
    HeaderKey.ARCH_TYPE: ("arch_type", ArchType),
    HeaderKey.DIM: ("dim", int),
    HeaderKey.HIDDEN_DIM: ("hidden_dim", int),
    HeaderKey.N_LAYERS: ("n_layers", int),
    HeaderKey.N_HEADS: ("n_heads", int),
    HeaderKey.N_KV_HEADS: ("n_kv_heads", int),
    HeaderKey.N_EXPERTS: ("n_experts", int),
    HeaderKey.N_ACTIVE_EXPERTS: ("n_active_experts", int),
    HeaderKey.MOE_NORM_TOPK: ("moe_norm_topk", int),
    HeaderKey.VOCAB_SIZE: ("vocab_size", int),
    HeaderKey.SEQ_LEN: ("seq_len", int),
    HeaderKey.HIDDEN_ACT: ("hidden_act", HiddenAct),
    HeaderKey.ROPE_THETA: ("rope_theta", float),
    HeaderKey.WEIGHT_FLOAT_TYPE: ("weight_type", int),
    HeaderKey.ROPE_SCALING_FACTOR: ("rope_scaling_factor", float),
    HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR: ("rope_scaling_low_freq_factor", float),
    HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY: ("rope_scaling_high_freq_factor", float),
    HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN: ("rope_scaling_orig_max_seq_len", int),
    HeaderKey.ROPE_TYPE: ("rope_type", RopeType),
    HeaderKey.HEAD_DIM: ("head_dim", int),
}


def parse_header(raw: bytes, path_size: int, max_seq_len: int = 0,
                 sync_type: int = F32) -> ModelHeader:
    """Parse the .m header bytes (reference: llm.cpp:67-145)."""
    magic, header_size = struct.unpack_from("<ii", raw, 0)
    if magic in (0xABCD00, 0xABCD01):
        raise ValueError("old model format is not supported")
    if magic != MODEL_MAGIC:
        raise ValueError(f"unsupported magic number {magic:#x}")
    h = ModelHeader()
    for i in range((header_size - 8) // 8):
        key, value = struct.unpack_from("<ii", raw, 8 + i * 8)
        if key == HeaderKey.NORM_EPSILON:
            if value not in _NORM_EPS:
                raise ValueError(f"unsupported norm epsilon code {value}")
            h.norm_epsilon = _NORM_EPS[value]
        elif key in _FIELDS:
            name, conv = _FIELDS[HeaderKey(key)]
            setattr(h, name, conv(value))
        else:
            raise ValueError(f"unsupported header key {key}")

    if h.weight_type == -1:
        raise ValueError("model does not specify weight type")
    h.orig_seq_len = h.seq_len
    if max_seq_len > 0 and h.seq_len > max_seq_len:
        h.seq_len = max_seq_len
    if h.head_dim == 0:
        h.head_dim = h.dim // h.n_heads
    h.sync_type = sync_type
    h.header_size = header_size
    h.file_size = path_size
    if h.arch_type == ArchType.QWEN3:
        h.rope_type = RopeType.FALCON
    return h


@dataclass
class TensorRecord:
    """One tensor's location inside the .m file."""

    name: str
    layer: int
    shape: tuple[int, ...]  # logical (rows, cols); rows = output dim
    float_type: int
    offset: int
    n_bytes: int


@dataclass
class ModelFile:
    """Memory-mapped .m file with a resolved tensor directory (the tensor
    walk of loadLlmNetWeight, reference llm.cpp:499-539)."""

    path: str
    header: ModelHeader
    tensors: dict[str, TensorRecord] = field(default_factory=dict)
    # per-tensor crc32 from the .m.sums sidecar; None when the model has no
    # manifest (such files stay loadable, unverified)
    checksums: dict[str, int] | None = None
    # False for an MoE file without router tensors (the reference
    # converter's layout): it parses, but cannot run
    has_moe_router: bool = True
    _mm: mmap.mmap | None = None
    _file: object | None = None

    @classmethod
    def open(cls, path: str | Path, max_seq_len: int = 0, sync_type: int = F32,
             load_checksums: bool = True) -> "ModelFile":
        """``load_checksums=False`` skips the .m.sums sidecar: the manifest
        writer needs it, since validating the stale sidecar it is about to
        replace would make regeneration circular."""
        path = str(path)
        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            f.close()
            raise
        try:
            header = parse_header(mm[:4096] if len(mm) >= 4096 else mm[:], len(mm),
                                  max_seq_len=max_seq_len, sync_type=sync_type)
            mf = cls(path=path, header=header, _mm=mm, _file=f)
            try:
                mf._walk()
            except ValueError as with_router_err:
                if header.n_experts <= 0:
                    raise
                try:
                    # the reference converter's MoE layout: no router tensors
                    mf._walk(moe_router=False)
                except ValueError:
                    # neither layout fits (a corrupt or truncated file):
                    # surface the router-ful expectation
                    raise with_router_err from None
                mf.has_moe_router = False
            if load_checksums:
                mf.checksums = load_manifest(path, file_size=header.file_size)
        except Exception:
            mm.close()
            f.close()
            raise
        return mf

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()  # type: ignore[attr-defined]
            self._file = None

    def __enter__(self) -> "ModelFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _add(self, name: str, layer: int, shape: tuple[int, ...],
             float_type: int, offset: int, expert: int | None = None) -> int:
        nb = tensor_bytes(float_type, int(np.prod(shape)))
        key = f"{name}.{layer}" if layer >= 0 else name
        if expert is not None:
            key = f"{key}.{expert}"
        self.tensors[key] = TensorRecord(name=name, layer=layer, shape=shape,
                                         float_type=float_type, offset=offset,
                                         n_bytes=nb)
        return nb

    def _walk(self, moe_router: bool = True) -> None:
        h = self.header
        wt = h.weight_type
        off = h.header_size
        self.tensors.clear()
        off += self._add("embedding", -1, (h.vocab_size, h.dim), F32, off)
        for l in range(h.n_layers):
            off += self._add("block_matmul_q", l, (h.q_dim, h.dim), wt, off)
            off += self._add("block_matmul_k", l, (h.kv_dim, h.dim), wt, off)
            off += self._add("block_matmul_v", l, (h.kv_dim, h.dim), wt, off)
            off += self._add("block_matmul_wo", l, (h.dim, h.q_dim), wt, off)
            if h.n_experts > 0:
                # the router (block_moe_gate, f32 [E, dim]) is the JAX
                # package's format extension, then each expert's w3, w1, w2
                # in the reference converter's order (convert-hf.py:73-80)
                if moe_router:
                    off += self._add("block_moe_gate", l, (h.n_experts, h.dim), F32, off)
                for e in range(h.n_experts):
                    off += self._add("block_expert_w3", l, (h.hidden_dim, h.dim), wt, off,
                                     expert=e)
                    off += self._add("block_expert_w1", l, (h.hidden_dim, h.dim), wt, off,
                                     expert=e)
                    off += self._add("block_expert_w2", l, (h.dim, h.hidden_dim), wt, off,
                                     expert=e)
            else:
                off += self._add("block_matmul_w1", l, (h.hidden_dim, h.dim), wt, off)
                off += self._add("block_matmul_w2", l, (h.dim, h.hidden_dim), wt, off)
                off += self._add("block_matmul_w3", l, (h.hidden_dim, h.dim), wt, off)
            if h.arch_type == ArchType.QWEN3:
                off += self._add("block_norm_q", l, (h.head_dim,), F32, off)
                off += self._add("block_norm_k", l, (h.head_dim,), F32, off)
            off += self._add("block_norm_0", l, (h.dim,), F32, off)
            off += self._add("block_norm_1", l, (h.dim,), F32, off)
        off += self._add("final_norm", -1, (h.dim,), F32, off)
        off += self._add("final_matmul_logits", -1, (h.vocab_size, h.dim), wt, off)
        if off != h.file_size:
            raise ValueError(
                f"weight file size mismatch: file has {h.file_size} bytes, "
                f"tensor walk needs {off}")

    def raw(self, key: str) -> memoryview:
        """Zero-copy view of a tensor's on-disk bytes (valid until close)."""
        rec = self.tensors[key]
        assert self._mm is not None, "file closed"
        return memoryview(self._mm)[rec.offset:rec.offset + rec.n_bytes]

    def tensor_crc32(self, key: str) -> int:
        """crc32 of a tensor's raw on-disk bytes (the manifest unit)."""
        return zlib.crc32(self.raw(key)) & 0xFFFFFFFF

    def tensor_f32(self, key: str) -> np.ndarray:
        """A tensor fully dequantized to an owning float32 array of its
        logical shape."""
        rec = self.tensors[key]
        buf = self.raw(key)
        n = int(np.prod(rec.shape))
        if rec.float_type == F32:
            arr = np.frombuffer(buf, dtype=np.float32, count=n).copy()
        elif rec.float_type == F16:
            arr = np.frombuffer(buf, dtype=np.float16, count=n).astype(np.float32)
        elif rec.float_type == Q40:
            arr = dequantize_q40(buf, n)
        elif rec.float_type == Q80:
            arr = dequantize_q80(buf, n)
        else:
            raise ValueError(f"unsupported tensor float type {rec.float_type}")
        return arr.reshape(rec.shape)


def write_header(f, params: dict) -> None:
    """Write the .m header (reference: converter/writer.py:109-147).
    ``params`` maps lower-case :class:`HeaderKey` names to int values."""
    data = b""
    for key, value in params.items():
        data += struct.pack("<ii", int(HeaderKey[key.upper()]), int(value))
    f.write(struct.pack("<i", MODEL_MAGIC))
    f.write(struct.pack("<i", 8 + len(data)))
    f.write(data)


# ---------------------------------------------------------------------------
# Checksum manifest (sidecar <model>.m.sums)
# ---------------------------------------------------------------------------


def manifest_path(path: str | Path) -> str:
    return str(path) + MANIFEST_SUFFIX


def compute_checksums(mf: ModelFile) -> dict[str, int]:
    """crc32 of every tensor's on-disk bytes, keyed by walker key
    (``name[.layer]``): one sequential pass over the mmap."""
    return {key: mf.tensor_crc32(key) for key in mf.tensors}


def write_manifest(path: str | Path, checksums: dict[str, int] | None = None) -> str:
    """Write the checksum sidecar of an existing .m file (``checksums``
    skips the recompute). Atomic: a temp file, then a rename, so a crashed
    writer never leaves a half-manifest that would make a good model look
    corrupt."""
    path = str(path)
    if checksums is None:
        with ModelFile.open(path, load_checksums=False) as mf:
            checksums = compute_checksums(mf)
    out = manifest_path(path)
    doc = {"version": MANIFEST_VERSION, "algo": MANIFEST_ALGO,
           "file_size": os.path.getsize(path), "tensors": checksums}
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
    os.replace(tmp, out)
    return out


def load_manifest(path: str | Path, file_size: int | None = None) -> dict[str, int] | None:
    """The checksum sidecar of a .m file; None when there is none. A
    malformed manifest, one of another algorithm, or a stale one (its
    recorded file size differs from the file's) raises: skipping
    verification because the sidecar rotted would defeat its purpose."""
    mpath = manifest_path(path)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, encoding="utf-8") as f:
            doc = json.load(f)
        algo, tensors = doc["algo"], doc["tensors"]
        recorded = int(doc["file_size"])
        sums = {str(k): int(v) for k, v in tensors.items()}
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"malformed checksum manifest {mpath}: {e} — "
                         f"regenerate it (python -m dllama_tpu_torch verify "
                         f"--model {path} --write) or delete it to load "
                         f"unverified") from e
    if algo != MANIFEST_ALGO:
        raise ValueError(f"checksum manifest {mpath} uses unsupported "
                         f"algo {algo!r} (want {MANIFEST_ALGO!r})")
    actual = os.path.getsize(path) if file_size is None else file_size
    if recorded != actual:
        raise ValueError(
            f"checksum manifest {mpath} is stale or the model is "
            f"truncated: manifest records {recorded} bytes, file has "
            f"{actual} — reconvert, regenerate the manifest, or delete "
            f"it to load unverified")
    return sums
