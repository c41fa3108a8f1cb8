"""Framed, checksummed Q80 wire for paged-KV block migration (the port's own
copy of the JAX package's ``runtime/kvwire.py``: the same frames, byte for
byte, so a JAX replica and a port replica migrate to each other).

A prefix's paged-KV blocks (gathered out of the pool by
``models/llama.gather_kv_blocks`` and read back to the host) travel between
replicas as a stream of length-prefixed frames, each carrying a crc32
trailer. Planes are quantized to Q80 (int8 codes + one f16 scale per
32-value block — 1.0625 B/value), so a migrated prefix carries exactly one
``fake_quant_q80`` application.

Wire layout (all integers big-endian)::

    frame    := u32 payload_len | payload | u32 crc32(payload)
    stream   := header_frame | block_frame * n_blocks | end_frame
    header   := b"DKVW" | u16 version | u32 json_len | geometry JSON
    block    := u32 block_index | k_scales f16 | k_codes i8
                                | v_scales f16 | v_codes i8
    end      := b"DKVW-END"

The geometry JSON names ``n_layers``/``n_kv_heads``/``block_size``/
``head_dim``/``dtype`` (which must match the destination exactly — a
mismatched model or cache layout refuses loudly with
:class:`GeometryMismatch`, never a silent corrupt scatter) plus
``n_blocks``/``n_tokens`` for the transfer itself. The per-frame crc32
catches corruption (:class:`ChecksumError`); a clean EOF before the end
frame is a dead peer (:class:`TruncatedStream`); a per-transfer deadline
bounds the whole fetch (:class:`DeadlineExceeded`). Every failure class
maps onto the ``dllama_kvwire_fallback_total{reason}`` vocabulary through
:func:`classify_failure` — the import side degrades to local recompute,
never to a user-visible error. The ``kvwire`` failpoint fires before each
frame section is read.

Host-side module: numpy + stdlib only (no torch import), so the router
tier and tests can use the codec without a device.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
import time
import urllib.parse
import zlib

import numpy as np

from . import failpoints, telemetry
from ..formats.quants import Q80_BLOCK_SIZE

MAGIC = b"DKVW"
END_PAYLOAD = b"DKVW-END"
VERSION = 1

# the layout facts that must match bit-for-bit between the two pools; a
# transfer's own extent (n_blocks / n_tokens) is deliberately excluded
GEOMETRY_KEYS = ("n_layers", "n_kv_heads", "block_size", "head_dim",
                 "dtype")

# bounded-doubling retry schedule for transient socket errors
DEFAULT_ATTEMPTS = 3
DEFAULT_BACKOFF_S = 0.05
DEFAULT_DEADLINE_S = 10.0

_U32 = struct.Struct(">I")
_HDR = struct.Struct(">4sHI")


class KVWireError(RuntimeError):
    """Base class for every wire failure (all degrade to recompute)."""


class GeometryMismatch(KVWireError):
    """Source and destination disagree on model/cache layout — refused
    loudly before any block is decoded."""


class ChecksumError(KVWireError):
    """A frame's crc32 trailer did not match its payload (corruption or
    an injected short read)."""


class TruncatedStream(KVWireError):
    """EOF before the end frame — the peer died mid-transfer."""


class DeadlineExceeded(KVWireError):
    """The per-transfer deadline expired mid-stream."""


# the closed ``dllama_kvwire_fallback_total{reason}`` vocabulary:
# "timeout" deadline/socket expiry, "crc" integrity or geometry refusal,
# "peer_death" the peer vanished mid-transfer, "exhaustion" the import
# side could not stage blocks (assigned in runtime/serving.py, not here)
FALLBACK_REASONS = ("timeout", "crc", "peer_death", "exhaustion")


def classify_failure(exc: BaseException) -> str:
    """Map a transfer failure onto the closed
    ``dllama_kvwire_fallback_total{reason}`` vocabulary (``exhaustion``
    is assigned by the import side's staging, not here)."""
    if isinstance(exc, (DeadlineExceeded, socket.timeout)):
        return "timeout"
    if isinstance(exc, (ChecksumError, GeometryMismatch)):
        return "crc"
    return "peer_death"


# -- Q80 host codec -----------------------------------------------------------


def q80_encode(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a plane to Q80: int8 codes + f16 scales per 32-block.

    Mirrors the in-graph Q80 quantizer bit for bit on the host: the
    code is ``rint(x / d)`` against the UNROUNDED f32 scale
    ``d = absmax/127`` (half to even, as numpy and torch both round),
    while the stored scale is the f16 rounding of ``d`` — so a wire
    roundtrip equals one in-graph ``fake_quant_q80`` application."""
    flat = np.ascontiguousarray(x, dtype=np.float32)
    assert flat.size % Q80_BLOCK_SIZE == 0, flat.shape
    g = flat.reshape(-1, Q80_BLOCK_SIZE)
    amax = np.max(np.abs(g), axis=-1, keepdims=True)
    d = amax / np.float32(127.0)
    safe = np.where(d != 0.0, d, np.float32(1.0))
    inv = np.where(d != 0.0, np.float32(1.0) / safe, np.float32(0.0))
    codes = np.rint(g * inv).astype(np.int8)
    return codes, d.astype("<f2")  # explicit little-endian f16 on the wire


def q80_decode(codes: np.ndarray, scales: np.ndarray,
               shape: tuple) -> np.ndarray:
    """Dequantize (the one convention: f32 multiply of int8 codes by the
    f16-rounded stored scales)."""
    return (codes.astype(np.float32)
            * scales.astype(np.float32)).reshape(shape)


# -- framing ------------------------------------------------------------------


def _frame(payload: bytes) -> bytes:
    return _U32.pack(len(payload)) + payload + _U32.pack(
        zlib.crc32(payload) & 0xFFFFFFFF)


def encode_header(geometry: dict) -> bytes:
    body = json.dumps(geometry, sort_keys=True).encode()
    return _frame(_HDR.pack(MAGIC, VERSION, len(body)) + body)


def encode_block(index: int, k: np.ndarray, v: np.ndarray) -> bytes:
    """One block frame: ``[L, n_kv, block_size, head_dim]`` k and v
    planes, each as Q80 scales-then-codes."""
    parts = [_U32.pack(index)]
    for plane in (k, v):
        codes, scales = q80_encode(plane)
        parts.append(scales.tobytes())
        parts.append(codes.tobytes())
    return _frame(b"".join(parts))


def decode_block(payload: bytes, geometry: dict) -> tuple[int, np.ndarray,
                                                          np.ndarray]:
    """Inverse of :func:`encode_block` → ``(index, k_f32, v_f32)``."""
    shape = (geometry["n_layers"], geometry["n_kv_heads"],
             geometry["block_size"], geometry["head_dim"])
    n = int(np.prod(shape))
    n_scales = n // Q80_BLOCK_SIZE
    want = _U32.size + 2 * (2 * n_scales + n)
    if len(payload) != want:
        raise ChecksumError(
            f"block frame payload is {len(payload)} B, geometry says "
            f"{want} B — corrupt frame or mismatched stream")
    (index,) = _U32.unpack_from(payload, 0)
    off = _U32.size
    planes = []
    for _ in range(2):
        scales = np.frombuffer(payload, dtype="<f2", count=n_scales,
                               offset=off).astype(np.float16)
        off += 2 * n_scales
        codes = np.frombuffer(payload, dtype=np.int8, count=n,
                              offset=off).reshape(-1, Q80_BLOCK_SIZE)
        off += n
        planes.append(q80_decode(codes, scales.reshape(-1, 1), shape))
    return index, planes[0], planes[1]


def check_geometry(header: dict, expect: dict) -> None:
    """Refuse loudly on any model/layout mismatch before decoding."""
    diffs = [f"{k}: peer={header.get(k)!r} != local={expect[k]!r}"
             for k in GEOMETRY_KEYS if header.get(k) != expect.get(k)]
    if diffs:
        raise GeometryMismatch(
            "peer KV geometry does not match this replica ("
            + "; ".join(diffs) + ") — refusing the transfer; the "
            "prefix will be recomputed locally")


# -- stream writer (export side) ----------------------------------------------


def write_stream(wfile, geometry: dict, blocks) -> int:
    """Serialize header + block + end frames to ``wfile``; returns bytes
    written. ``blocks`` yields ``(k, v)`` plane pairs in prefix order.
    Counts ``dllama_kvwire_tx_*`` as it goes."""
    reg = telemetry.registry()
    c_frames = reg.counter(telemetry.KVWIRE_TX_FRAMES)
    c_bytes = reg.counter(telemetry.KVWIRE_TX_BYTES)
    c_ms = reg.counter(telemetry.KVWIRE_TX_MS)
    t0 = time.monotonic()
    total = 0

    def put(frame: bytes) -> None:
        nonlocal total
        wfile.write(frame)
        total += len(frame)
        c_frames.inc()
        c_bytes.inc(len(frame))

    put(encode_header(geometry))
    for i, (k, v) in enumerate(blocks):
        put(encode_block(i, k, v))
    put(_frame(END_PAYLOAD))
    c_ms.inc(1e3 * (time.monotonic() - t0))
    return total


# -- stream reader (import side) ----------------------------------------------


def _read_exact(rfile, n: int, deadline: float | None) -> bytes:
    """Read exactly ``n`` bytes or raise; fires the ``kvwire`` failpoint
    once per call (i.e. per frame section) so chaos tests can sever,
    truncate, or stall the stream deterministically."""
    try:
        failpoints.fire("kvwire")
    except failpoints.ShortReadError as e:
        # an injected short read is a truncated/corrupt frame: it must
        # surface as an INTEGRITY failure (fallback reason "crc"), the
        # same class a flipped bit lands in via the crc32 trailer
        raise ChecksumError(
            "kvwire frame truncated by injected short read") from e
    if deadline is not None and time.monotonic() > deadline:
        raise DeadlineExceeded(
            f"KV transfer deadline expired mid-stream "
            f"({n} B read still pending)")
    chunks: list[bytes] = []
    got = 0
    while got < n:
        chunk = rfile.read(n - got)
        if not chunk:
            raise TruncatedStream(
                f"peer closed the stream {n - got} B short of a frame "
                f"boundary (after {got} B)")
        chunks.append(chunk)
        got += len(chunk)
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceeded(
                "KV transfer deadline expired mid-stream")
    return b"".join(chunks)


def _read_frame(rfile, deadline: float | None) -> bytes:
    head = _read_exact(rfile, _U32.size, deadline)
    (length,) = _U32.unpack(head)
    body = _read_exact(rfile, length + _U32.size, deadline)
    payload, crc = body[:length], body[length:]
    (want,) = _U32.unpack(crc)
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != want:
        raise ChecksumError(
            f"frame crc32 {got:#010x} != trailer {want:#010x} "
            f"({length} B payload) — corrupt frame")
    return payload


def read_stream(rfile, expect_geometry: dict,
                deadline: float | None = None) -> tuple[dict, list]:
    """Read one full stream → ``(header, [(index, k_f32, v_f32), ...])``.

    Verifies the magic/version/geometry header before decoding any
    block, every frame's crc32, and the end frame's presence (a clean
    EOF without it is a dead peer). Counts ``dllama_kvwire_rx_*``."""
    reg = telemetry.registry()
    c_frames = reg.counter(telemetry.KVWIRE_RX_FRAMES)
    c_bytes = reg.counter(telemetry.KVWIRE_RX_BYTES)
    c_ms = reg.counter(telemetry.KVWIRE_RX_MS)
    t0 = time.monotonic()

    def frame() -> bytes:
        payload = _read_frame(rfile, deadline)
        c_frames.inc()
        c_bytes.inc(len(payload) + 2 * _U32.size)
        return payload

    head = frame()
    if len(head) < _HDR.size:
        raise ChecksumError(f"header frame is {len(head)} B, below the "
                            f"fixed header size {_HDR.size} B")
    magic, version, json_len = _HDR.unpack_from(head, 0)
    if magic != MAGIC:
        raise ChecksumError(f"bad stream magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise GeometryMismatch(
            f"peer speaks KV-wire v{version}, this replica v{VERSION} — "
            f"refusing the transfer")
    try:
        header = json.loads(head[_HDR.size:_HDR.size + json_len])
    except ValueError as e:
        raise ChecksumError(f"unparseable geometry JSON: {e}") from e
    check_geometry(header, expect_geometry)
    blocks: list = []
    for _ in range(int(header.get("n_blocks", 0))):
        blocks.append(decode_block(frame(), header))
    if frame() != END_PAYLOAD:
        raise TruncatedStream("stream did not end with the end frame — "
                              "the peer died after the last block")
    c_ms.inc(1e3 * (time.monotonic() - t0))
    return header, blocks


# -- HTTP fetch client (import side) ------------------------------------------


def _peer_hostport(peer: str) -> tuple[str, int]:
    """``http://host:port`` or bare ``host:port`` → ``(host, port)``."""
    if "//" not in peer:
        peer = "http://" + peer
    u = urllib.parse.urlparse(peer)
    if not u.hostname or not u.port:
        raise ValueError(f"peer {peer!r} is not host:port-shaped")
    return u.hostname, u.port


def fetch_kv(peer: str, tokens: list, expect_geometry: dict,
             deadline_s: float = DEFAULT_DEADLINE_S,
             max_attempts: int = DEFAULT_ATTEMPTS,
             backoff_s: float = DEFAULT_BACKOFF_S) -> tuple[dict, list]:
    """POST ``/v1/kv/export`` on ``peer`` and read the frame stream.

    Transient socket errors (connect refused/reset, a peer dying
    mid-stream) retry the whole transfer with bounded-doubling backoff,
    inside the one per-transfer deadline; integrity failures (crc,
    geometry) and the deadline itself do NOT retry — a corrupt source
    or an exhausted budget both mean "recompute locally now". Raises a
    :class:`KVWireError` subclass (or ``OSError``) on failure; the
    caller maps it via :func:`classify_failure`."""
    deadline = time.monotonic() + deadline_s
    body = json.dumps({"tokens": list(tokens)}).encode()
    host, port = _peer_hostport(peer)
    last: BaseException | None = None
    for attempt in range(max_attempts):
        if attempt:
            delay = min(backoff_s * (2 ** (attempt - 1)),
                        max(0.0, deadline - time.monotonic()))
            if delay <= 0 or time.monotonic() + delay > deadline:
                break
            time.sleep(delay)
        conn = http.client.HTTPConnection(
            host, port, timeout=max(0.05, deadline - time.monotonic()))
        try:
            conn.request("POST", "/v1/kv/export", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                detail = resp.read(256).decode(errors="replace")
                raise TruncatedStream(
                    f"peer {peer} refused the export: HTTP "
                    f"{resp.status} {detail!r}")
            return read_stream(resp, expect_geometry, deadline)
        except (ChecksumError, GeometryMismatch, DeadlineExceeded):
            raise
        except (OSError, KVWireError) as e:
            last = e
        finally:
            conn.close()
        if time.monotonic() > deadline:
            break
    raise last if last is not None else TruncatedStream(
        f"KV fetch from {peer} exhausted its deadline before a "
        f"single attempt completed")
