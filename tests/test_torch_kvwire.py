"""The port's KV wire (``dllama_tpu_torch/runtime/kvwire.py``) against the
JAX package's: the same frames byte for byte for seeded planes (so replicas
of either package migrate to each other), a decode of either package's
stream by the other, the Q80 codec equal to the port's ``fake_quant_q80``
bitwise, and the codec, stream, failure-taxonomy and ``fetch_kv`` cases of
``tests/test_kvmigrate.py`` run on the port's module against the same
``_StubPeer``. Host only; exact equality throughout."""

from __future__ import annotations

import io
import json
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from dllama_tpu.runtime import kvwire as jkw
from dllama_tpu_torch.ops.linear import fake_quant_q80
from dllama_tpu_torch.runtime import failpoints as fp
from dllama_tpu_torch.runtime import kvwire
from dllama_tpu_torch.runtime import telemetry as tm

from test_kvmigrate import GEOM, _StubPeer


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.registry().clear()
    yield
    fp.registry().clear()


def _mk_blocks(n, seed=0, geom=GEOM):
    rng = np.random.default_rng(seed)
    shape = (geom["n_layers"], geom["n_kv_heads"], geom["block_size"], geom["head_dim"])
    return [(rng.standard_normal(shape).astype(np.float32) * 3,
             rng.standard_normal(shape).astype(np.float32) * 3) for _ in range(n)]


def _stream(mod, blocks, geom=GEOM):
    g = dict(geom, n_blocks=len(blocks), n_tokens=len(blocks) * geom["block_size"])
    buf = io.BytesIO()
    mod.write_stream(buf, g, blocks)
    return buf.getvalue()


@pytest.mark.parametrize("seed,n,dtype", [(0, 1, "float32"), (1, 3, "bfloat16"),
                                          (2, 5, "float8_e4m3fn")])
def test_frames_equal_jax_byte_for_byte(seed, n, dtype):
    geom = dict(GEOM, dtype=dtype)
    blocks = _mk_blocks(n, seed, geom)
    blocks[0][0][0, 0, 0, :] = 0.0  # an all-zero Q80 group
    data = _stream(kvwire, blocks, geom)
    assert data == _stream(jkw, blocks, geom)
    assert kvwire.encode_header(geom) == jkw.encode_header(geom)
    assert kvwire.encode_block(7, *blocks[-1]) == jkw.encode_block(7, *blocks[-1])
    # each package decodes the other's stream to the same planes
    for reader in (kvwire, jkw):
        hdr, rx = reader.read_stream(io.BytesIO(data), geom)
        want = jkw.read_stream(io.BytesIO(data), geom)[1]
        assert hdr["n_blocks"] == n
        for (i, k, v), (wi, wk, wv) in zip(rx, want):
            assert i == wi
            np.testing.assert_array_equal(k, wk)
            np.testing.assert_array_equal(v, wv)


def test_vocabulary_and_constants_equal_jax():
    for name in ("MAGIC", "END_PAYLOAD", "VERSION", "GEOMETRY_KEYS", "FALLBACK_REASONS",
                 "DEFAULT_ATTEMPTS", "DEFAULT_BACKOFF_S", "DEFAULT_DEADLINE_S"):
        assert getattr(kvwire, name) == getattr(jkw, name), name


def test_q80_codec_matches_fake_quant_bitwise():
    """The wire round trip IS one port ``fake_quant_q80`` application: codes
    from the unrounded f32 scale, dequant by the f16-rounded stored scale."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 256)).astype(np.float32) * 5
    x[0, :32] = 0.0  # an all-zero Q80 group decodes to exact zeros
    codes, scales = kvwire.q80_encode(x)
    back = kvwire.q80_decode(codes, scales.reshape(-1, 1), x.shape)
    want = fake_quant_q80(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(back, want)
    jc, js = jkw.q80_encode(x)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales.view(np.uint16), js.view(np.uint16))


def test_stream_roundtrip_counts_and_order():
    blocks = _mk_blocks(3)
    reg = tm.registry()
    tx0 = reg.counter(tm.KVWIRE_TX_FRAMES).total()
    rx0 = reg.counter(tm.KVWIRE_RX_BYTES).total()
    data = _stream(kvwire, blocks)
    hdr, rx = kvwire.read_stream(io.BytesIO(data), GEOM)
    assert hdr["n_tokens"] == 48 and hdr["n_blocks"] == 3
    assert [i for i, _, _ in rx] == [0, 1, 2]
    assert reg.counter(tm.KVWIRE_TX_FRAMES).total() - tx0 == 5
    assert reg.counter(tm.KVWIRE_RX_BYTES).total() - rx0 == len(data)
    for (k, _v), (_, rk, _rv) in zip(blocks, rx):
        ck, sk = kvwire.q80_encode(k)
        np.testing.assert_array_equal(rk, kvwire.q80_decode(ck, sk.reshape(-1, 1), k.shape))


def test_flipped_byte_fails_crc():
    data = bytearray(_stream(kvwire, _mk_blocks(2)))
    data[400] ^= 0x40
    with pytest.raises(kvwire.ChecksumError):
        kvwire.read_stream(io.BytesIO(bytes(data)), GEOM)
    assert kvwire.classify_failure(kvwire.ChecksumError("x")) == "crc"


def test_truncation_is_peer_death():
    data = _stream(kvwire, _mk_blocks(2))
    for cut in (len(data) // 2, len(data) - 6):  # mid-frame, before the end frame
        with pytest.raises(kvwire.TruncatedStream) as e:
            kvwire.read_stream(io.BytesIO(data[:cut]), GEOM)
        assert kvwire.classify_failure(e.value) == "peer_death"


def test_geometry_mismatch_refuses_loudly():
    data = _stream(kvwire, _mk_blocks(1))
    with pytest.raises(kvwire.GeometryMismatch) as e:
        kvwire.read_stream(io.BytesIO(data), dict(GEOM, head_dim=16))
    assert "head_dim" in str(e.value)
    # the dtype is part of the geometry: an f32 peer never feeds a bf16 pool
    with pytest.raises(kvwire.GeometryMismatch, match="dtype"):
        kvwire.read_stream(io.BytesIO(data), dict(GEOM, dtype="bfloat16"))


def test_version_mismatch_refuses():
    body = json.dumps(GEOM).encode()
    hdr = struct.pack(">4sHI", kvwire.MAGIC, kvwire.VERSION + 1, len(body)) + body
    frame = struct.pack(">I", len(hdr)) + hdr + struct.pack(">I", zlib.crc32(hdr))
    with pytest.raises(kvwire.GeometryMismatch):
        kvwire.read_stream(io.BytesIO(frame), GEOM)


def test_expired_deadline_mid_stream():
    data = _stream(kvwire, _mk_blocks(1))
    with pytest.raises(kvwire.DeadlineExceeded) as e:
        kvwire.read_stream(io.BytesIO(data), GEOM, deadline=time.monotonic() - 1.0)
    assert kvwire.classify_failure(e.value) == "timeout"


def test_failpoint_short_read_classifies_crc():
    fp.arm("kvwire", "short_read", times=1)
    with pytest.raises(kvwire.ChecksumError) as e:
        kvwire.read_stream(io.BytesIO(_stream(kvwire, _mk_blocks(1))), GEOM)
    assert kvwire.classify_failure(e.value) == "crc"


def test_failpoint_raise_classifies_peer_death():
    fp.arm("kvwire", "raise", times=1)
    with pytest.raises(fp.FailpointError) as e:
        kvwire.read_stream(io.BytesIO(_stream(kvwire, _mk_blocks(1))), GEOM)
    assert kvwire.classify_failure(e.value) == "peer_death"


def test_fetch_kv_retries_transient_then_succeeds():
    stub = _StubPeer(["reset", _stream(jkw, _mk_blocks(2))])
    try:
        hdr, blocks = kvwire.fetch_kv(stub.peer, [1, 2, 3], GEOM, deadline_s=5.0)
        assert hdr["n_blocks"] == 2 and len(blocks) == 2
        assert stub.n_requests == 2
    finally:
        stub.close()


def test_fetch_kv_exhausts_attempts_on_dead_peer():
    stub = _StubPeer(["reset"] * 4)
    try:
        with pytest.raises((kvwire.KVWireError, OSError)) as e:
            kvwire.fetch_kv(stub.peer, [1], GEOM, deadline_s=5.0, max_attempts=3)
        assert stub.n_requests == 3
        assert kvwire.classify_failure(e.value) == "peer_death"
    finally:
        stub.close()


def test_fetch_kv_integrity_failure_does_not_retry():
    data = bytearray(_stream(jkw, _mk_blocks(2)))
    data[400] ^= 0x40
    stub = _StubPeer([bytes(data), bytes(data)])
    try:
        with pytest.raises(kvwire.ChecksumError):
            kvwire.fetch_kv(stub.peer, [1], GEOM, deadline_s=5.0)
        assert stub.n_requests == 1
    finally:
        stub.close()


def test_fetch_kv_refused_export_is_peer_death():
    stub = _StubPeer(["busy"] * 3)
    try:
        with pytest.raises(kvwire.TruncatedStream) as e:
            kvwire.fetch_kv(stub.peer, [1], GEOM, deadline_s=5.0)
        assert "503" in str(e.value) and kvwire.classify_failure(e.value) == "peer_death"
    finally:
        stub.close()
