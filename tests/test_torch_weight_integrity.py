"""The port's weight integrity against the JAX package's on the CPU: the
``<model>.m.sums`` checksum manifest (``formats/mfile.py``), the loader's
verify-once and bounded-retry reader (``runtime/weights.py``
``ResilientReader``), the offline sweep (``verify_weights``, ``python -m
dllama_tpu_torch verify``) and the engine's ``verify_weights`` — each test
of ``tests/test_weight_integrity.py`` held against the port, plus two
cross-package checks: a manifest written by either package loads in the
other, and both compute the same crc32 for every tensor."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import helpers
from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import quants
from dllama_tpu.serve.cli import main as jax_main
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.runtime.weights import (ResilientReader, WeightIntegrityError,
                                              WeightLoadError, unpack_planes, verify_weights)
from dllama_tpu_torch.serve.cli import main


def _model(tmp_path, name="m.m", seed=5, manifest=True, **hdr):
    p = tmp_path / name
    helpers.write_tiny_model(p, helpers.tiny_header_params(**hdr),
                             np.random.default_rng(seed))
    if manifest:
        mfile.write_manifest(p)
    return p


def _flip(path, key, byte_off=3):
    with mfile.ModelFile.open(path, load_checksums=False) as mf:
        rec = mf.tensors[key]
    with open(path, "r+b") as f:
        f.seek(rec.offset + byte_off)
        b = f.read(1)
        f.seek(rec.offset + byte_off)
        f.write(bytes([b[0] ^ 0x40]))


# -- manifest format ----------------------------------------------------------


def test_manifest_roundtrip_and_open_picks_it_up(tmp_path):
    p = _model(tmp_path)
    with mfile.ModelFile.open(p) as mf:
        assert mf.checksums is not None
        assert set(mf.checksums) == set(mf.tensors)
        assert mf.checksums == mfile.compute_checksums(mf)


def test_missing_manifest_loads_unverified(tmp_path):
    p = _model(tmp_path, manifest=False)
    with mfile.ModelFile.open(p) as mf:
        assert mf.checksums is None


def test_stale_manifest_rejected(tmp_path):
    p = _model(tmp_path)
    # the model is rewritten at another size, the old manifest left behind
    helpers.write_tiny_model(p, helpers.tiny_header_params(n_layers=3),
                             np.random.default_rng(9))
    with pytest.raises(ValueError, match="stale|truncated"):
        mfile.ModelFile.open(p)


def test_stale_manifest_is_regenerable(tmp_path):
    """``verify --write`` (what the stale-manifest error tells the user to
    run) bypasses the sidecar it replaces."""
    p = _model(tmp_path)
    helpers.write_tiny_model(p, helpers.tiny_header_params(n_layers=3),
                             np.random.default_rng(9))
    assert main(["verify", "--model", str(p), "--write"]) == 0
    assert main(["verify", "--model", str(p)]) == 0
    with mfile.ModelFile.open(p) as mf:
        assert mf.checksums is not None


def test_malformed_manifest_rejected(tmp_path):
    p = _model(tmp_path, manifest=False)
    with open(mfile.manifest_path(p), "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="malformed"):
        mfile.ModelFile.open(p)
    with open(mfile.manifest_path(p), "w") as f:
        json.dump({"version": 1, "algo": "crc32", "file_size": 1, "tensors": [1, 2]}, f)
    with pytest.raises(ValueError, match="malformed"):
        mfile.ModelFile.open(p)


def test_wrong_algo_rejected(tmp_path):
    p = _model(tmp_path)
    mp = mfile.manifest_path(p)
    doc = json.load(open(mp))
    doc["algo"] = "md5"
    json.dump(doc, open(mp, "w"))
    with pytest.raises(ValueError, match="algo"):
        mfile.ModelFile.open(p)


# -- offline verification -----------------------------------------------------


def test_verify_weights_reports_every_corrupt_tensor(tmp_path):
    p = _model(tmp_path)
    _flip(p, "block_matmul_q.0")
    _flip(p, "block_norm_1.1")
    with mfile.ModelFile.open(p) as mf:
        res = verify_weights(mf)
    assert sorted(res["corrupt"]) == ["block_matmul_q.0", "block_norm_1.1"]
    assert res["tensors"] == len(mf.tensors)


def test_verify_weights_requires_manifest(tmp_path):
    p = _model(tmp_path, manifest=False)
    with mfile.ModelFile.open(p) as mf:
        with pytest.raises(WeightIntegrityError, match="no checksum"):
            verify_weights(mf)


def test_cli_verify_check_write_and_corrupt_rcs(tmp_path, capsys):
    """The port's ``verify`` (no ``--tokenizer``) gives the JAX CLI's rc in
    each state: 2 without a manifest, 0 after ``--write``, 1 naming a
    corrupt tensor."""
    p = str(_model(tmp_path, manifest=False))
    assert main(["verify", "--model", p]) == 2 == jax_main(["verify", "--model", p])
    assert main(["verify", "--model", p, "--write"]) == 0
    assert main(["verify", "--model", p]) == 0 == jax_main(["verify", "--model", p])
    _flip(p, "block_matmul_v.1")
    capsys.readouterr()
    assert main(["verify", "--model", p]) == 1
    assert "block_matmul_v.1" in capsys.readouterr().out
    assert jax_main(["verify", "--model", p]) == 1


def test_engine_verify_weights_flag_names_corrupt_tensor(tmp_path):
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    p = _model(tmp_path, vocab_size=268, seq_len=48)
    _flip(p, "block_matmul_wo.0")
    with pytest.raises(WeightIntegrityError, match=r"block_matmul_wo\.0"):
        InferenceEngine(str(p), device="cpu", verify_weights=True)
    # without the sweep, the loader's per-tensor check still refuses it
    with pytest.raises(WeightIntegrityError, match=r"block_matmul_wo\.0"):
        InferenceEngine(str(p), device="cpu")
    p2 = _model(tmp_path, name="clean.m", vocab_size=268, seq_len=48)
    eng = InferenceEngine(str(p2), device="cpu", verify_weights=True)
    try:
        logits, _ = eng.prefill([1, 2, 3])
        assert np.all(np.isfinite(logits))
    finally:
        eng.close()


# -- resilient reader ---------------------------------------------------------


def test_resilient_reader_retry_budget_is_bounded(tmp_path, monkeypatch):
    """An ``OSError``-raising read is retried ``max_retries`` times, then
    raises :class:`WeightLoadError`; corrupt bytes raise at once."""
    p = _model(tmp_path)
    with mfile.ModelFile.open(p) as mf:
        rd = ResilientReader(mf, max_retries=2, backoff_s=0.001)
        calls = []

        def flaky(key):
            calls.append(key)
            raise OSError(5, "Input/output error")

        monkeypatch.setattr(mf, "raw", flaky)
        with pytest.raises(WeightLoadError, match="after 2 retries"):
            rd.raw("embedding")
        assert calls == ["embedding"] * 3
        monkeypatch.undo()
        # a read that fails once, then succeeds, is retried to success
        fails = [OSError(5, "flake")]
        orig = mf.raw

        def once(key):
            if fails:
                raise fails.pop()
            return orig(key)

        monkeypatch.setattr(mf, "raw", once)
        assert rd.raw("final_norm").nbytes == mf.tensors["final_norm"].n_bytes
        monkeypatch.undo()
        _flip(p, "block_norm_0.0")
        with pytest.raises(WeightIntegrityError, match="block_norm_0.0"):
            rd.raw("block_norm_0.0")


def test_reader_verifies_each_tensor_once(tmp_path):
    p = _model(tmp_path)
    with mfile.ModelFile.open(p) as mf:
        rd = ResilientReader(mf)
        calls = []
        orig = mf.tensor_crc32
        mf.tensor_crc32 = lambda k: (calls.append(k), orig(k))[1]
        rd.raw("embedding")
        rd.raw("embedding")
        assert calls == ["embedding"]


# -- the scales plane ---------------------------------------------------------


@pytest.mark.parametrize("weight_type", [quants.Q40, quants.Q80])
def test_scales_only_reader_matches_pair_reader(tmp_path, weight_type):
    """The port reads a quantized weight's scales out of its wire bytes on
    the device (``unpack_planes``): the K-major plane equals the JAX
    package's scales-only reader, whole and in sub-blocks."""
    p = _model(tmp_path, manifest=False, weight_type=weight_type, dim=64, hidden_dim=96)
    with jax_mfile.ModelFile.open(p) as jmf, mfile.ModelFile.open(p) as mf:
        rd = ResilientReader(mf)
        for key, (o_lo, o_hi, i_lo, i_hi) in [
                ("block_matmul_q.0", (0, 64, 0, 64)),
                ("block_matmul_q.0", (16, 48, 32, 64)),
                ("block_matmul_w2.1", (8, 40, 32, 96)),
        ]:
            rows, cols = mf.tensors[key].shape
            qw = unpack_planes(torch.from_numpy(rd.raw(key)), weight_type, rows, cols,
                               torch.float32)
            want = jmf.tensor_scales_kmajor_sub(key, o_lo, o_hi, i_lo, i_hi)
            got = qw.scales[i_lo // 32:i_hi // 32, o_lo:o_hi].numpy()
            np.testing.assert_array_equal(got, want)


# -- cross-package ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_written_by_either_package_loads_in_the_other(tmp_path, writer):
    p = _model(tmp_path, manifest=False)
    (jax_mfile if writer == "jax" else mfile).write_manifest(p)
    with jax_mfile.ModelFile.open(p) as jmf, mfile.ModelFile.open(p) as mf:
        assert mf.checksums == jmf.checksums
        assert set(mf.checksums) == set(mf.tensors)
    assert main(["verify", "--model", str(p)]) == 0 == jax_main(["verify", "--model", str(p)])


@pytest.mark.parametrize("weight_type", [quants.Q40, quants.Q80])
def test_tensor_crc32_equal_for_every_tensor(tmp_path, weight_type):
    p = _model(tmp_path, manifest=False, weight_type=weight_type)
    with jax_mfile.ModelFile.open(p) as jmf, mfile.ModelFile.open(p) as mf:
        assert list(mf.tensors) == list(jmf.tensors)
        for key in mf.tensors:
            assert mf.tensor_crc32(key) == jmf.tensor_crc32(key), key
