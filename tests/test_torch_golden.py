"""The port's ``InferenceEngine`` (on the CPU) against the committed goldens:
the reference C++ binary's greedy and sampled transcripts and perplexities
on the tiny synthetic models of ``tests/golden_assets.py`` — the same assets,
the same replay protocol (``golden_assets.replay_reference_driver``) and the
same bounds as the JAX package's ``tests/test_golden_reference.py``.

Transcripts must be token-identical. Perplexity is held to 1e-3 relative,
the JAX twin's bound: the reference sums its per-token log-probabilities in
another order and precision. Every transcript is also replayed with the KV
cache split over two sequence shards (``sp=2``, ring prefill and merge
decode over ``[cpu] * 2``), which must not change a token; the four
variants the JAX package replays at ``tp=2`` are replayed with every matmul
weight and the cache's kv heads split over two tensor shards (``tp=2``),
token for token too."""

from __future__ import annotations

import pytest

from dllama_tpu_torch.formats.quants import F32, Q80
from dllama_tpu_torch.runtime.engine import InferenceEngine

import golden_assets

BUFFER_TYPES = {"f32": F32, "q80": Q80}


def _engine_for(variant: str, tmp_path, sp: int = 1,
                tp: int = 1) -> tuple[InferenceEngine, dict]:
    golden = golden_assets.load_golden(variant)
    if golden is None:
        pytest.skip(f"no golden for {variant} (run tools/golden_reference.py)")
    m, t, m_sha, t_sha = golden_assets.build_assets(variant, tmp_path)
    if m_sha != golden["m_sha256"] or t_sha != golden["t_sha256"]:
        pytest.skip("synthetic assets no longer match the golden's hashes "
                    "(numpy RNG stream changed?) — regenerate goldens")
    eng = InferenceEngine(
        str(m), str(t), device="cpu",
        sync_type=BUFFER_TYPES[golden["buffer_float_type"]],
        compute_dtype="float32",
        temperature=golden["temperature"], topp=golden.get("topp", 0.9),
        seed=golden["sampler_seed"], sp=sp, tp=tp)
    return eng, golden


TRANSCRIPTS = [
    ("llama_q40", ()),
    ("llama_f32", ()),
    ("qwen3_q40", ()),
    ("llama31_q40", ()),
    ("llama_sampled_f32", ()),   # temperature 0.7 top-p over the xorshift* coins
    ("llama_deep_f32", ()),      # 8 layers x 292 pieces
    ("qwen3_deep_f32", ()),      # per-head norms + neox rope over 8 layers
    ("llama_macbeth_f32", (pytest.mark.slow,)),  # 2049 steps
]


# the variants tests/test_golden_reference.py replays at tp = 2
TP2_VARIANTS = ("llama_q40", "llama31_q40", "qwen3_q40", "llama_sampled_f32")


# sp = tp = 1 keeps the plain variant ids; sp = 2 adds "<variant>-sp2",
# tp = 2 "<variant>-tp2"
@pytest.mark.parametrize("variant,sp,tp", [
    *[pytest.param(v, sp, 1, id=v if sp == 1 else f"{v}-sp2", marks=marks)
      for sp in (1, 2) for v, marks in TRANSCRIPTS],
    *[pytest.param(v, 1, 2, id=f"{v}-tp2") for v in TP2_VARIANTS]])
def test_transcript_matches_reference(variant, sp, tp, tmp_path):
    eng, golden = _engine_for(variant, tmp_path, sp, tp)
    try:
        ids = eng.tokenizer.encode(golden["prompt"], is_start=True)
        data = golden_assets.word_vocab_tokenizer()
        assert ids == [data.bos_id] + list(range(1, 9))
        got, res = golden_assets.replay_reference_driver(eng, golden)
        assert len(res.tokens) == len(golden["pieces"])
        assert got == golden["pieces"], (
            f"token divergence at index "
            f"{next(i for i, (a, b) in enumerate(zip(got, golden['pieces'])) if a != b)}")
    finally:
        eng.close()


# llama_sampled_f32 shares llama_f32's model bytes, and perplexity does not
# depend on the sampler: its case would repeat llama_f32's
@pytest.mark.parametrize("variant", [v for v in golden_assets.VARIANTS
                                     if v != "llama_sampled_f32"])
def test_perplexity_matches_reference(variant, tmp_path):
    eng, golden = _engine_for(variant, tmp_path)
    try:
        ids = eng.tokenizer.encode(golden["perplexity"]["prompt"], is_start=True)
        ppl = eng.perplexity(ids)
        want = golden["perplexity"]["perplexity"]
        assert ppl == pytest.approx(want, rel=1e-3), (ppl, want)
    finally:
        eng.close()


def test_score_nll_agrees_with_perplexity(tmp_path):
    """The teacher-forced per-token NLL path and the perplexity path score
    the same sequence the same way (exp of the mean NLL)."""
    import numpy as np

    eng, golden = _engine_for("llama_q40", tmp_path)
    try:
        ids = eng.tokenizer.encode(golden["perplexity"]["prompt"], is_start=True)
        nll = eng.score_nll(ids)
        assert nll.shape == (len(ids) - 1,) and (nll >= 0).all()
        assert float(np.exp(nll.astype(np.float64).mean())) == pytest.approx(
            eng.perplexity(ids), rel=1e-5)
    finally:
        eng.close()
