"""Token sampler: greedy argmax, temperature softmax, top-p (nucleus).

Behavior-compatible with the reference sampler (reference:
src/tokenizer.cpp:389-510), including the xorshift* RNG so fixed-seed runs are
reproducible against the reference (tokenizer.cpp:25-36). The port's own copy
of the JAX package's ``tokenizer/sampler.py``: this host-side numpy sampler
is the semantics oracle; the engine's decode loop uses the on-device sampler
(:mod:`dllama_tpu_torch.ops.sampling`) fed with this module's xorshift coins.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def xorshift_random_u32(state: int) -> tuple[int, int]:
    """xorshift* step (reference: tokenizer.cpp:25-31). Returns (u32, new_state)."""
    state &= _MASK64
    state ^= state >> 12
    state ^= (state << 25) & _MASK64
    state ^= state >> 27
    return ((state * 0x2545F4914F6CDD1D) & _MASK64) >> 32, state


def xorshift_random_f32(state: int) -> tuple[float, int]:
    """Random float32 in [0, 1) (reference: tokenizer.cpp:33-36)."""
    u, state = xorshift_random_u32(state)
    return (u >> 8) / 16777216.0, state


def softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    e = np.exp(x - x.max())
    return e / e.sum()


def sample_topp(probs: np.ndarray, topp: float, coin: float) -> int:
    """Nucleus sampling (reference: tokenizer.cpp:424-465).

    Reproduces the reference's cutoff pre-filter and its renormalization by the
    truncated cumulative mass (``coin * cumulative_prob``).
    """
    n = probs.shape[0]
    cutoff = (1.0 - topp) / (n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    # Descending sort; numpy's stable mergesort on -probs preserves index order
    # for ties like the reference's qsort comparator returning 0.
    order = idx[np.argsort(-probs[idx], kind="stable")]
    p = probs[order]
    csum = np.cumsum(p)
    over = np.nonzero(csum > topp)[0]
    last = int(over[0]) if over.size else p.shape[0] - 1
    cumulative = float(csum[last])
    r = coin * cumulative
    inner = np.nonzero(np.cumsum(p[:last + 1]) > r)[0]
    pick = int(inner[0]) if inner.size else last
    return int(order[pick])


def sample_mult(probs: np.ndarray, coin: float) -> int:
    """Multinomial via CDF scan (reference: tokenizer.cpp:403-414)."""
    cdf = np.cumsum(probs)
    hit = np.nonzero(coin < cdf)[0]
    return int(hit[0]) if hit.size else probs.shape[0] - 1


class Sampler:
    """Stateful sampler with the reference's CLI semantics."""

    def __init__(self, vocab_size: int, temperature: float, topp: float, seed: int):
        self.vocab_size = vocab_size
        self.temperature = temperature
        self.topp = topp
        self.rng_state = seed & _MASK64

    def set_temp(self, temperature: float) -> None:
        self.temperature = temperature

    def set_seed(self, seed: int) -> None:
        self.rng_state = seed & _MASK64

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)[: self.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        probs = softmax(logits / self.temperature)
        coin, self.rng_state = xorshift_random_f32(self.rng_state)
        if self.topp <= 0 or self.topp >= 1:
            return sample_mult(probs, coin)
        return sample_topp(probs, self.topp, coin)
