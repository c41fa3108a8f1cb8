"""Prompt-lookup speculative decoding (the port of the JAX package's
``runtime/speculative.py``): the n-gram draft table, the verify step's
logits epilogue and the host's coin commit rule.

Drafts come from the token history itself: the K tokens that followed the
most recent *earlier* occurrence of the current trailing n-gram (trigram
first, bigram fallback). There is no draft model and no extra device
memory. A verify step runs one forward over the committed token and its K
drafts and keeps the longest draft prefix the model agrees with, so greedy
output is that of plain greedy decode (``models.llama.verify_step``), up to
the summation order of the wider dispatch: on the card a K+1-row verify
runs its matmuls on other kernels than a one-row decode step (K2's tensor
cores instead of its SIMT kernel; K1 instead of K2 for a paged verify of
8 rows), so an argmax may flip where two logits all but tie.

Sampled rows (temperature > 0, the paged verify step of continuous
batching) use exact-match verify (:func:`spec_decide`): every verify lane
runs the plain sampled decode step (``ops.sampling.sampled_token``) with
that position's coin from the request's sequential coin stream, and a draft
token is accepted iff it equals the sample. The emitted token at every
position is therefore the plain-decode sample for that position, spec-on
output equals spec-off output, and the host commits one coin per emitted
token (:func:`spec_coins_consumed`).

:func:`target_sampling_probs` is the probability vector of that sampled
step's distribution, per row: what a draft's accept rate must match (the
statistical check of exact-match verify). Nothing on the verify path calls
it.
"""

from __future__ import annotations

import torch


def target_sampling_probs(logits: torch.Tensor, temps, topps) -> torch.Tensor:
    """The probability vector of :func:`~dllama_tpu_torch.ops.sampling.sampled_token`'s
    distribution, per row: ``logits [N, V]`` → ``[N, V]`` f32 probs.

    The reference quirks, as the sampler applies them: temperature softmax,
    the ``(1-topp)/(V-1)`` cutoff pre-filter, descending stable-sort nucleus
    truncation at the first ``csum > topp``, renormalization by the
    truncated cumulative mass; ``topp`` outside (0, 1) keeps the plain
    softmax (multinomial). ``temp <= 0`` rows return a one-hot argmax. The
    full sort serves every vocabulary (the JAX function's 256-wide top-k
    window gives the same vector whenever the nucleus fits it)."""
    logits = logits.float()
    N, V = logits.shape
    temp = torch.as_tensor(temps, dtype=torch.float32, device=logits.device).reshape(-1)
    topp = torch.as_tensor(topps, dtype=torch.float32, device=logits.device).reshape(-1)
    temp, topp = temp.expand(N), topp.expand(N)
    safe_t = torch.where(temp > 0.0, temp, torch.ones_like(temp))
    probs = torch.softmax(logits / safe_t[:, None], dim=-1)
    topp_row = (topp > 0.0) & (topp < 1.0) & (temp > 0.0)
    cutoff = ((1.0 - topp) / (V - 1))[:, None]
    masked = torch.where(probs >= cutoff, probs, torch.zeros_like(probs))
    _, order = torch.sort(-masked, dim=-1, stable=True)
    ps = torch.gather(masked, -1, order)
    n_kept = torch.count_nonzero(ps, dim=-1)
    csum = torch.cumsum(ps, dim=-1)
    over = csum > topp[:, None]
    last = torch.where(over.any(dim=-1), torch.argmax(over.to(torch.int8), dim=-1),
                       torch.clamp(n_kept - 1, min=0, max=V - 1))
    kept = torch.where(torch.arange(V, device=logits.device)[None, :] <= last[:, None],
                       ps, torch.zeros_like(ps))
    trunc = kept / torch.clamp(torch.gather(csum, -1, last[:, None]), min=1e-30)
    nucleus = torch.zeros_like(probs).scatter(-1, order, trunc)
    out = torch.where(topp_row[:, None], nucleus, probs)
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1), V).float()
    return torch.where((temp > 0.0)[:, None], out, greedy)


def spec_decide(logits: torch.Tensor, tokens: torch.Tensor, lens: torch.Tensor,
                temps: torch.Tensor, topps: torch.Tensor, acoins: torch.Tensor,
                fcoins: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The verify step's logits epilogue: exact-match verify over one ragged
    batch, greedy and sampled rows alike.

    ``logits [B, K+1, V]`` from the verify forward over ``tokens [B, K+1]``
    (committed token + K drafts, padded past each row's ``lens [B]`` draft
    length); ``temps/topps [B]`` per-row sampling knobs; ``acoins [B, K]``
    the coins of draft positions ``0..K-1`` and ``fcoins [B]`` the coin of
    the bonus position ``K``, drawn by the host in position order from the
    request's coin stream.

    Returns ``(n_acc [B], out [B, K+1])`` (int64); the caller emits
    ``out[b, : n_acc[b] + 1]``. Greedy rows (``temp <= 0``): ``n_acc`` is
    the longest draft prefix matching the model's own argmax (capped at
    ``lens``) and ``out`` the argmax predictions. Sampled rows: ``out`` is
    the plain sampled step at every position with that position's coin,
    and draft ``i`` is accepted iff it equals the sample at position ``i``.
    Every row takes both paths and selects one (no data-dependent branch:
    the step is captured as a CUDA graph)."""
    from ..ops.sampling import sampled_token

    B, W, V = logits.shape
    K = W - 1
    lens = lens.to(device=logits.device, dtype=torch.long)
    temps = temps.to(device=logits.device, dtype=torch.float32)
    topps = topps.to(device=logits.device, dtype=torch.float32)
    lane = torch.arange(K, device=logits.device)[None, :]
    live = lane < lens[:, None]

    def accepted(picks: torch.Tensor) -> torch.Tensor:
        ok = (tokens[:, 1:] == picks[:, :-1]) & live
        return torch.cumprod(ok.long(), dim=-1).sum(dim=-1)

    preds = torch.argmax(logits, dim=-1)                           # [B, K+1]
    coins = torch.cat([acoins.reshape(B, K).float(), fcoins.reshape(B, 1).float()],
                      dim=1).to(logits.device)                     # [B, K+1]
    s = sampled_token(logits.reshape(B * W, V), temps.repeat_interleave(W),
                      topps.repeat_interleave(W), coins.reshape(-1)).reshape(B, W)
    greedy_row = temps <= 0.0
    n_acc = torch.where(greedy_row, accepted(preds), accepted(s))
    out = torch.where(greedy_row[:, None], preds, s)
    return n_acc, out


def spec_coins_consumed(n_acc: int) -> int:
    """Host-side coin commit rule for one sampled row of a verify step: one
    coin per EMITTED token (``n_acc`` accepted drafts plus the
    position-``n_acc`` sample), so coin ``i`` of a request's stream always
    belongs to emitted token ``i``, whatever the draft length."""
    return n_acc + 1


class NgramProposer:
    """N-gram-continuation draft table over the generation history.

    ``_latest`` maps each n-gram (tuples of different lengths cannot
    collide, so one flat table serves both) to the index just past its most
    recent occurrence; ``_prev`` keeps the occurrence before that. At draft
    time the trailing n-gram's ``_latest`` entry is the tail itself, so
    ``_prev`` is the most recent earlier place the same n-gram appeared,
    and the continuation that followed it is the draft. Trigram matches
    are tried first: a longer match predicts with higher precision."""

    _NS = (3, 2)

    def __init__(self, k: int):
        assert k >= 1
        self.k = k
        self.history: list[int] = []
        self._latest: dict[tuple, int] = {}
        self._prev: dict[tuple, int] = {}

    def extend(self, tokens) -> None:
        h = self.history
        for t in tokens:
            h.append(int(t))
            for n in self._NS:
                if len(h) >= n:
                    key = tuple(h[-n:])
                    old = self._latest.get(key)
                    if old is not None:
                        self._prev[key] = old
                    self._latest[key] = len(h)

    def draft(self) -> list[int]:
        """Always K tokens (the verify step has a static width); with no
        history signal the draft repeats the last token."""
        h = self.history
        for n in self._NS:
            if len(h) < n:
                continue
            q = self._prev.get(tuple(h[-n:]))
            if q is not None:
                d = h[q:q + self.k]
                if d:
                    return d + [d[-1]] * (self.k - len(d))
        return [h[-1] if h else 0] * self.k
