"""On-device token sampling (the port of the JAX package's ``ops/sampling.py``).

The temperature softmax, top-p truncation and CDF pick run on the logits'
device, so a sampled token costs a 4-byte transfer, not a vocab row. RNG
stays on the host for reference parity: the xorshift* ``coin`` comes from
:mod:`dllama_tpu_torch.tokenizer.sampler` (bit-exact with the reference's
tokenizer.cpp:25-36) and is passed in. Semantics mirror the host oracle's
reference quirks:

* cutoff pre-filter ``(1-topp)/(n-1)`` before the descending sort
  (tokenizer.cpp:432-441);
* renormalization by the truncated cumulative mass (``coin * cumulative``,
  tokenizer.cpp:455-459);
* ties keep ascending-index order (stable sort).

The full stable sort is used for every vocabulary size (the JAX package's
256-wide top-k window is an optimization with the same result whenever the
nucleus fits it).
"""

from __future__ import annotations

import numbers

import torch


def _as_rows(v, B: int, device) -> torch.Tensor:
    """``[B]`` f32 rows of a knob: a Python number is filled on the device
    (no host→device copy, which would synchronise); a tensor — a captured
    step's static buffer — is used where it lies."""
    if isinstance(v, numbers.Real):
        return torch.full((B,), float(v), dtype=torch.float32, device=device)
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.reshape(-1).expand(B) if t.numel() == 1 else t.reshape(B)


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis of ``x [B, V]`` in a fixed order.
    On CUDA PyTorch scans a tensor that holds a single row with cub's
    decoupled look-back, whose float sums depend on the timing of the
    blocks: a coin that lands at a CDF boundary can then pick another token
    from one run to the next (on an H100, 5 of 16 runs of 64 sampled tokens
    replayed from a CUDA graph). Two or more rows take PyTorch's per-row
    block scan, whose order is fixed, so a single row is scanned beside a
    row of zeros."""
    if x.shape[0] == 1 and x.is_cuda:
        return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), dim=-1)[:1]
    return torch.cumsum(x, dim=-1)


def topp_sample(probs: torch.Tensor, topp: torch.Tensor,
                coin: torch.Tensor) -> torch.Tensor:
    """Nucleus pick over ``probs [B, V]`` with per-row ``topp``/``coin [B]``;
    returns int64 token ids ``[B]``."""
    B, n = probs.shape
    cutoff = ((1.0 - topp) / (n - 1))[:, None]
    masked = torch.where(probs >= cutoff, probs, torch.zeros_like(probs))
    _, order = torch.sort(-masked, dim=-1, stable=True)
    ps = torch.gather(masked, -1, order)
    n_kept = torch.count_nonzero(ps, dim=-1)
    csum = _cumsum_rows(ps)
    over = csum > topp[:, None]
    any_over = over.any(dim=-1)
    first_over = torch.argmax(over.to(torch.int8), dim=-1)
    last = torch.where(any_over, first_over,
                       torch.clamp(n_kept - 1, min=0, max=n - 1))
    cumulative = torch.gather(csum, -1, last[:, None])[:, 0]
    r = coin * cumulative
    idx = torch.arange(n, device=probs.device)[None, :]
    inner = _cumsum_rows(torch.where(idx <= last[:, None], ps,
                                     torch.zeros_like(ps))) > r[:, None]
    pick = torch.where(inner.any(dim=-1),
                       torch.argmax(inner.to(torch.int8), dim=-1), last)
    return torch.gather(order, -1, pick[:, None])[:, 0]


def mult_sample(probs: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """Multinomial CDF scan (reference: tokenizer.cpp:403-414)."""
    hit = coin[:, None] < _cumsum_rows(probs)
    n = probs.shape[-1]
    return torch.where(hit.any(dim=-1), torch.argmax(hit.to(torch.int8), dim=-1),
                       torch.full_like(hit[:, 0], n - 1, dtype=torch.int64))


def sampled_token(logits: torch.Tensor, temperature, topp, coin) -> torch.Tensor:
    """Sample one token per row of ``logits [B, V]``.

    ``temperature``/``topp``/``coin`` are scalars or ``[B]`` vectors: rows
    with ``temperature <= 0`` take the greedy argmax; ``topp`` outside
    (0, 1) selects plain multinomial, matching the host oracle. Returns
    int64 ids ``[B]`` on the logits' device."""
    logits = logits.float()
    B, V = logits.shape
    temp = _as_rows(temperature, B, logits.device)
    topp_v = _as_rows(topp, B, logits.device)
    coin_v = _as_rows(coin, B, logits.device)
    safe_t = torch.where(temp > 0.0, temp, torch.ones_like(temp))
    probs = torch.softmax(logits / safe_t[:, None], dim=-1)
    topp_row = (topp_v > 0.0) & (topp_v < 1.0) & (temp > 0.0)
    sampled = torch.where(topp_row, topp_sample(probs, topp_v, coin_v),
                          mult_sample(probs, coin_v))
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)
