"""Bytes and operations of one launch of a kernel K1-K5: the one count that
the kernel wrappers add to their ``moved_bytes`` / ``ops`` counters, that
the compile ledger sums into a program's analysis
(``runtime/introspection.py``) and the roofline divides by a measured wall
(``runtime/roofline.py``), and that ``chip_smoke.py``'s ``bound()`` turns
into the least time the card could take for a case. Keeping it in one
function is what keeps those counts from drifting apart.

The rule is the on-chip measurement rule: each input byte read once, each
output byte written once, and the operations the function needs on these
inputs, counted against the peak of the type they run in (:attr:`Cost.rate`:
``"f32"`` FP32 outside the tensor cores, ``"bf16"`` or ``"int8"`` on them).
Where the work depends on the data (the keys a query row can see, the
experts a routing filled), the caller passes what the data needs. A wrapper
cannot read device positions or offsets without a synchronisation, so it
passes the most the launch's shapes allow: keys up to the cache's (or the
block table's) length, every group that can hold a row. Those launches are
counted at their capacity, and a program's analysis says so
(:data:`CAPACITY_NOTE`).

Nothing else of a step is counted: norms, rope, the sampler, copies and the
merges of tensor parallelism run in PyTorch's own kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

Q40_BLOCK = 32  # rows of K one Q40/Q80 scale covers

CAPACITY_NOTE = ("K1-K5 launches only (norms, rope, sampling, copies and tp merges not "
                 "counted); attention keys and expert groups held on the device are "
                 "counted at the launch's capacity")


@dataclass(frozen=True)
class Cost:
    """What one launch moves and computes, and the peak its operations
    count against."""

    bytes: float
    ops: float
    rate: str


def _quant_matmul(*, M: int, K: int, N: int, fast: bool, path: str) -> Cost:
    """K1/K2: int8 codes once, a scale per 32 rows (bf16 in fast mode, f32
    exact), the activations in and f32 out. Exact mode on the tensor cores
    multiplies three bf16 parts of each activation."""
    elt = 2 if fast else 4
    n_bytes = K * N + (K // Q40_BLOCK) * N * elt + M * K * elt + M * N * 4
    if fast:
        return Cost(n_bytes, 2.0 * M * K * N, "bf16")
    if path == "tc":
        return Cost(n_bytes, 3 * 2.0 * M * K * N, "bf16")
    return Cost(n_bytes, 2.0 * M * K * N, "f32")


def _attention(*, T: int, heads: int, kv_heads: int, head_dim: int, q_elt: int,
               kv_elt: int, depths: list[int], path: str, rows: int | None = None) -> Cost:
    """K3: every row's queries read and output written at the queries'
    size, the K and V rows up to its newest visible position (capped at
    ``rows``, the cache's length), and ``QK^T`` plus ``PV`` over the keys
    each query row sees."""
    cap = rows if rows is not None else float("inf")
    keys = sum(min(d + T, cap) for d in depths)
    visible = sum(min(d + t + 1, cap) for d in depths for t in range(T))
    n_bytes = (2 * len(depths) * T * heads * head_dim * q_elt
               + 2 * keys * kv_heads * head_dim * kv_elt)
    return Cost(n_bytes, 4.0 * head_dim * heads * visible,
                "bf16" if path == "tc" else "f32")


def _block_stats(*, T: int, heads: int, kv_heads: int, head_dim: int, q_elt: int,
                 kv_elt: int, seen: list[int], path: str, B: int = 1) -> Cost:
    """K3s: the block's keys up to the newest one a row sees (``seen[t]``
    keys for query position ``t``), the queries read, ``acc`` written in
    f32 and ``m``, ``l`` in f32."""
    n_bytes = B * (2 * max(seen, default=0) * kv_heads * head_dim * kv_elt
                   + T * heads * head_dim * (q_elt + 4) + 2 * T * heads * 4)
    return Cost(n_bytes, B * 4.0 * head_dim * heads * sum(seen),
                "bf16" if path == "tc" else "f32")


def _paged(*, T: int, heads: int, kv_heads: int, head_dim: int, q_elt: int, kv_elt: int,
           depths: list[int], rows: int) -> Cost:
    """K4 (the FP32 SIMT kernel): as K3, through the block table, whose
    reach ``rows`` caps every row."""
    keys = sum(min(d + T, rows) for d in depths)
    scored = sum(min(d + t + 1, rows) for d in depths for t in range(T))
    n_bytes = (2 * keys * kv_heads * head_dim * kv_elt
               + 2 * len(depths) * T * heads * head_dim * q_elt)
    return Cost(n_bytes, 4.0 * head_dim * heads * scored, "f32")


def _moe(*, R: int, K: int, N: int, used: int, decoder: str, fast: bool = False,
         plane_elt: int = 4) -> Cost:
    """K5: the planes of the ``used`` groups that hold rows once, the
    activations in at the decoder's width and f32 out. The Q40/Q80 decoder
    in exact mode multiplies three bf16 parts on the tensor cores."""
    ops = 2.0 * R * K * N
    if decoder == "q":
        elt = 2 if fast else 4
        return Cost(used * (K * N + K // Q40_BLOCK * N * elt) + R * K * elt + R * N * 4,
                    (1 if fast else 3) * ops, "bf16")
    if decoder == "dense":
        return Cost(used * K * N * plane_elt + R * K * plane_elt + R * N * 4, ops,
                    "bf16" if plane_elt == 2 else "f32")
    a8 = decoder == "a8"
    return Cost(used * (K * N + 4 * N) + R * K * (1 if a8 else 2) + R * N * 4, ops,
                "int8" if a8 else "bf16")


_FORMULAS = {"K1": _quant_matmul, "K2": _quant_matmul, "K3": _attention,
             "K3s": _block_stats, "K4": _paged, "K5": _moe}


def launch_cost(kernel: str, **shape) -> Cost:
    """Bytes moved and operations of one launch of ``kernel`` (``"K1"`` ..
    ``"K5"``) at ``shape`` (the keyword arguments of that kernel's formula
    in this module)."""
    return _FORMULAS[kernel](**shape)


def count(wrapper, c: Cost) -> None:
    """Add one launch's cost to a kernel wrapper's counters."""
    wrapper.moved_bytes += c.bytes
    wrapper.ops += c.ops
