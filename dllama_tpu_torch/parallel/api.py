"""The device mesh (the port of the JAX package's ``parallel/api.py``
``MeshPlan``/``make_mesh``, its ``sp``, ``tp`` and ``ep`` axes).

The JAX package is single-controller: one process drives every device of
its mesh. The port keeps that model: a plan is an ordered list of
``torch.device``s, one per shard, and one process drives them all; no
``torch.distributed`` here. The list may repeat a device (``[cpu] * n`` in
the tests, ``[cuda:0] * n`` on a machine with one GPU), the counterpart of
the JAX tests' forced host device count. The lead device ``devices[0]``
holds the embedding, the norms and the activations between the sharded ops.

* ``sp`` (sequence parallelism, ``parallel/ring.py``): shard ``j`` holds
  cache rows ``[j * S_l, (j + 1) * S_l)``; the weights stay on the lead.
* ``tp`` (tensor parallelism, ``parallel/sharding.py``): shard ``j`` holds
  its slice of every matmul weight and its kv heads of the cache.
* ``ep`` (expert parallelism, with or without ``tp``): the shards form a
  grid, ep-major as the JAX package's ``make_mesh({"ep": e, "tp": t})``
  lays its devices out: ``grid[i * t + j]`` is shard ``(i, j)``. ``ep``
  cuts only the expert stacks of an MoE layer (row ``i`` holds experts
  ``[i * E / ep, (i + 1) * E / ep)``); everything else is replicated over
  ``ep`` in the JAX package, so the single controller computes it once,
  on the first row (``devices``, the tp group).

``sp`` together with ``tp`` or ``ep``, and ``dp`` or ``pp`` above 1, raise.
There is no thread-local plan: callers pass it explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXES = ("dp", "pp", "sp", "tp", "ep")
PORTED_AXES = ("sp", "tp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    """One shard of ``axis`` (``"sp"`` or ``"tp"``) per entry of ``devices``,
    the first row of the ``(ep, tp)`` grid ``grid`` (empty: ``ep`` is 1)."""

    devices: tuple[torch.device, ...]
    axis: str = "sp"
    grid: tuple[torch.device, ...] = ()

    def axis_size(self, name: str) -> int:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        if name == "ep":
            return max(1, len(self.grid) // len(self.devices))
        return len(self.devices) if name == self.axis else 1

    @property
    def shards(self) -> tuple[torch.device, ...]:
        """Every shard's device, ep-major: shard ``(i, j)`` at ``i * tp + j``."""
        return self.grid or self.devices

    @property
    def lead(self) -> torch.device:
        """The device of the embedding, the norms, sampling and (at sp > 1)
        the weights."""
        return self.devices[0]

    @property
    def shards_per_device(self) -> int:
        """The most shards that one device holds (``[cuda:0] * 2``: 2)."""
        return max(self.devices.count(d) for d in self.devices)


def _mesh_msg(sp: int, tp: int, found: int) -> str:
    return f"mesh dp=1 sp={sp} pp=1 tp={tp} needs {sp * tp} devices, found {found}"


def default_devices(device, sp: int, tp: int = 1) -> list[torch.device]:
    """The shard devices when the caller names none: ``[cpu] * n`` on the
    CPU, ``cuda:0 .. cuda:n-1`` on the card (``n = sp * tp``). Fewer visible
    CUDA devices than ``n`` fail with the JAX engine's message."""
    dev = torch.device(device)
    n = sp * tp
    if dev.type == "cpu":
        return [dev] * n
    found = torch.cuda.device_count()
    if n > found:
        raise ValueError(_mesh_msg(sp, tp, found))
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axis_sizes: dict[str, int], devices) -> MeshPlan:
    """A plan for ``{"sp": n}``, ``{"tp": n}``, ``{"ep": e}`` or ``{"ep": e,
    "tp": t}`` over the first ``n`` (``e * t``) of ``devices``, ep-major."""
    for name, n in axis_sizes.items():
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        if name not in PORTED_AXES and n != 1:
            raise NotImplementedError(
                f"mesh axis {name}={n} is not ported to the PyTorch/CUDA package "
                f"yet (ported: {', '.join(PORTED_AXES)})")
    sp, tp, ep = (int(axis_sizes.get(a, 1)) for a in ("sp", "tp", "ep"))
    for name, n in (("sp", sp), ("tp", tp), ("ep", ep)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if sp > 1 and tp * ep > 1:
        raise NotImplementedError(
            f"mesh sp={sp} x {'tp' if tp > 1 else 'ep'}={tp if tp > 1 else ep} is not "
            f"ported to the PyTorch/CUDA package yet (sp runs alone)")
    devs = [torch.device(d) for d in devices]
    n = sp * tp * ep
    if len(devs) < n:
        raise ValueError(_mesh_msg(sp, tp, len(devs)) if ep == 1 else
                         f"mesh ep={ep} tp={tp} needs {n} devices, found {len(devs)}")
    row = sp * tp
    return MeshPlan(devices=tuple(devs[:row]), axis="tp" if tp > 1 or ep > 1 else "sp",
                    grid=tuple(devs[:n]) if ep > 1 else ())
