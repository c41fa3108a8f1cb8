"""The device mesh (the port of the JAX package's ``parallel/api.py``
``MeshPlan``/``make_mesh``, its ``sp`` and ``tp`` axes).

The JAX package is single-controller: one process drives every device of
its mesh. The port keeps that model: a plan is an ordered list of
``torch.device``s, one per shard of its one parallel axis, and one process
drives them all; no ``torch.distributed`` here. The list may repeat a device
(``[cpu] * n`` in the tests, ``[cuda:0] * n`` on a machine with one GPU),
the counterpart of the JAX tests' forced host device count. The lead device
``devices[0]`` holds the embedding, the norms and the activations between
the sharded ops.

* ``sp`` (sequence parallelism, ``parallel/ring.py``): shard ``j`` holds
  cache rows ``[j * S_l, (j + 1) * S_l)``; the weights stay on the lead.
* ``tp`` (tensor parallelism, ``parallel/sharding.py``): shard ``j`` holds
  its slice of every matmul weight and its kv heads of the cache.

One axis at a time: ``tp`` together with ``sp``, and ``dp`` or ``pp`` above
1, raise. There is no thread-local plan: callers pass it explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXES = ("dp", "pp", "sp", "tp")
PORTED_AXES = ("sp", "tp")


@dataclass(frozen=True)
class MeshPlan:
    """One shard of ``axis`` (``"sp"`` or ``"tp"``) per entry of ``devices``."""

    devices: tuple[torch.device, ...]
    axis: str = "sp"

    def axis_size(self, name: str) -> int:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        return len(self.devices) if name == self.axis else 1

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
    """A plan for ``{"sp": n}`` or ``{"tp": n}`` over the first ``n`` of
    ``devices``."""
    for name, n in axis_sizes.items():
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        if name not in PORTED_AXES and n != 1:
            raise NotImplementedError(
                f"mesh axis {name}={n} is not ported to the PyTorch/CUDA package "
                f"yet (ported: {', '.join(PORTED_AXES)})")
    sp, tp = int(axis_sizes.get("sp", 1)), int(axis_sizes.get("tp", 1))
    for name, n in (("sp", sp), ("tp", tp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if sp > 1 and tp > 1:
        raise NotImplementedError(
            f"mesh sp={sp} x tp={tp} is not ported to the PyTorch/CUDA package yet "
            f"(one of sp and tp at a time)")
    devs = [torch.device(d) for d in devices]
    n = sp * tp
    if len(devs) < n:
        raise ValueError(_mesh_msg(sp, tp, len(devs)))
    return MeshPlan(devices=tuple(devs[:n]), axis="tp" if tp > 1 else "sp")
