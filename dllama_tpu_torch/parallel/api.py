"""The device mesh (the port of the JAX package's ``parallel/api.py``
``MeshPlan``/``make_mesh``, its ``sp`` axis).

The JAX package is single-controller: one process drives every device of
its mesh. The port keeps that model for sequence parallelism: a plan is an
ordered list of ``torch.device``s, one per sequence shard, and one process
drives them all; no ``torch.distributed`` here. The list may repeat a device
(``[cpu] * sp`` in the tests, ``[cuda:0] * sp`` on a machine with one GPU),
the counterpart of the JAX tests' forced host device count. The lead device
``devices[0]`` holds the weights and runs everything but attention.

Only the ``sp`` axis is ported; ``tp``, ``dp`` and ``pp`` sizes other than
1 raise. There is no thread-local plan: callers pass it explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXES = ("dp", "pp", "sp", "tp")


@dataclass(frozen=True)
class MeshPlan:
    """One ``sp`` shard per entry of ``devices``; shard ``j`` holds cache rows
    ``[j * S_l, (j + 1) * S_l)`` on ``devices[j]``."""

    devices: tuple[torch.device, ...]

    def axis_size(self, name: str) -> int:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        return len(self.devices) if name == "sp" else 1

    @property
    def lead(self) -> torch.device:
        """The device of the weights, the embedding, the matmuls and sampling."""
        return self.devices[0]


def default_devices(device, sp: int) -> list[torch.device]:
    """The shard devices when the caller names none: ``[cpu] * sp`` on the
    CPU, ``cuda:0 .. cuda:sp-1`` on the card. Fewer visible CUDA devices than
    ``sp`` fail with the JAX engine's message."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * sp
    found = torch.cuda.device_count()
    if sp > found:
        raise ValueError(f"mesh dp=1 sp={sp} pp=1 tp=1 needs {sp} devices, found {found}")
    return [torch.device("cuda", i) for i in range(sp)]


def make_mesh(axis_sizes: dict[str, int], devices) -> MeshPlan:
    """A plan for ``{"sp": n}`` over the first ``n`` of ``devices``."""
    for name, n in axis_sizes.items():
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {', '.join(AXES)})")
        if name != "sp" and n != 1:
            raise NotImplementedError(
                f"mesh axis {name}={n} is not ported to the PyTorch/CUDA package "
                f"yet (ported: sp)")
    sp = int(axis_sizes.get("sp", 1))
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    devs = [torch.device(d) for d in devices]
    if len(devs) < sp:
        raise ValueError(f"mesh dp=1 sp={sp} pp=1 tp=1 needs {sp} devices, found {len(devs)}")
    return MeshPlan(devices=tuple(devs[:sp]))
