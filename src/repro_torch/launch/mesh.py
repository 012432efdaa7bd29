"""Device meshes for the port — the counterpart of ``repro.launch.mesh``.

The JAX package drives a mesh from one process through ``shard_map``.  The
port does the same from one process: a :class:`DeviceMesh` is a sequence
of torch devices on one named data axis.  Sharded code launches each slot's
work on that slot's device and gathers the slots' answers to the lead
device (``devices[0]``).  A device may repeat, so ``["cpu"] * 4`` and
``["cuda:0"] * 4`` drive the same code as four cards.

The production mesh of the language-model plane (``make_production_mesh``,
data × model) is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _normalise(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class DeviceMesh:
    """A 1-D mesh: ``devices`` in slot order on the axis ``axis``.

    ``shape[axis]`` is the number of slots, as on a ``jax.sharding.Mesh``.
    A bare ``"cuda"`` means ``cuda:0``, so a tensor's device compares equal
    to the slot that holds it.
    """

    def __init__(self, devices: Sequence, axis: str = "data"):
        self.devices: Tuple[torch.device, ...] = tuple(_normalise(d)
                                                       for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device the slots' answers are gathered to."""
        return self.devices[0]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"DeviceMesh([{devs}], axis={self.axis!r})"


def make_mesh(n: int, devices: Optional[Sequence] = None,
              axis: str = "data") -> DeviceMesh:
    """A mesh of ``n`` slots.

    ``devices=None`` takes ``cuda:0 .. cuda:n-1`` and raises when fewer than
    ``n`` cards exist: the mesh never drops to the CPU on its own.  Pass
    ``devices`` to choose them, repeats allowed (``["cpu"] * n`` for the
    plain path, ``["cuda:0"] * n`` for n slots on one card).
    """
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 slots, got {n}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"make_mesh({n}) needs {n} CUDA devices and {have} exist; "
                f"pass devices= (e.g. ['cuda:0'] * {n} or ['cpu'] * {n})")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"make_mesh({n}) got {len(devices)} devices")
    return DeviceMesh(devices, axis)


def as_mesh(mesh) -> Optional[DeviceMesh]:
    """``None``, a :class:`DeviceMesh`, a device or a sequence of devices
    as a :class:`DeviceMesh` (None stays None)."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        return DeviceMesh(mesh)
    if isinstance(mesh, (str, torch.device)):
        return DeviceMesh([mesh])
    raise TypeError(f"not a mesh: {mesh!r}; pass a DeviceMesh or a list "
                    f"of torch devices")
