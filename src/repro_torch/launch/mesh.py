"""Device meshes for the port — the counterpart of ``repro.launch.mesh``.

The JAX package drives a mesh from one process through ``shard_map``.  The
port does the same from one process: a :class:`DeviceMesh` is a grid of
torch devices with one name per axis, as a ``jax.sharding.Mesh`` is.
Sharded code launches each slot's work on that slot's device, in slot
order (the grid's row-major order), and combines the slots' pieces with the
one-process collectives of :mod:`repro_torch.distributed.sharding`.  A
device may repeat, so ``["cpu"] * 4`` and ``["cuda:0"] * 4`` drive the same
code as four cards.

``make_mesh(n)`` is the 1-D ``data`` mesh of the CLIMBER paths;
``make_mesh((4, 2), ("data", "model"))`` and :func:`make_production_mesh`
are the language-model plane's (data, model) meshes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _normalise(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class DeviceMesh:
    """A grid of devices with named axes.

    ``devices`` is the grid (a numpy object array of ``torch.device``, one
    axis per name in ``axis_names``), ``shape`` maps axis → size as on a
    ``jax.sharding.Mesh``, and ``slots`` lists the devices in slot order
    (row-major over the grid).  A bare ``"cuda"`` means ``cuda:0``, so a
    tensor's device compares equal to the slot that holds it.  A flat
    device list with one axis name is a 1-D mesh.
    """

    def __init__(self, devices, axis: Union[str, Sequence[str]] = "data"):
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        flat = [_normalise(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        shape = np.shape(np.asarray(devices, dtype=object)) if len(names) > 1 \
            else (len(flat),)
        if len(shape) != len(names):
            raise ValueError(f"a grid of shape {shape} for axes {names}")
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(shape)
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.slots: Tuple[torch.device, ...] = tuple(flat)
        self._groups: Dict[str, List[List[int]]] = {}

    @property
    def axis(self) -> str:
        """The axis of a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh of axes {self.axis_names} has no single axis")
        return self.axis_names[0]

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def lead(self) -> torch.device:
        """The device the slots' answers are gathered to."""
        return self.slots[0]

    def coords(self, slot: int) -> Dict[str, int]:
        """Slot ``slot``'s coordinate on each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(slot, self.devices.shape)))

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def groups(self, axis: str) -> List[List[int]]:
        """For each slot, the slots that differ from it on ``axis`` alone,
        in order of their coordinate there (the members of a collective
        over ``axis``).  Without that axis each slot is its own group."""
        if axis not in self._groups:
            ids = np.arange(self.size).reshape(self.devices.shape)
            if axis in self.axis_names:
                ids = np.moveaxis(ids, self.axis_names.index(axis), -1)
                rows = ids.reshape(-1, ids.shape[-1]).tolist()
            else:
                rows = [[s] for s in range(self.size)]
            by_slot = {s: row for row in rows for s in row}
            self._groups[axis] = [by_slot[s] for s in range(self.size)]
        return self._groups[axis]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.slots)
        if len(self.axis_names) == 1:
            return f"DeviceMesh([{devs}], axis={self.axis!r})"
        return f"DeviceMesh({self.shape}, [{devs}])"


def _cards(n: int, call: str) -> List[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"{call} needs {n} CUDA devices and {have} exist; pass devices= "
            f"(e.g. ['cuda:0'] * {n} or ['cpu'] * {n})")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape, axes=None, devices: Optional[Sequence] = None,
              axis: str = "data") -> DeviceMesh:
    """A mesh of ``shape`` slots on ``axes``.

    ``make_mesh((4, 2), ("data", "model"))`` is a (data, model) grid;
    ``make_mesh(n)``, ``make_mesh(n, devices)`` and ``make_mesh(n,
    devices=..., axis=...)`` are the 1-D calls.  ``devices=None`` takes
    ``cuda:0 ..`` and raises when fewer cards exist than slots: the mesh
    never drops to the CPU on its own.  Pass ``devices`` (a flat list in
    slot order) to choose them, repeats allowed (``["cpu"] * n`` for the
    plain path, ``["cuda:0"] * n`` for n slots on one card).
    """
    if isinstance(shape, int):
        if axes is not None and not isinstance(axes, str):
            if devices is not None:
                raise TypeError("make_mesh(n, devices, devices=...) got devices twice")
            devices, axes = axes, None            # make_mesh(n, devices)
        shape, axes = (shape,), (axes or axis,)
    shape = tuple(int(n) for n in shape)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    if len(axes) != len(shape):
        raise ValueError(f"make_mesh: shape {shape} needs {len(shape)} axis names, "
                         f"got {axes}")
    n = int(np.prod(shape))
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got shape {shape}")
    label = f"make_mesh({shape[0] if len(shape) == 1 else shape})"
    devices = _cards(n, label) if devices is None else list(devices)
    if len(devices) != n:
        raise ValueError(f"{label} got {len(devices)} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = [_normalise(d) for d in devices]
    return DeviceMesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> DeviceMesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.

    It takes one card per slot and raises when fewer exist, unless
    ``devices`` gives the slots' devices (repeats allowed, e.g.
    ``["cuda:0"] * 256`` for every slot on one card).  It never drops to the
    CPU on its own."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def with_model_axis(mesh: Optional[DeviceMesh]) -> Optional[DeviceMesh]:
    """``mesh`` with a ``model`` axis: itself where it has one, else the
    same slots in the same order with a ``model`` axis of size 1 last (a
    1-D ``data`` mesh as a (data, model) mesh with one model slot)."""
    if mesh is None or "model" in mesh.axis_names:
        return mesh
    return DeviceMesh(mesh.devices[..., None], mesh.axis_names + ("model",))


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
