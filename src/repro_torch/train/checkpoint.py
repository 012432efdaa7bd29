"""Checkpointing in the JAX package's format (``repro.train.checkpoint``):
a checkpoint written by either package restores in the other.

Layout (one directory per step):
    step_000123/
      MANIFEST.json        — step, tree description, flattened keys with
                             global shapes / dtypes, ``extra``
      shard_p{proc}.npz    — this process's arrays, named ``a{i:05d}``

  * **atomic**: writes go to ``step_X.tmp{proc}`` and are renamed only after
    the manifest's fsync;
  * **the reference's keys**: leaves flatten as ``jax.tree_util`` flattens
    the reference's tree — dict keys sorted, a NamedTuple field as
    ``.field`` (``opt/.step``, ``opt/.m/embed/out``), joined by ``/`` —
    with the port's per-layer lists re-stacked to the reference's shapes
    (``params/layers/mlp/w_up`` is ``[L, d, ff]``);
  * **bf16 without ml_dtypes**: a bfloat16 leaf is written as raw 2-byte
    words under the npy descr ``'<V2'`` with ``"dtype": "bfloat16"`` in the
    manifest, as ``ml_dtypes`` writes it, and read back through an int16
    view;
  * **re-placeable**: restore rebuilds the global arrays from the files and
    puts them on any device, on every slot of a mesh, or laid out on any
    (data, model) mesh by a :class:`~repro_torch.distributed.sharding.Layout`
    (the elastic re-place); a save from a layout gathers whole leaves, so its
    files are those of a one-device save.
The ``treedef`` field is this package's own description of the tree; the
reference's restore never reads it.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import Layout
from repro_torch.launch.mesh import DeviceMesh

_BF16_DESCR = "<V2"
_CHUNK = 1 << 24                    # bytes per write into the zip entry


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, key: str = "") -> Dict[str, Tuple[Tuple[int, ...], List[torch.Tensor]]]:
    """``{key: (stacked shape, leaves in stacked C order)}`` in the
    reference's flattening order; a list is a stacked dim over its
    entries, which must share one structure."""
    join = lambda k: f"{key}/{k}" if key else str(k)
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            out.update(_flatten(node[k], join(k)))
        return out
    if _is_namedtuple(node):
        out = {}
        for f in node._fields:
            out.update(_flatten(getattr(node, f), join("." + f)))
        return out
    if isinstance(node, (list, tuple)):
        parts = [_flatten(v, key) for v in node]
        if not parts or any(p.keys() != parts[0].keys() or
                            any(p[k][0] != parts[0][k][0] for k in p) for p in parts):
            raise ValueError(f"{key or '<root>'}: the entries of a list must share "
                             f"one structure and shapes")
        return {k: ((len(parts),) + parts[0][k][0],
                    [x for p in parts for x in p[k][1]]) for k in parts[0]}
    t = torch.as_tensor(node)
    return {key: (tuple(t.shape), [t])}


def _describe(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(node[k])}" for k in sorted(node)) + "}"
    if _is_namedtuple(node):
        return f"{type(node).__name__}(" + ", ".join(
            f"{f}={_describe(getattr(node, f))}" for f in node._fields) + ")"
    if isinstance(node, (list, tuple)):
        return f"stacked[{len(node)}]({_describe(node[0])})"
    return "*"


def _dtype_name(dt: torch.dtype) -> str:
    return "bfloat16" if dt == torch.bfloat16 else str(dt).replace("torch.", "")


def _write_npy(zf: zipfile.ZipFile, name: str, arr: np.ndarray, descr: str) -> None:
    """One ``.npy`` entry, as ``np.savez`` writes it (format 1.0 header),
    with ``descr`` in the header."""
    header = {"descr": descr, "fortran_order": False, "shape": arr.shape}
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(f, header)
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        for lo in range(0, flat.size, _CHUNK):
            f.write(flat[lo:lo + _CHUNK].data)


def _host_array(shape, leaves: List[torch.Tensor]) -> Tuple[np.ndarray, str, str]:
    """The stacked leaves as one host array: (array, npy descr, dtype name)."""
    dt = leaves[0].dtype
    host = torch.empty((len(leaves),) + tuple(leaves[0].shape), dtype=dt)
    for i, x in enumerate(leaves):
        host[i].copy_(x.detach())
    host = host.reshape(shape)
    if dt == torch.bfloat16:
        return host.view(torch.int16).numpy(), _BF16_DESCR, "bfloat16"
    arr = host.numpy()
    return arr, np.lib.format.dtype_to_descr(arr.dtype), _dtype_name(dt)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None,
                    process_index: int = 0, layout: Optional[Layout] = None) -> Path:
    """Write one atomic checkpoint.  Returns the final directory path.

    With ``layout``, ``tree`` is a list of per-slot trees laid out by it;
    the whole leaves are gathered to the host first."""
    if layout is not None:
        tree = layout.gather(tree, device="cpu")
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp{process_index}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "treedef": _describe(tree), "keys": [],
                "extra": extra or {}}
    with zipfile.ZipFile(tmp / f"shard_p{process_index}.npz", "w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (key, (shape, leaves)) in enumerate(_flatten(tree).items()):
            arr, descr, dtype = _host_array(shape, leaves)
            name = f"a{i:05d}"
            _write_npy(zf, name, arr, descr)
            manifest["keys"].append({"key": key, "name": name,
                                     "shape": list(shape), "dtype": dtype})
            del arr
    with open(tmp / "MANIFEST.json", "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_????????")
             if p.is_dir()]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype != "bfloat16":
            raise ValueError(f"raw {arr.dtype} leaf of dtype {dtype!r}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(node, pieces: Dict[str, Any], key: str = ""):
    """``node``'s structure with its leaves taken in order from
    ``pieces[key]`` (an iterator per key)."""
    join = lambda k: f"{key}/{k}" if key else str(k)
    if isinstance(node, dict):
        return {k: _rebuild(v, pieces, join(k)) for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), pieces, join("." + f))
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return [_rebuild(v, pieces, key) for v in node]
    return next(pieces[key])


def restore_checkpoint(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                       device: Union[None, str, torch.device, DeviceMesh, Layout] = None,
                       process_index: int = 0) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (the port's layout).

    Leaves keep the file's dtype and go to ``device``; with ``device=None``
    each goes to the device of ``tree_like``'s leaf.  A
    :class:`~repro_torch.launch.mesh.DeviceMesh` gives one whole tree per
    slot (``Layout(mesh)``: every leaf replicated; slots of one device share
    each leaf), a :class:`~repro_torch.distributed.sharding.Layout` one
    tree of local pieces per slot of its mesh: the elastic re-place,
    whatever the writer's layout was.  ``tree_like`` holds whole leaves (``meta``
    tensors will do).  A missing leaf raises ``KeyError``, a shape that
    differs from ``tree_like``'s ``ValueError``.
    """
    if isinstance(device, DeviceMesh):
        device = Layout(device)
    if isinstance(device, Layout):
        tree, step, extra = restore_checkpoint(ckpt_dir, tree_like, step=step,
                                               device="cpu", process_index=process_index)
        return device.shard(tree), step, extra
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    entries = {e["key"]: e for e in manifest["keys"]}
    want = _flatten(tree_like)
    for key, (shape, _) in want.items():
        if key not in entries:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(entries[key]["shape"]) != shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(entries[key]['shape'])} "
                             f"!= expected {shape}")
    target = device
    pieces = {}
    with np.load(d / f"shard_p{process_index}.npz") as data:
        for key, (shape, leaves) in want.items():
            e = entries[key]
            arr = data[e["name"]]
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: stored array of shape {arr.shape} "
                                 f"!= manifest {shape}")
            dev = leaves[0].device if target is None else torch.device(target)
            t = _to_tensor(arr, e["dtype"]).to(dev)
            pieces[key] = iter(t.reshape((len(leaves),) + tuple(leaves[0].shape))
                               .unbind(0))
    return _rebuild(tree_like, pieces), step, manifest.get("extra", {})


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    base = Path(ckpt_dir)
    steps = sorted(p for p in base.glob("step_????????") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p)
