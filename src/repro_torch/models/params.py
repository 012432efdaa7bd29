"""Parameter specs of the model zoo: one source of truth for shapes, dtypes
and init.

Every model builder returns a tree (nested dicts) of :class:`ParamInfo`
leaves, stacked as the JAX package stacks them: per-layer parameters carry a
leading ``layers`` dim (two of them for the hybrid and vlm groups).  From
that single tree
  * :func:`init_params` materialises random parameters on a device,
  * :func:`params_from_numpy` carries the JAX package's parameters across,
  * :func:`count_params` counts parameters without materialising any.

The port's parameters unstack every leading ``layers`` dim into a list, so
that ``params["layers"][3]["attn"]["wq"]`` — dotted, ``layers.3.attn.wq``
(:func:`named_params`) — is the reference's
``params["layers"]["attn"]["wq"][3]``.  The logical axis names are kept for
the sharding slice (``embed``, ``vocab``, ``heads``, ``kv_heads``, ``ff``,
``experts``, ``layers`` …); nothing reads them yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]    # one logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _is_info(x) -> bool:
    return isinstance(x, ParamInfo)


def _infos(tree):
    if _is_info(tree):
        yield tree
    else:
        for v in tree.values():
            yield from _infos(v)


def _stack_size(tree, depth: int) -> Optional[int]:
    """The size of dim ``depth`` when every leaf of ``tree`` is stacked
    there (logical axis ``layers``), else None."""
    leaves = list(_infos(tree))
    if leaves and all(len(i.logical) > depth and i.logical[depth] == "layers"
                      for i in leaves):
        sizes = {i.shape[depth] for i in leaves}
        if len(sizes) == 1:
            return sizes.pop()
    return None


def _unstack(tree, leaf: Callable, other=None, idx: Tuple[int, ...] = ()):
    """Walk the stacked info ``tree`` into the port's layout: a stacked
    subtree becomes a list with one entry per layer.  ``leaf(info, idx,
    other)`` makes each leaf; ``idx`` holds the layer indices taken so far
    and ``other`` is the matching node of a parallel tree (or None)."""
    if _is_info(tree):
        return leaf(tree, idx, other)
    n = _stack_size(tree, len(idx))
    if n is not None:
        return [_unstack(tree, leaf, other, idx + (i,)) for i in range(n)]
    return {k: _unstack(v, leaf, None if other is None else other[k], idx)
            for k, v in tree.items()}


def init_params(tree, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype: Optional[torch.dtype] = None):
    """Materialise random parameters from a ParamInfo tree on ``device``.

    ``normal`` leaves draw N(0, 1) in fp32 from ``generator`` (a generator
    on ``device``; seed 0 when omitted), one layer at a time, then scale and
    cast to the leaf's dtype, or to ``dtype`` for every leaf when given."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def one(info: ParamInfo, idx, _):
        shape, dt = info.shape[len(idx):], dtype or info.dtype
        if info.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if info.init == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * info.scale).to(dt)

    return _unstack(tree, one)


def params_from_numpy(tree, infos, *, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """The reference's parameter pytree (nested dicts of numpy arrays,
    leading ``layers`` dims stacked) as the port's parameters on ``device``.

    Each leaf is cast to its ParamInfo dtype, or to ``dtype`` for every leaf
    when given.  A bfloat16 numpy leaf (``np.asarray`` of a JAX bf16 array)
    goes through fp32, which carries bf16 values exactly."""
    dev = resolve_device(device)

    def one(info: ParamInfo, idx, arr):
        a = np.asarray(arr)[idx]
        if a.shape != info.shape[len(idx):]:
            raise ValueError(f"parameter of shape {a.shape}, expected "
                             f"{info.shape[len(idx):]}")
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(
            dev, dtype or info.dtype)

    return _unstack(infos, one, tree)


def tree_leaves(tree):
    """The leaves of a nested dict / list tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nested dict / list / NamedTuple tree, the
    structure kept (a plain tuple comes back as a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def named_params(params, prefix: str = "") -> Dict[str, Any]:
    """``{dotted name: tensor}`` of a parameter tree (``layers.3.attn.wq``)."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(named_params(v, name + "."))
        else:
            out[name] = v
    return out


def count_params(tree) -> int:
    """Parameters in a ParamInfo tree (nothing materialised) or in a tree
    of tensors."""
    return int(sum(np.prod(x.shape) if _is_info(x) else x.numel()
                   for x in tree_leaves(tree)))
