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
``params["layers"]["attn"]["wq"][3]``.

The logical axis names (``embed``, ``vocab``, ``heads``, ``kv_heads``,
``ff``, ``experts``, ``layers`` …) map to mesh axes through
:data:`DEFAULT_RULES`, the reference's MaxText-style rules:
  embed    — d_model rows/cols    → FSDP-sharded over the data axis
  vocab    — embedding/output     → model axis
  heads    — attention heads      → model axis
  kv_heads — KV heads             → model axis iff divisible, else replicated
  ff       — MLP hidden           → model axis
  experts, layers, state, hd, conv, lora, groups → replicated
:func:`param_pspecs` gives one :class:`Spec` per leaf of the stacked info
tree; :func:`abstract_params` gives ``meta``-device tensors (nothing is
allocated) for shape-only work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

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


def stacked_leaves(tree, infos) -> List[List[Any]]:
    """The leaves of ``tree``, a tree in the port's layout made from the
    stacked info tree ``infos`` (:func:`_unstack`), grouped as the
    reference's leaves: the entries of each list that a ``layers`` dim
    became give one group per leaf, in the stacked C order; every other
    leaf is a group of one.  Groups follow ``infos``' dict order."""
    def walk(node, info, depth):
        if _is_info(info):
            return [[node]]
        n = _stack_size(info, depth)
        if n is None:
            return [g for k, v in info.items() for g in walk(node[k], v, depth)]
        if not isinstance(node, (list, tuple)) or len(node) != n:
            raise ValueError(f"expected a list of {n} layers, got {type(node).__name__}")
        parts = [walk(x, info, depth + 1) for x in node]
        return [[x for p in parts for x in p[k]] for k in range(len(parts[0]))]

    return walk(tree, infos, 0)


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


def abstract_params(tree):
    """The parameters of a ParamInfo tree as ``meta``-device tensors in the
    port's layout: shapes and dtypes, nothing allocated."""
    return _unstack(tree, lambda info, idx, _: torch.empty(
        info.shape[len(idx):], dtype=info.dtype, device="meta"))


class Spec(tuple):
    """A partition spec: one entry per dim — a mesh-axis name, a tuple of
    names (the dim split over their product, the first major), or None
    (replicated).  The port's counterpart of ``jax.sharding.PartitionSpec``;
    ``tuple(spec)`` compares equal to ``tuple(PartitionSpec(...))``."""

    def __new__(cls, *entries):
        # a 1-tuple names one axis, as PartitionSpec normalises it
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(repr(e) for e in self) + ")"


# logical axis name → mesh axis (or None).  The data axis doubles as the
# FSDP axis (weights sharded over it, gathered per layer where used).
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",       # dropped at spec time if not divisible
    "ff": "model",
    "experts": None,
    "layers": None,
    "state": None,
    "hd": None,
    "conv": None,
    "lora": None,
    "groups": None,
}


def param_pspecs(tree, mesh_axis_sizes: Dict[str, int],
                 rules: Optional[Dict[str, Optional[str]]] = None):
    """A :class:`Spec` per leaf of the stacked ParamInfo ``tree``; an axis
    that does not divide its dim is replicated."""
    rules = dict(DEFAULT_RULES if rules is None else rules)

    def one(info: ParamInfo):
        spec = []
        for dim, name in zip(info.shape, info.logical):
            axis = rules.get(name) if name else None
            if axis is not None and axis in mesh_axis_sizes \
                    and dim % mesh_axis_sizes[axis] == 0:
                spec.append(axis)
            else:
                spec.append(None)
        return Spec(*spec)

    def walk(node):
        return one(node) if _is_info(node) else {k: walk(v) for k, v in node.items()}

    return walk(tree)
