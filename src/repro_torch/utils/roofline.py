"""Roofline terms of a counted step (the JAX package's
``repro.utils.roofline`` in PyTorch).

Three terms per (arch, shape, mesh) cell — all in seconds, per device:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / ICI_BW

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled, partitioned module and collective bytes from its HLO text.  The
port has no compiler: it runs the step once on ``meta`` tensors (shapes
only, nothing allocated) under a :class:`CostCounter`, which counts what
runs.  The counts are not XLA's:

  * FLOPs are ``torch.utils.flop_counter``'s formulas, which count GEMMs,
    convolutions and attention ops only (XLA counts every HLO op);
  * bytes are per aten op, each operand read once and each result written
    once — eager torch fuses nothing, so an elementwise chain counts every
    intermediate that XLA's fusion would keep on chip.  Views, reshapes
    that do not copy, slices, ``expand``, ``to`` onto the same device and
    ``empty`` move nothing and count 0;
  * collective bytes are the result bytes per slot of each cross-slot move
    of the one-process mesh (:mod:`repro_torch.distributed.sharding`'s
    collectives and the other moves that call :func:`count_collective`),
    under the reference's five HLO op kinds;
  * the peak of live bytes follows storage lifetimes.

A hand-written kernel's wrapper on ``meta`` adds its own work (its work
function, the one ``chip_smoke.py``'s bounds use) through :func:`charge`.
Per-device numbers are the totals over the mesh's slots divided by the
slot count: means over the slots, not the busiest slot's.

:func:`collective_bytes` still parses a reference HLO text, as the JAX
package's does.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# One H100 SXM (NVIDIA data sheet, dense rates)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s (the reference's 197e12 is bf16 too)
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 450e9               # NVLink 4 bytes/s each way (the reference's ICI link)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_PATTERN = r"(\w+)\[([\d,]*)\]"
_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    """Size of one shaped buffer like ``bf16[8,2048,512]``."""
    m = re.match(_SHAPE_PATTERN, shape_str.strip())
    if not m:
        return 0
    dt, dims = m.groups()
    b = _DTYPE_BYTES.get(dt)
    if b is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * b


def _result_bytes(line: str, op: str) -> int:
    """Bytes of an HLO instruction's result.

    Handles tuple results (async ``-start`` ops carry (operand, result, ...)
    tuples — the largest member, the actual payload, is taken, so the
    alias slots are not counted twice).
    """
    rhs = line.split("=", 1)[1] if "=" in line else line
    # everything before the op keyword is the result type annotation
    pos = rhs.find(f" {op}")
    head = rhs[:pos] if pos >= 0 else rhs.split("(", 1)[0]
    sizes = []
    for m in re.finditer(_SHAPE_PATTERN, head):
        dt, dims = m.groups()
        b = _DTYPE_BYTES.get(dt, 0)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        sizes.append(n * b)
    if not sizes:
        return 0
    is_start = f"{op}-start(" in rhs
    return max(sizes) if (is_start and len(sizes) > 1) else sum(sizes)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-op-kind result bytes of every collective in an HLO text."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if "=" not in ls:
            continue
        rhs = ls.split("=", 1)[1]
        for op in _COLLECTIVE_OPS:
            # the op name at the call position: "... = TYPE op-name("
            if re.search(rf"\b{op}(?:-start)?\(", rhs):
                # count -start, skip -done (a pair is one collective)
                if f"{op}-done(" in rhs:
                    break
                out[op] += _result_bytes(ls, op)
                break
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    model_flops_per_device: float = 0.0
    peak_memory_bytes: float = 0.0
    # decode cells: the useful work is reading weights+cache once per token;
    # utilization is bandwidth-based, not flops-based.
    model_bytes_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """Useful-work time / dominant-term time: how close the step is to
        the hardware limit that binds it.  Useful work = model FLOPs for
        compute-shaped steps, or the one mandatory weights+cache read for
        decode-shaped steps — whichever gives the higher (fairer) bound."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = max(self.model_flops_per_device / PEAK_FLOPS,
                       self.model_bytes_per_device / HBM_BW)
        return useful_s / self.bound_s

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_per_device": self.model_flops_per_device,
            "model_bytes_per_device": self.model_bytes_per_device,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(num_params: int, tokens: int, kind: str,
                active_params: Optional[int] = None) -> float:
    """6·N·D for training, 2·N·D for inference (per forward token)."""
    n = active_params if active_params is not None else num_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


# ----------------------------------------------------------------------
# counting what runs
# ----------------------------------------------------------------------
_ACTIVE: List["CostCounter"] = []

# metadata queries: no tensor is read or written
_NO_WORK = {torch.ops.aten.sym_is_contiguous.default,
            torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default,
            torch.ops.prim.device.default}


# allocation without a write: no bytes move
_ALLOC_ONLY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def _nbytes(ts: Iterable) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """Counts the work of everything run under it: FLOPs, op bytes,
    collective bytes by kind, and the peak of live bytes.

    ``slots`` is the number of mesh slots the counted run drives; the
    ``*_per_device`` properties divide the totals by it (means over the
    slots).  Tensors that exist before the counter is entered (a step's
    arguments) are not live bytes of the run: :attr:`peak_bytes` is the
    peak of bytes allocated under it and still alive."""

    def __init__(self, slots: int = 1):
        super().__init__()
        self.slots = max(int(slots), 1)
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
        self.live = 0
        self.peak_bytes = 0
        self._quiet = 0
        self._tracked: Dict[int, tuple] = {}
        self._memo: Dict[tuple, tuple] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if self not in _ACTIVE:
            # the counts stay; the storages it watched outlive it untracked
            for _, fin in self._tracked.values():
                fin.detach()
            self._tracked.clear()
            self._memo.clear()
        return super().__exit__(*exc)

    # --- per-device means --------------------------------------------------
    @property
    def flops_per_device(self) -> float:
        return self.flops / self.slots

    @property
    def bytes_per_device(self) -> float:
        return self.bytes / self.slots

    @property
    def coll_per_device(self) -> Dict[str, float]:
        return {k: v / self.slots for k, v in self.coll.items()}

    @property
    def peak_per_device(self) -> float:
        return self.peak_bytes / self.slots

    # --- tracking ----------------------------------------------------------
    def _dead(self, key: int) -> None:
        self.live -= self._tracked.pop(key, (0, None))[0]

    def _track(self, outs: list) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked[key] = (n, weakref.finalize(st, self._dead, key))
            self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _NO_WORK:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # a composite op the counter can see through (as FlopCounterMode)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        flat = _flat(args) + _flat(tuple(kwargs.values()))
        key = _meta_key(func, flat, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            # a functional op on meta seen before with the same operand
            # layouts: fresh outputs of its result layout, no meta kernel
            metas, flops, nbytes, view = hit
            outs = [torch.empty_strided(sz, st, dtype=dt, device="meta")
                    for sz, st, dt in metas]
            out = outs[0] if len(outs) == 1 and isinstance(metas, list) else tuple(outs)
        else:
            out = func(*args, **kwargs)
            outs = _flat(out)
            flops = flop_registry[packet](*args, **kwargs, out_val=out) \
                if packet in flop_registry else 0
            view = _is_view(func) or func in _ALLOC_ONLY
            nbytes = _nbytes(flat) + _nbytes(outs)
            if key is not None and _functional(func):
                metas = [(tuple(v.shape), v.stride(), v.dtype) for v in outs]
                self._memo[key] = (metas if isinstance(out, torch.Tensor) else tuple(metas),
                                   flops, nbytes, view)
        self.flops += flops
        if not self._quiet and not view:
            self.bytes += nbytes
        self._track(outs)
        return out


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.memory_format, torch.layout)
_VIEW: Dict[object, bool] = {}
_FUNCTIONAL: Dict[object, bool] = {}


def _flat(x) -> list:
    """The leaves of nested lists and tuples (an op's arguments or results)."""
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            if isinstance(v, (list, tuple)):
                out.extend(_flat(v))
            else:
                out.append(v)
        return out
    return [x]


def _meta_key(func, flat, kwargs):
    """A memo key for an op whose tensor operands all lie on ``meta``: the
    op, the keyword names and each operand's layout (or value); None where
    none can be made."""
    key = [func, tuple(kwargs)]
    any_tensor = False
    for a in flat:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            any_tensor = True
            key.append((tuple(a.shape), a.stride(), a.dtype, a.storage_offset()))
        elif isinstance(a, _HASHABLE):
            key.append(a)
        else:
            return None
    return tuple(key) if any_tensor else None


def _is_view(func) -> bool:
    """True for an op whose every result aliases an input without writing
    it (views, reshapes that do not copy, slices, ``expand``, ``detach``)."""
    if func not in _VIEW:
        rets = func._schema.returns
        _VIEW[func] = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in rets)
    return _VIEW[func]


def _functional(func) -> bool:
    """An op whose results are fresh tensors: no result aliases an operand,
    none is written in place, and every result is a tensor."""
    if func not in _FUNCTIONAL:
        s = func._schema
        _FUNCTIONAL[func] = bool(s.returns) and not s.is_mutable and all(
            r.alias_info is None and str(r.type) == "Tensor" for r in s.returns)
    return _FUNCTIONAL[func]


def active() -> Optional[CostCounter]:
    """The innermost :class:`CostCounter` entered, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def charge(flops: float = 0.0, nbytes: float = 0.0):
    """Add a hand-written kernel's (or a move's) own work to the active
    counter; op bytes of what runs inside are not counted again.  A no-op
    without a counter."""
    c = active()
    if c is None:
        yield
        return
    c.flops += flops
    c.bytes += nbytes
    c._quiet += 1
    try:
        yield
    finally:
        c._quiet -= 1


def count_collective(kind: str, results: Iterable[torch.Tensor]) -> None:
    """Add each slot's result bytes of one cross-slot move under ``kind``
    (one of the reference's five HLO collectives).  A no-op without a
    counter."""
    c = active()
    if c is not None:
        if kind not in c.coll:
            raise ValueError(f"unknown collective kind {kind!r}")
        c.coll[kind] += _nbytes(results)


@contextlib.contextmanager
def collective(kind: str):
    """Run a cross-slot move: its adds and copies are not counted as op
    bytes; the caller's yielded list of per-slot results is counted under
    ``kind`` on the way out."""
    results: List[torch.Tensor] = []
    with charge():
        yield results
    count_collective(kind, results)


class _GradCount(torch.autograd.Function):
    """Identity whose backward counts the grad's bytes under a kind."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        count_collective(ctx.kind, [g])
        return g, None


def grad_counted(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` itself; under a counter, while autograd records, an identity
    whose backward adds the grad's bytes under ``kind`` (the move that
    carries a cross-slot operand's grad back to its slot: the transpose of
    the forward's collective)."""
    if active() is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradCount.apply(x, kind)


def analyze(arch: str, shape: str, mesh_name: str, counter: CostCounter,
            *, model_flops_total: float, num_devices: int) -> RooflineReport:
    """The report of one counted run (the reference's ``analyze`` of an XLA
    ``compiled``): the counter's per-device means."""
    coll = {k: int(v) for k, v in counter.coll_per_device.items()}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=counter.flops_per_device,
        bytes_per_device=counter.bytes_per_device,
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops_per_device=model_flops_total / num_devices,
        peak_memory_bytes=counter.peak_per_device,
    )
