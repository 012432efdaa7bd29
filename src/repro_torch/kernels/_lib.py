"""Build and bind ``libclimber_kernels.so``, the port's CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface.  At first
use they are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc`` per source,
all started together, then one link — into
``<checkout>/build/repro_torch/<hash>/libclimber_kernels.so``, where the hash
covers the sources and the flags, and the library is loaded with
``ctypes``.  Nothing here runs at import: a machine without ``nvcc`` can
import every module and only fails if a kernel is launched.

Every launcher returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero status.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils import roofline as RL

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libclimber_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> (restype, argtypes); pointers and the stream are c_void_p
_SIGNATURES = {
    "climber_paa": (_I, [_P, _P, _I64, _I, _I, _P]),
    "climber_pivot_rank": (_I, [_P, _P, _P, _I64, _I, _I, _I, _I, _P]),
    "climber_pivot_rank_smem": (_I64, [_I, _I, _I]),
    "climber_refine_topk": (_I, [_P] * 12 + [_I] * 8 + [_P]),
    "climber_refine_group": (_I, [_I, _I]),
    "climber_refine_scratch_bytes": (_I64, [_I] * 6),
    "climber_refine_merge_smem": (_I64, [_I, _I]),
    "climber_refine_topk_query_major": (_I, [_P] * 12 + [_I] * 7 + [_P]),
    "climber_refine_partial_scratch_bytes": (_I64, [_I] * 4),
    "climber_refine_partial_smem": (_I64, [_I, _I, _I]),
    "climber_refine_partial_merge_smem": (_I64, [_I, _I]),
    "climber_pairwise_l2": (_I, [_P, _P, _P, _I, _I64, _I, _P]),
    "climber_qdots": (_I, [_P, _P, _P, _I, _I64, _I, _P]),
    "climber_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source, header and flag the library is built from."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the library if this source hash has not been built yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    log = []
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode:
            failed.append(cmd[-3])
    if not failed:
        objs = [str(tmp / (s.stem + ".o")) for s in sources()]
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME), *objs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}; see {tmp / 'build.log'}\n"
                           + "\n".join(log)[-4000:])
    try:
        os.replace(tmp, out_dir)
    except OSError:          # another process published the same hash first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def build_log() -> str:
    """``nvcc``'s output for the current sources (``-Xptxas -v`` included)."""
    return (BUILD_ROOT / source_hash() / "build.log").read_text()


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().climber_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


# Shared memory one block may use on Hopper (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232_448


def on_card(*tensors: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper, keyed on the tensors' device:
    True for CUDA tensors (launch the kernel, or raise) and for ``meta``
    tensors (the card's route in a dry-run: :func:`meta_outputs`), False
    for CPU tensors (the plain PyTorch version).  Mixed or other devices
    raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cuda", "meta"):
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")


class Work(NamedTuple):
    """What a kernel must do for one call: FLOPs, and bytes (each input
    read once, each output written once).  Each kernel module's work
    function gives it; ``chip_smoke.py``'s bounds and the dry-run's count
    both read it."""
    flops: float
    nbytes: float


def meta_outputs(work: Work, *outs: Tuple[Sequence[int], torch.dtype]):
    """A kernel's call on ``meta`` tensors (a dry-run): outputs of the
    kernel's shapes and dtypes on ``meta``, its work added to the active
    :class:`~repro_torch.utils.roofline.CostCounter`.  Nothing is computed
    or allocated, and no launch is counted."""
    with RL.charge(work.flops, work.nbytes):
        made = tuple(torch.empty(tuple(shape), dtype=dt, device="meta") for shape, dt in outs)
    return made[0] if len(made) == 1 else made


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: the fleet's compactor
    thread launches kernels beside the serving thread."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """The layout a kernel takes: dtype, rank, and C-contiguity."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
