"""PAA mean-pool ``[B, n]`` → ``[B, w]``: CUDA kernel and plain version.

Replaces ``repro/kernels/paa_kernel.py::paa``.  The kernel is
``csrc/paa.cu`` (CUDA C++ for ``sm_90a``), bound by HBM bytes: it reads
``4n + 4w`` bytes per row, so at B = 4.2M, n = 256 its bound is 4.56 GB
over 3.35 TB/s.  A persistent grid copies tiles of consecutive segments
(one contiguous range each) through a ring of shared-memory stages with
coalesced ``cp.async``, and one thread per segment sums it out of shared
memory (segments padded to an odd chunk stride, free of bank conflicts).
Each sum runs from 0 in increasing sample order and is divided by the
segment length: :func:`paa_sequential` is that order in PyTorch, and the
kernel equals it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def paa_plain(x: torch.Tensor, segments: int) -> torch.Tensor:
    """Plain PyTorch PAA: ``[..., n]`` → ``[..., w]`` float32 segment means."""
    n = x.shape[-1]
    if n % segments:
        raise ValueError(f"series length {n} not divisible by w={segments}")
    return x.float().reshape(*x.shape[:-1], segments, n // segments).mean(dim=-1)


def paa_sequential(x: torch.Tensor, segments: int) -> torch.Tensor:
    """The kernel's exact order: ``[B, n]`` → ``[B, w]``, each segment summed
    one sample at a time from zero in increasing j, then divided by its
    length.  For the tests and the smoke's bit checks, not the path."""
    b, n = x.shape
    if n % segments:
        raise ValueError(f"series length {n} not divisible by w={segments}")
    xs = x.float().reshape(b, segments, n // segments)
    acc = torch.zeros((b, segments), dtype=torch.float32, device=x.device)
    for j in range(n // segments):
        acc = acc + xs[..., j]
    return acc / (n // segments)


def paa_work(b: int, n: int, w: int) -> _lib.Work:
    """One call's work: ``[B, n]`` read and ``[B, w]`` written (fp32), one
    add per sample."""
    return _lib.Work(flops=b * n, nbytes=4 * (b * n + b * w))


def paa(x: torch.Tensor, segments: int) -> torch.Tensor:
    """PAA through the kernel for a CUDA tensor, the plain version for a
    CPU tensor, the kernel's output and counted work for a ``meta`` tensor.
    ``x``: ``[B, n]`` float32, n divisible by ``segments``."""
    if not _lib.on_card(x):
        return paa_plain(x, segments)
    if x.dim() != 2 or x.shape[1] % segments:
        raise ValueError(f"paa kernel takes [B, n] with n divisible by "
                         f"w={segments}, got {tuple(x.shape)}")
    b, n = x.shape
    _lib.require(x, "paa x", torch.float32, 2)
    if x.device.type == "meta":
        return _lib.meta_outputs(paa_work(b, n, segments), ((b, segments), torch.float32))
    out = torch.empty((b, segments), dtype=torch.float32, device=x.device)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        _lib.check(lib.climber_paa(x.data_ptr(), out.data_ptr(), b, n, segments,
                                   _lib.stream(x.device)), "paa")
    _lib.count_launch(paa)
    return out


paa.launches = 0
