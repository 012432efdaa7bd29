"""Featurize in plain PyTorch: PAA and the P4 rank signature (paper §IV-B).

The reference follows the arithmetic the configuration states for these
steps (float32, TF32 off), in the order the program documents for its
kernels, so the signatures are the program's bit for bit and the index
built from them is the same index:

* PAA: each segment summed one sample at a time from zero, in increasing
  order, then divided by its length;
* pivot distances: ``max((|x|² + x·(−2p)) + |p|², 0)``, where each of the
  three sums runs over the w PAA values in increasing order, one fused
  multiply-add at a time.  A float32 FMA is computed here as the float64
  product (exact for float32 inputs) plus the float64 accumulator, rounded
  to float32; that double rounding differs from one rounding about once in
  2^29 operations, far below a near-tie in the ranking;
* the rank signature: the m nearest pivots by (distance, pivot id).

``precision="tf32"`` is the control: the distances as ``|x|² − 2 x·p + |p|²``
with the dot products taken from inputs rounded to TF32 (10 explicit
mantissa bits, round to nearest even) and accumulated in float32, which is
what a tensor-core matmul with TF32 allowed computes.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 18


def paa(x: torch.Tensor, segments: int) -> torch.Tensor:
    """``[B, n]`` → ``[B, w]`` segment means, summed in increasing order."""
    b, n = x.shape
    seg = n // segments
    xs = x.float().reshape(b, segments, seg)
    acc = torch.zeros((b, segments), dtype=torch.float32, device=x.device)
    for j in range(seg):
        acc = acc + xs[..., j]
    return acc / seg


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (nearest even)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for t in range(x.shape[-1]):
        acc = _fma(x[..., t], x[..., t], acc)
    return acc


def pivot_distances(z: torch.Tensor, pivots: torch.Tensor,
                    precision: str = "fp32") -> torch.Tensor:
    """``[B, r]`` squared distances of ``[B, w]`` rows to ``[r, w]`` pivots."""
    z = z.float()
    pivots = pivots.float()
    if precision == "tf32":
        a2 = (z * z).sum(dim=-1, keepdim=True)
        b2 = (pivots * pivots).sum(dim=-1)
        dots = to_tf32(z) @ to_tf32(pivots).T
        return torch.clamp(a2 - 2.0 * dots + b2, min=0.0)
    x2 = _sumsq(z)
    p2 = _sumsq(pivots)
    m2p = -2.0 * pivots
    ab = torch.zeros((z.shape[0], pivots.shape[0]), dtype=torch.float32,
                     device=z.device)
    for t in range(z.shape[1]):
        ab = _fma(z[:, t, None], m2p[None, :, t], ab)
    d = (x2[:, None] + ab) + p2[None, :]
    return torch.where(d > 0, d, torch.zeros_like(d))


def rank_signature(z: torch.Tensor, pivots: torch.Tensor, m: int,
                   precision: str = "fp32") -> torch.Tensor:
    """``[B, m]`` int32 ids of the m nearest pivots, by (distance, id)."""
    out = []
    r = pivots.shape[0]
    if r > 1 << 16:
        raise ValueError(f"{r} pivots exceed the 16-bit id of the sort key")
    ids = torch.arange(r, dtype=torch.int64, device=z.device)
    for lo in range(0, z.shape[0], CHUNK):
        d = pivot_distances(z[lo:lo + CHUNK], pivots, precision)
        # distances are >= 0, so their bits order as the values do
        key = (d.contiguous().view(torch.int32).long() << 16) | ids
        top = torch.topk(key, m, dim=-1, largest=False, sorted=True).values
        out.append((top & 0xFFFF).to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0, m), dtype=torch.int32,
                                                  device=z.device)
