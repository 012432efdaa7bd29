"""Piecewise Aggregate Approximation (PAA) — paper §IV-B Step 1.

PAA divides a length-n series into w equal segments and represents each
segment by its mean.  ``paa`` here is the plain PyTorch version that lives
beside the CUDA kernel in ``repro_torch.kernels.paa_kernel``; the index's
featurize goes through the kernel for tensors on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paa_kernel import paa_plain as paa

__all__ = ["paa", "znormalize"]


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalise each series (population std, as ``jnp.std``)."""
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)
