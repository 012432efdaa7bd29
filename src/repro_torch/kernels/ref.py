"""The plain PyTorch oracle of every ported kernel, under the names of
``repro.kernels.ref``.

Each oracle is the plain version that lives beside its kernel; the CPU tests
hold them against the JAX oracles and the Pallas kernels in interpret mode,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from repro_torch.kernels.l2 import pairwise_l2_plain as pairwise_l2_ref
from repro_torch.kernels.l2 import qdots_plain as qdots_ref
from repro_torch.kernels.paa_kernel import paa_plain as paa_ref
from repro_torch.kernels.pivot_rank import pivot_rank_plain as pivot_rank_ref
from repro_torch.kernels.refine_topk import refine_topk_plain as refine_topk_ref

__all__ = ["pairwise_l2_ref", "qdots_ref", "paa_ref", "pivot_rank_ref",
           "refine_topk_ref"]
