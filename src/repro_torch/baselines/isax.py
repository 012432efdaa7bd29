"""SAX / iSAX representation (paper §III-B, Fig. 1) — baseline substrate.

SAX divides the value axis into ``cardinality`` stripes whose boundaries are
standard-normal quantiles (Lin et al. [39]) and assigns each PAA segment the
stripe containing its mean.  Both baseline indexes (DPiSAX, TARDIS) work on
these lossy words — the two-level information loss the paper identifies as
the root cause of their low recall.  The PAA goes through ``ops.paa`` (the
``paa`` kernel on the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def sax_breakpoints(cardinality: int, device=None) -> torch.Tensor:
    """Stripe boundaries: N(0,1) quantiles at i/card, i = 1..card-1."""
    probs = torch.arange(1, cardinality, dtype=torch.float32,
                         device=device) / cardinality
    return torch.special.ndtri(probs)


def sax_word(x: torch.Tensor, segments: int, cardinality: int) -> torch.Tensor:
    """SAX transform: raw ``[B, n]`` → symbol word ``[B, w]`` int32.

    Symbols are stripe indices in [0, cardinality), found with the
    left-sided search of ``jnp.searchsorted``; all segments share the same
    cardinality (the indexes refine through bit prefixes of the symbols).
    """
    z = ops.paa(x.float().contiguous(), segments)
    bp = sax_breakpoints(cardinality, device=z.device)
    return torch.searchsorted(bp, z).to(torch.int32)


def isax_bits(word: torch.Tensor, bits: int, cardinality: int) -> torch.Tensor:
    """Keep only the ``bits`` most-significant bits of each symbol (iSAX's
    prefix maintenance, Fig. 1b)."""
    full_bits = int(cardinality).bit_length() - 1
    return (word >> (full_bits - bits)).to(torch.int32)
