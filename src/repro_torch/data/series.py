"""Synthetic data series (paper §VII-A), generated on a ``torch.Generator``.

RandomWalk — the standard data-series index benchmark: cumulative sums of
N(0, 1) steps, z-normalised.  Queries are drawn from the dataset itself, as
in the paper.  The generators run on the generator's device, so a dataset
for the card is made on the card.  The JAX package's other generators
(sift, dna, eeg, seismic) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.paa import znormalize

GENERATE_CHUNK = 1 << 18     # rows per chunk: bounds the temporaries


def random_walk(num: int, length: int, *, generator: torch.Generator,
                device=None) -> torch.Tensor:
    """``[num, length]`` float32 z-normalised random walks."""
    device = generator.device if device is None else torch.device(device)
    out = torch.empty((num, length), dtype=torch.float32, device=device)
    for lo in range(0, num, GENERATE_CHUNK):
        rows = min(GENERATE_CHUNK, num - lo)
        steps = torch.randn((rows, length), generator=generator,
                            dtype=torch.float32, device=device)
        out[lo:lo + rows] = znormalize(torch.cumsum(steps, dim=-1))
    return out


GENERATORS = {"randomwalk": random_walk}


def make_dataset(name: str, num: int, length: int, *,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    try:
        gen = GENERATORS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; ported: "
                       f"{sorted(GENERATORS)}") from None
    return gen(num, length, generator=generator, device=device)


def make_queries(data: torch.Tensor, num_queries: int, *,
                 generator: torch.Generator) -> torch.Tensor:
    """Paper §VII-A: queries are random (distinct) members of the dataset."""
    idx = torch.randperm(data.shape[0], generator=generator,
                         device=generator.device)[:num_queries]
    return data[idx.to(data.device)]
