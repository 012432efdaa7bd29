"""The benchmark's inputs: the collection (on the generator's device, in
chunks) and the build's draws, from the configuration's ``data_seed``, and
the order in which a run draws its queries, from the run's ``--seed``.

The generators are frozen copies of ``repro_torch.data.series`` as it stood
when the benchmark was written (``random_walk``, ``sift_like``,
``seismic_like``, ``make_queries``, paper §VII-A), so a later change to the
program cannot change the yardstick; ``tests/test_climbench_generators.py``
shows that they still give the program's rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GENERATE_CHUNK = 1 << 18     # rows per chunk: bounds the temporaries


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of run ``seed`` (any
    whole number, also one that exceeds 32 bits)."""
    words = [seed % 2**64 & 0xFFFFFFFF, seed % 2**64 >> 32] \
        + [ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalise each series (population std)."""
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def _rows(num: int, length: int, device, make) -> torch.Tensor:
    out = torch.empty((num, length), dtype=torch.float32, device=device)
    for lo in range(0, num, GENERATE_CHUNK):
        rows = min(GENERATE_CHUNK, num - lo)
        out[lo:lo + rows] = make(rows)
    return out


def random_walk(num: int, length: int, *, generator: torch.Generator) -> torch.Tensor:
    """``[num, length]`` z-normalised random walks (Hydra's Rand256 at 256)."""
    dev = generator.device
    return _rows(num, length, dev, lambda rows: znormalize(torch.cumsum(
        torch.randn((rows, length), generator=generator, dtype=torch.float32,
                    device=dev), dim=-1)))


def sift_like(num: int, length: int, *, generator: torch.Generator,
              num_clusters: int = 64, spread: float = 0.15) -> torch.Tensor:
    """Clustered vectors: a random centre plus scaled N(0, 1) noise,
    z-normalised."""
    dev = generator.device
    centers = torch.randn((num_clusters, length), generator=generator,
                          dtype=torch.float32, device=dev)

    def make(rows):
        assign = torch.randint(0, num_clusters, (rows,), generator=generator,
                               device=dev)
        noise = torch.randn((rows, length), generator=generator,
                            dtype=torch.float32, device=dev)
        return znormalize(centers[assign.long()] + noise * spread)
    return _rows(num, length, dev, make)


def _convolve_same(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    m, n = v.shape[0], x.shape[-1]
    off = (m - 1) // 2
    xp = torch.nn.functional.pad(x, (m - 1 - off, off))
    out = torch.zeros_like(x)
    for j in range(m):
        out = out + v[j] * xp[..., m - 1 - j:m - 1 - j + n]
    return out


def seismic_like(num: int, length: int, *, generator: torch.Generator,
                 corr: float = 0.97, num_events: int = 3) -> torch.Tensor:
    """AR(1)-coloured noise plus decaying oscillation bursts, z-normalised."""
    dev = generator.device

    def uniform(rows, lo, hi):
        u = torch.rand((rows, num_events), generator=generator,
                       dtype=torch.float32, device=dev)
        return lo + u * (hi - lo)

    def make(rows):
        white = torch.randn((rows, length), generator=generator,
                            dtype=torch.float32, device=dev)
        onset = uniform(rows, 0.0, 0.8 * length)
        freq = uniform(rows, 0.05, 0.3)
        amp = uniform(rows, 2.0, 6.0)
        tail = torch.pow(torch.tensor(corr, dtype=torch.float32, device=dev),
                         torch.arange(32, dtype=torch.float32, device=dev))
        background = _convolve_same(white, tail)
        t = torch.arange(length, dtype=torch.float32, device=dev)
        dt = t[None, None, :] - onset[..., None]
        coda = torch.where(dt >= 0, torch.exp(-dt / 12.0)
                           * torch.sin(2 * math.pi * freq[..., None] * dt),
                           torch.zeros((), dtype=torch.float32, device=dev))
        return znormalize(background + (amp[..., None] * coda).sum(dim=1))
    return _rows(num, length, dev, make)


GENERATORS = {"randomwalk": random_walk, "sift": sift_like,
              "seismic": seismic_like}


def collection(spec: dict, seed: int, device) -> torch.Tensor:
    """The configuration's ``[rows, series_len]`` float32 collection."""
    gen = GENERATORS[spec["generator"]]
    return gen(spec["rows"], spec["series_len"],
               generator=generator(seed, "collection", device),
               **spec.get("generator_args", {}))


def build_draws(num_rows: int, sample: int, pivots: int, seed: int, device):
    """The index build's two draws: ``sample`` distinct rows of the
    collection, and ``pivots`` distinct rows of that sample."""
    g = generator(seed, "build", device)
    sample_idx = torch.randperm(num_rows, generator=g, device=device)[:sample]
    return sample_idx, torch.randperm(sample, generator=g, device=device)[:pivots]


def deployment(spec: dict, device):
    """The configuration's collection and its build's draws, all from its
    ``data_seed``: every run of a configuration serves the same collection
    through the same index, and only its queries follow the run's seed."""
    from climbench.reference.index import sample_size
    data = collection(spec, spec["data_seed"], device)
    climber = spec["climber"]
    return (data, *build_draws(data.shape[0], sample_size(data.shape[0], climber),
                               climber["num_pivots"], spec["data_seed"], device))


def make_queries(data: torch.Tensor, num_queries: int, *,
                 generator: torch.Generator) -> torch.Tensor:
    """Paper §VII-A: queries are random (distinct) members of the dataset."""
    return data[query_order(data.shape[0], generator=generator)[:num_queries]
                .to(data.device)]


def query_order(num_rows: int, *, generator: torch.Generator) -> torch.Tensor:
    """The order in which a run draws its queries: a permutation of the
    collection's rows, so no query repeats within a run."""
    return torch.randperm(num_rows, generator=generator, device=generator.device)
