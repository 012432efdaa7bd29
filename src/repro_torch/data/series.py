"""Synthetic data series (paper §VII-A), generated on a ``torch.Generator``.

  * RandomWalk — the standard data-series index benchmark: cumulative sums
    of N(0, 1) steps, z-normalised.
  * SIFT-like  — clustered feature vectors (Gaussian noise around random
    centres; image descriptors cluster heavily).
  * DNA-like   — a 4-letter random walk, box-smoothed.
  * EEG-like   — sums of band-limited sinusoids plus noise.
  * Seismic-like — AR(1)-coloured noise with sparse decaying-oscillation
    bursts (event codas).

Each generator draws its random numbers from the generator (on the
generator's device, so a dataset for the card is made on the card) and hands
them to a deterministic body (``*_body``) with the arithmetic of
``repro.data.series``; a test feeds a body the JAX package's draws.  Rows are
made in chunks of :data:`GENERATE_CHUNK` to bound the temporaries.  Queries
are drawn from the dataset itself, as in the paper.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.paa import znormalize

GENERATE_CHUNK = 1 << 18     # rows per chunk: bounds the temporaries


def convolve_same(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.convolve(row, v, mode="same")`` for ``[B, N]`` rows
    with N ≥ len(v): a true convolution (the kernel flipped, unlike
    ``conv1d``), centred at offset ``(M - 1) // 2`` of the full one.  Written
    as M shifted multiply-adds, so no cuDNN (and no TF32) is involved."""
    m, n = v.shape[0], x.shape[-1]
    off = (m - 1) // 2
    xp = F.pad(x, (m - 1 - off, off))
    out = torch.zeros_like(x)
    for j in range(m):
        out = out + v[j] * xp[..., m - 1 - j:m - 1 - j + n]
    return out


def _rows(num: int, length: int, device, make) -> torch.Tensor:
    """``[num, length]`` float32, filled chunk by chunk by ``make(rows)``."""
    out = torch.empty((num, length), dtype=torch.float32, device=device)
    for lo in range(0, num, GENERATE_CHUNK):
        rows = min(GENERATE_CHUNK, num - lo)
        out[lo:lo + rows] = make(rows)
    return out


def _device(generator: torch.Generator, device) -> torch.device:
    return generator.device if device is None else torch.device(device)


def random_walk(num: int, length: int, *, generator: torch.Generator,
                device=None) -> torch.Tensor:
    """``[num, length]`` float32 z-normalised random walks."""
    dev = _device(generator, device)
    return _rows(num, length, dev, lambda rows: znormalize(torch.cumsum(
        torch.randn((rows, length), generator=generator, dtype=torch.float32,
                    device=dev), dim=-1)))


def sift_body(centers: torch.Tensor, assign: torch.Tensor, noise: torch.Tensor,
              spread: float = 0.15) -> torch.Tensor:
    """Cluster centre plus scaled N(0, 1) noise, z-normalised."""
    return znormalize(centers[assign.long()] + noise * spread)


def sift_like(num: int, length: int, *, generator: torch.Generator,
              device=None, num_clusters: int = 64,
              spread: float = 0.15) -> torch.Tensor:
    dev = _device(generator, device)
    centers = torch.randn((num_clusters, length), generator=generator,
                          dtype=torch.float32, device=dev)

    def make(rows):
        assign = torch.randint(0, num_clusters, (rows,), generator=generator,
                               device=dev)
        noise = torch.randn((rows, length), generator=generator,
                            dtype=torch.float32, device=dev)
        return sift_body(centers, assign, noise, spread)
    return _rows(num, length, dev, make)


def dna_body(letters: torch.Tensor, smooth: int = 8) -> torch.Tensor:
    """Letters in {0..3} as levels, accumulated, box-smoothed, z-normalised."""
    walk = torch.cumsum(letters.float() - 1.5, dim=-1)
    kernel = torch.ones((smooth,), dtype=torch.float32, device=walk.device) / smooth
    return znormalize(convolve_same(walk, kernel))


def dna_like(num: int, length: int, *, generator: torch.Generator,
             device=None, smooth: int = 8) -> torch.Tensor:
    dev = _device(generator, device)
    return _rows(num, length, dev, lambda rows: dna_body(
        torch.randint(0, 4, (rows, length), generator=generator, device=dev),
        smooth))


def eeg_body(freqs: torch.Tensor, phases: torch.Tensor, amps: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sum of sinusoids (400 Hz sampling) plus 0.3 × noise, z-normalised."""
    length = noise.shape[-1]
    t = torch.arange(length, dtype=torch.float32, device=noise.device) / 400.0
    waves = amps[..., None] * torch.sin(
        2 * math.pi * freqs[..., None] * t + phases[..., None])
    return znormalize(waves.sum(dim=1) + noise * 0.3)


def eeg_like(num: int, length: int, *, generator: torch.Generator,
             device=None, num_bands: int = 5) -> torch.Tensor:
    dev = _device(generator, device)

    def uniform(rows, lo, hi):
        u = torch.rand((rows, num_bands), generator=generator,
                       dtype=torch.float32, device=dev)
        return lo + u * (hi - lo)

    def make(rows):
        freqs = uniform(rows, 0.5, 40.0)
        phases = uniform(rows, 0.0, 2 * math.pi)
        amps = uniform(rows, 0.2, 1.0)
        noise = torch.randn((rows, length), generator=generator,
                            dtype=torch.float32, device=dev)
        return eeg_body(freqs, phases, amps, noise)
    return _rows(num, length, dev, make)


def seismic_body(white: torch.Tensor, onset: torch.Tensor, freq: torch.Tensor,
                 amp: torch.Tensor, corr: float = 0.97) -> torch.Tensor:
    """AR(1)-coloured background (white noise convolved with a 32-tap
    geometric tail) plus decaying sinusoid bursts at ``onset``, z-normalised."""
    dev = white.device
    length = white.shape[-1]
    tail = torch.pow(torch.tensor(corr, dtype=torch.float32, device=dev),
                     torch.arange(32, dtype=torch.float32, device=dev))
    background = convolve_same(white, tail)
    t = torch.arange(length, dtype=torch.float32, device=dev)
    dt = t[None, None, :] - onset[..., None]                      # [N, E, n]
    coda = torch.where(dt >= 0,
                       torch.exp(-dt / 12.0)
                       * torch.sin(2 * math.pi * freq[..., None] * dt),
                       torch.zeros((), dtype=torch.float32, device=dev))
    events = (amp[..., None] * coda).sum(dim=1)
    return znormalize(background + events)


def seismic_like(num: int, length: int, *, generator: torch.Generator,
                 device=None, corr: float = 0.97,
                 num_events: int = 3) -> torch.Tensor:
    dev = _device(generator, device)

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
        return seismic_body(white, onset, freq, amp, corr)
    return _rows(num, length, dev, make)


GENERATORS = {
    "randomwalk": random_walk,
    "sift": sift_like,
    "dna": dna_like,
    "eeg": eeg_like,
    "seismic": seismic_like,
}


def make_dataset(name: str, num: int, length: int, *,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    try:
        gen = GENERATORS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; have "
                       f"{sorted(GENERATORS)}") from None
    return gen(num, length, generator=generator, device=device)


def make_queries(data: torch.Tensor, num_queries: int, *,
                 generator: torch.Generator) -> torch.Tensor:
    """Paper §VII-A: queries are random (distinct) members of the dataset."""
    idx = torch.randperm(data.shape[0], generator=generator,
                         device=generator.device)[:num_queries]
    return data[idx.to(data.device)]
