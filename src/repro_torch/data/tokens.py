"""Synthetic token pipeline: deterministic, shardable, resumable (the JAX
package's ``repro.data.tokens`` with torch generators).

The contract, which the pipeline honours exactly:
  * deterministic in (seed, step) — a restore replays the same batches;
  * host-local sharding — each process materialises only its ``[lo, hi)``
    rows of the global batch, and a slice is reproducible on its own (its
    token draws are seeded from ``lo`` too);
  * constant-time seek — :meth:`TokenPipeline.batch_at` of step N costs
    O(1), not O(N);
  * family-aware — frame embeddings for encdec archs and image embeddings
    for vlm archs (stubs of the modality frontends).  As in the reference,
    these are drawn per (seed, step) for the slice's row count, not per row.

Every draw goes through a :class:`TokenDraws` hook, so a test can replay
another package's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.utils.config import ModelConfig
from repro_torch.utils.device import DeviceLike, resolve_device


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))


class TokenDraws:
    """The pipeline's random draws, each a pure function of its arguments.

    This default seeds a CPU ``torch.Generator`` from the words
    ``(seed, step, stream[, lo])`` through ``numpy.random.SeedSequence``;
    a subclass may return another package's draws (numpy arrays or
    tensors of the same shapes)."""

    @staticmethod
    def _generator(*words: int) -> torch.Generator:
        state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
        return torch.Generator(device="cpu").manual_seed(int(state[0] >> 1))

    def tokens(self, seed: int, step: int, lo: int, n: int, length: int,
               vocab: int):
        """``[n, length]`` uniform token ids in ``[0, vocab)``."""
        return torch.randint(0, vocab, (n, length), dtype=torch.int32,
                             generator=self._generator(seed, step, 0, lo))

    def phase(self, seed: int, step: int, lo: int, n: int, vocab: int):
        """``[n, 1]`` per-row phases of the periodic mode."""
        return torch.randint(0, vocab, (n, 1), dtype=torch.int32,
                             generator=self._generator(seed, step, 0, lo))

    def frames(self, seed: int, step: int, n: int, length: int, d: int):
        """``[n, length, d]`` standard-normal frame embeddings (fp32)."""
        return torch.randn((n, length, d), generator=self._generator(seed, step, 1))

    def image_embeds(self, seed: int, step: int, n: int, tokens: int, d: int):
        """``[n, tokens, d]`` standard-normal patch embeddings (fp32)."""
        return torch.randn((n, tokens, d), generator=self._generator(seed, step, 2))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    mode: str = "uniform"       # "uniform" (entropy floor) | "periodic"
                                # (learnable structure — demos/examples)
    device: DeviceLike = None   # the card unless the caller names a device
    draws: TokenDraws = dataclasses.field(default_factory=TokenDraws)

    def batch_at(self, step: int, *, lo: int = 0, hi: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
        """The (sub-)batch for one step; [lo, hi) selects the host's rows.

        ``tokens`` is ``[hi - lo, seq_len + 1]`` int32; ``frames`` /
        ``image_embeds`` (encdec / vlm) are bf16."""
        dev = resolve_device(self.device)
        hi = self.global_batch if hi is None else hi
        n, cfg, d = hi - lo, self.cfg, self.draws
        as_t = lambda a, dtype: _tensor(a).to(dev, dtype)
        if self.mode == "periodic":
            # next-token-predictable modular walk with random per-row phase
            phase = as_t(d.phase(self.seed, step, lo, n, cfg.vocab_size), torch.int64)
            t = torch.arange(self.seq_len + 1, device=dev)[None, :]
            stride = 1 + (step % 3)
            batch = {"tokens": ((phase + stride * t) % cfg.vocab_size).to(torch.int32)}
        else:
            batch = {"tokens": as_t(d.tokens(self.seed, step, lo, n, self.seq_len + 1,
                                             cfg.vocab_size), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = as_t(d.frames(self.seed, step, n, self.seq_len,
                                            cfg.d_model), torch.float32).bfloat16()
        if cfg.family == "vlm":
            batch["image_embeds"] = as_t(d.image_embeds(
                self.seed, step, n, cfg.num_image_tokens, cfg.d_model),
                torch.float32).bfloat16()
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def state_dict(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step,
                "global_batch": self.global_batch, "seq_len": self.seq_len}
