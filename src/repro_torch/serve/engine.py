"""Batched serving engine: continuous prefill + decode over request slots
(the JAX package's ``repro.serve.engine`` in PyTorch, same semantics).

A miniature vLLM-shaped loop with static shapes:
  * a fixed number of slots (the serving batch), each holding one sequence,
    in one ``[slots, ...]`` cache at ``max_len``;
  * a new request prefills alone, at batch 1, and its single-row cache is
    written into a free slot's row; ``cache["len"]`` is reset to 0;
  * every tick decodes one token for all slots at ``len`` = the longest
    live slot's length;
  * finished slots (``max_new_tokens``, EOS or ``max_len - 1``) are freed
    and refilled.

Kept from the reference, though they look like faults: a slot shorter than
the longest live one is decoded at that shared position, so it attends to
its zero-filled pad positions and its RoPE position is shifted — its tokens
depend on its neighbours; and an encdec engine sizes its cross-attention
cache at ``max_len``, so its prompts must be exactly ``max_len`` tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import Model, decode_step, init_cache, prefill
from repro_torch.models.params import tree_leaves
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    """Host-clock totals of the engine's two phases (each ends in a copy of
    the chosen tokens to the host, so the card's work is inside them)."""

    prefills: int = 0
    prefill_s: float = 0.0
    ticks: int = 0
    decode_s: float = 0.0
    tokens: int = 0               # generated, prefill tokens included


class Engine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 256, eos_id: int = -1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for t in tree_leaves(params):
            if t.device != self.device:
                raise ValueError(f"a parameter lies on {t.device}, the engine "
                                 f"on {self.device}")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        cfg = model.cfg
        enc_len = max_len if cfg.family == "encdec" else 0
        img_len = cfg.num_image_tokens if cfg.family == "vlm" else 0
        self.cache = init_cache(cfg, slots, max_len, enc_len=enc_len,
                                img_len=img_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_len = np.zeros(slots, dtype=np.int32)
        self.queue: List[Request] = []
        self.stats = EngineStats()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- slot management -------------------------------------------------
    def _put(self, full: torch.Tensor, one: torch.Tensor, i: int) -> None:
        """Write row 0 of a single-request cache entry into slot ``i``; the
        batch axis is the first one of size 1 here and ``slots`` there."""
        for axis in range(one.ndim):
            if one.shape[axis] == 1 and full.shape[axis] == self.slots:
                dst, src = full.select(axis, i), one.select(axis, 0)
                try:
                    dst.copy_(src)
                except RuntimeError as e:
                    raise ValueError(
                        f"a cache row of shape {tuple(src.shape)} does not fit a "
                        f"slot of shape {tuple(dst.shape)} (an encdec engine "
                        f"needs prompts of max_len = {self.max_len} tokens)") from e
                return

    @torch.no_grad()
    def _admit(self) -> None:
        """Prefill queued requests into free slots, one at a time."""
        cfg = self.model.cfg
        for i in range(self.slots):
            if self.slot_req[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t = time.perf_counter()
            s = len(req.prompt)
            batch = {"tokens": torch.as_tensor(np.asarray(req.prompt)[None, :],
                                               device=self.device)}
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros((1, s, cfg.d_model),
                                              dtype=torch.bfloat16, device=self.device)
            if cfg.family == "vlm":
                batch["image_embeds"] = torch.zeros(
                    (1, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                    device=self.device)
            logits, cache1 = prefill(self.model, self.params, batch,
                                     max_len=self.max_len, kv_chunk=64)
            for name, one in cache1.items():
                if name != "len":
                    self._put(self.cache[name], one, i)
            self.cache["len"] = 0              # per-slot lens tracked below
            nxt = int(torch.argmax(logits[0, -1]))
            req.generated.append(nxt)
            self.slot_req[i] = req
            self.slot_len[i] = s
            self.stats.prefills += 1
            self.stats.tokens += 1
            self.stats.prefill_s += time.perf_counter() - t

    def _tick_tokens(self) -> torch.Tensor:
        toks = np.zeros((self.slots, 1), dtype=np.int32)
        for i, req in enumerate(self.slot_req):
            if req is not None and req.generated:
                toks[i, 0] = req.generated[-1]
        return torch.as_tensor(toks, device=self.device)

    @torch.no_grad()
    def step(self) -> None:
        """One engine tick: admit, decode one token for every live slot."""
        self._admit()
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return
        t = time.perf_counter()
        # decode every slot at cache_len = the longest live length
        self.cache["len"] = int(self.slot_len[live].max())
        logits, self.cache = decode_step(self.model, self.params, self.cache,
                                         self._tick_tokens())
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        for i in live:
            req = self.slot_req[i]
            req.generated.append(int(nxt[i]))
            self.slot_len[i] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or int(nxt[i]) == self.eos_id
                    or self.slot_len[i] >= self.max_len - 1):
                req.done = True
                self.slot_req[i] = None
        self.stats.ticks += 1
        self.stats.tokens += len(live)
        self.stats.decode_s += time.perf_counter() - t

    def run_until_drained(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                return
            self.step()
