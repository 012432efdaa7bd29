"""Mixture-of-Experts block (olmoe 64e top-8; qwen2-moe 60e top-4 + shared).

The JAX package's dispatch (``repro.models.moe``), kept exactly:
  * top-k routing with softmax gates, normalised over the selected experts;
    ties in the router probabilities go to the lower expert id, as
    ``lax.top_k`` breaks them (a stable descending sort here);
  * capacity-based dispatch: the (token, expert) pairs are sorted stably by
    expert id and gathered into a dense ``[E, C, D]`` block, so the expert
    computation is three batched matmuls; pairs beyond an expert's capacity
    are dropped (later tokens first) and empty slots point at a zero pad
    row;
  * the experts' outputs scatter-add back per token (accumulated in fp32,
    rounded once to the activations' dtype).

Experts are **tensor-parallel over the ff dim** on a mesh, as in the
reference: each model slot holds F/model columns of every expert (and of
the shared experts), runs :func:`moe_local` on its data shard's tokens, and
the slots' partial outputs sum over ``model``.  The router is replicated,
so every model slot of a data shard routes alike; the capacity counts only
that shard's tokens.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.distributed.sharding import psum
from repro_torch.models.layers import model_part, silu
from repro_torch.models.params import ParamInfo
from repro_torch.utils.config import ModelConfig


def moe_infos(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    infos = {
        "router": ParamInfo((d, e), ("embed", "experts"), dtype=torch.float32),
        "w_gate": ParamInfo((e, d, f), ("experts", "embed", "ff")),
        "w_up": ParamInfo((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamInfo((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.shared_expert_d_ff
        infos.update({
            "s_gate": ParamInfo((d, fs), ("embed", "ff")),
            "s_up": ParamInfo((d, fs), ("embed", "ff")),
            "s_down": ParamInfo((fs, d), ("ff", "embed")),
        })
    return infos


def _capacity(tokens: int, k: int, e: int, cf: float) -> int:
    return int(min(tokens, max(math.ceil(tokens * k / e * cf), 8)))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_local(p, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Routed (and shared) experts over local tokens.  x: [T, D] → [T, D]."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(t, k, e, capacity_factor)
    dev = x.device

    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)                              # [T, k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # sort the (token, expert) pairs by expert id; position within an expert
    # group = slot; beyond capacity → dropped (into a discarded row e).
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1).to(x.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    start = torch.searchsorted(se, torch.arange(e, dtype=se.dtype, device=dev))
    pos = torch.arange(t * k, device=dev) - start[se]
    keep = pos < c
    row = torch.where(keep, se, e)
    col = torch.where(keep, pos, 0)

    slot_tok = torch.full((e + 1, c), t, dtype=torch.int64, device=dev)
    slot_tok[row, col] = st.long()
    slot_w = torch.zeros((e + 1, c), dtype=x.dtype, device=dev)
    slot_w[row, col] = sw
    slot_tok, slot_w = slot_tok[:e], slot_w[:e]

    x_pad = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=dev)], dim=0)
    xe = x_pad[slot_tok]                                         # [E, C, D]
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    y = torch.bmm(silu(h) * u, p["w_down"])
    y = y * slot_w[..., None]

    out = torch.zeros((t + 1, d), dtype=torch.float32, device=dev)
    out.index_add_(0, slot_tok.reshape(-1), y.reshape(-1, d).float())
    out = out[:t].to(y.dtype)

    if cfg.num_shared_experts:
        g = x @ p["s_gate"]
        uu = x @ p["s_up"]
        out = out + (silu(g) * uu) @ p["s_down"]
    return out.to(x.dtype)


def moe_slot_params(p, cfg: ModelConfig, j: int, nm: int):
    """Slot ``j``'s ff columns of every expert's weights (the reference's
    shard_map in_specs: ``w_gate`` / ``w_up`` / ``s_gate`` / ``s_up`` split
    on ff, ``w_down`` / ``s_down`` on their ff rows, the router whole)."""
    f, fs = cfg.d_ff, cfg.shared_expert_d_ff
    out = {"router": p["router"],
           "w_gate": model_part(p["w_gate"], 2, f, j, nm),
           "w_up": model_part(p["w_up"], 2, f, j, nm),
           "w_down": model_part(p["w_down"], 1, f, j, nm)}
    if cfg.num_shared_experts:
        out.update({"s_gate": model_part(p["s_gate"], 1, fs, j, nm),
                    "s_up": model_part(p["s_up"], 1, fs, j, nm),
                    "s_down": model_part(p["s_down"], 0, fs, j, nm)})
    return out


def moe_apply(p, x, cfg: ModelConfig, *, mesh=None, model_axis: str = "model",
              capacity_factor: float = 1.25):
    """MoE over x: [B, S, D] (all tokens of the batch share the capacity).

    With a mesh, ``p`` and ``x`` are lists with one entry per slot — its
    moe parameters (embed dims whole) and its data shard's rows, laid out
    by the caller over the batch axes — and each
    slot runs :func:`moe_local` on its ff columns; the partial outputs sum
    over ``model_axis``.  Returns the per-slot outputs."""
    if mesh is None:
        b, s, d = x.shape
        return moe_local(p, x.reshape(-1, d), cfg, capacity_factor).reshape(b, s, d)

    nm = mesh.axis_size(model_axis)
    parts = []
    for slot, (p_l, x_l) in enumerate(zip(p, x)):
        j = mesh.coords(slot).get(model_axis, 0)
        bl, sl, d = x_l.shape
        y = moe_local(moe_slot_params(p_l, cfg, j, nm), x_l.reshape(-1, d), cfg,
                      capacity_factor)
        parts.append(y.reshape(bl, sl, d))
    return psum(parts, mesh, model_axis)
