"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060).

Used by ``mamba2-780m`` (pure SSM) and ``zamba2-2.7b`` (hybrid backbone);
the JAX package's ``repro.models.ssm`` in PyTorch.

Prefill uses the chunked SSD algorithm: the sequence is cut into chunks of
Q = ``ssm_chunk`` tokens; within a chunk the contribution is a masked
quadratic (attention-like) product, across chunks one recurrent state
``h ∈ [B, H, hd, N]`` is carried.  Decode is the O(1) recurrence
``h ← h·exp(dt·A) + dt·x ⊗ B; y = C·h``.  The reference's multi-operand
einsums are written as two-operand contractions and products (fp32
throughout the scan, as in the reference).

Simplifications shared with the reference: n_groups = 1, causal-conv
width 4 on the (x, B, C) channels, gated RMSNorm before out-projection.

On a (data, model) mesh each slot runs its SSD heads (:func:`ssd_slots`,
:func:`ssd_decode_slots`).  ``param_pspecs`` splits ``w_xz`` over
``model`` along [x | z] and ``conv_w`` along [x | B | C], so a slot's
heads' columns lie on other slots: :func:`slot_params` fetches them
(:func:`take`).  The gated norm's mean square is a ``psum`` of the slots'
sums over their channels, and the out-projection's partials sum over
``model``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import psum
from repro_torch.models.layers import rmsnorm, silu
from repro_torch.models.params import ParamInfo
from repro_torch.utils import roofline as RL
from repro_torch.utils.config import ModelConfig

CONV_W = 4


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_state


def ssm_infos(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d = cfg.d_model
    d_in, h, n = ssm_dims(cfg)
    conv_ch = d_in + 2 * n                       # x, B, C channels (G=1)
    return {
        "w_xz": ParamInfo((d, 2 * d_in), ("embed", "ff")),
        "w_bc": ParamInfo((d, 2 * n), ("embed", None)),
        "w_dt": ParamInfo((d, h), ("embed", None)),
        "dt_bias": ParamInfo((h,), (None,), init="zeros", dtype=torch.float32),
        "a_log": ParamInfo((h,), (None,), init="zeros", dtype=torch.float32),
        "d_skip": ParamInfo((h,), (None,), init="ones", dtype=torch.float32),
        "conv_w": ParamInfo((CONV_W, conv_ch), ("conv", "ff"), scale=0.5),
        "norm": ParamInfo((d_in,), ("ff",), init="ones"),
        "out_proj": ParamInfo((d_in, d), ("ff", "embed")),
    }


class SSMState(NamedTuple):
    """Decode-time state: recurrent h + causal-conv tail."""

    h: torch.Tensor          # [B, H, hd, N] float32
    conv: torch.Tensor       # [B, CONV_W - 1, conv_ch]


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMState:
    d_in, h, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    return SSMState(
        h=torch.zeros((batch, h, hd, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d_in + 2 * n), dtype=dtype,
                         device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-over)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_W.  x: [B, S, C]; w: [CONV_W, C]."""
    s = x.shape[1]
    pads = torch.nn.functional.pad(x, (0, 0, CONV_W - 1, 0))
    out = sum(pads[:, i:i + s, :] * w[i] for i in range(CONV_W))
    return silu(out)


def _project(p, x: torch.Tensor, cfg: ModelConfig):
    xz = torch.einsum("bsd,de->bse", x, p["w_xz"])
    x_in, z = torch.chunk(xz, 2, dim=-1)
    bc = torch.einsum("bsd,de->bse", x, p["w_bc"])
    dt = _softplus(torch.einsum("bsd,dh->bsh", x, p["w_dt"]).float()
                   + p["dt_bias"])
    return x_in, z, bc, dt


def ssd_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD over the full sequence.  x: [B, S, D] → [B, S, D]."""
    y, _ = ssd_forward_with_state(p, x, cfg)
    return y


def _ssd_mix(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """Chunked SSD up to the gated norm: ``(y · silu(z), final state)``.

    ``p`` holds whole weights or one slot's heads' (:func:`slot_params`):
    the head count is ``w_dt``'s columns, the x channels half of
    ``w_xz``'s."""
    b, s, d = x.shape
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} not divisible by ssm_chunk {q}"
    nc = s // q

    x_in, z, bc, dt = _project(p, x, cfg)
    d_in = x_in.shape[-1]
    h = d_in // hd
    conv_in = torch.cat([x_in, bc], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"])
    x_c = conv_out[..., :d_in].reshape(b, s, h, hd)
    b_c = conv_out[..., d_in:d_in + n]                    # [B, S, N]
    c_c = conv_out[..., d_in + n:]                        # [B, S, N]

    a = -torch.exp(p["a_log"])                            # [H], negative
    da = dt * a                                           # [B, S, H]

    # chunk views
    xq = x_c.reshape(b, nc, q, h, hd).float()
    bq = b_c.reshape(b, nc, q, n).float()
    cq = c_c.reshape(b, nc, q, n).float()
    dtq = dt.reshape(b, nc, q, h)
    daq = da.reshape(b, nc, q, h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    hstate = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for j in range(nc):
        xb, bb, cb, dtb, dab = xq[:, j], bq[:, j], cq[:, j], dtq[:, j], daq[:, j]
        cum = torch.cumsum(dab, dim=1)                    # [B, Q, H]
        # intra-chunk: decay(i, j) = exp(cum_i - cum_j), i >= j.  The
        # reference exponentiates every (i, j) and masks after, so where
        # exp(cum_i - cum_j) overflows above the diagonal its backward is
        # 0 · inf = NaN; masking the exponent first gives the same forward
        # (exp(-inf) = 0) and a finite backward.
        diff = cum[:, :, None, :] - cum[:, None, :, :]    # [B, Q, Q, H]
        decay = torch.exp(torch.where(mask[None, :, :, None], diff, float("-inf")))
        scores = torch.einsum("bin,bjn->bij", cb, bb)     # [B, Q, Q]
        w = scores[..., None] * decay * dtb[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xb)  # [B, Q, H, hd]

        # inter-chunk: contribution of the carried state
        state_decay = torch.exp(cum)                      # [B, Q, H]
        y_inter = torch.einsum("bin,bhpn->bihp", cb, hstate) * state_decay[..., None]

        # state update: h' = h·exp(total) + Σ_j exp(total - cum_j) dt_j x_j B_j
        total = cum[:, -1, :]                             # [B, H]
        suffix = torch.exp(total[:, None, :] - cum)       # [B, Q, H]
        upd = torch.einsum("bjhp,bjn->bhpn", xb * (dtb * suffix)[..., None], bb)
        hstate = hstate * torch.exp(total)[:, :, None, None] + upd
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)
    y = y + p["d_skip"][None, None, :, None] * x_c.float()
    y = y.reshape(b, s, d_in).to(x.dtype)

    # decode state: carried SSD state + causal-conv input tail
    conv_tail = conv_in[:, s - (CONV_W - 1):, :]
    return y * silu(z), SSMState(h=hstate, conv=conv_tail)


def ssd_forward_with_state(p, x: torch.Tensor, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, SSMState]:
    """Chunked SSD returning (output, final decode state) — exact prefill."""
    g, state = _ssd_mix(p, x, cfg)
    # gated norm + out projection (mamba2 layout)
    out = torch.einsum("bse,ed->bsd", rmsnorm(g, p["norm"]), p["out_proj"])
    return out, state


def _ssd_step(p, x: torch.Tensor, state: SSMState, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, SSMState]:
    """One recurrent step up to the gated norm (``p`` as in :func:`_ssd_mix`;
    ``state`` its heads' h and its channels' conv tail)."""
    b = x.shape[0]
    n, hd = cfg.ssm_state, cfg.ssm_head_dim

    x_in, z, bc, dt = _project(p, x, cfg)                 # S = 1
    d_in = x_in.shape[-1]
    h = d_in // hd
    conv_in = torch.cat([x_in, bc], dim=-1)               # [B, 1, C]
    window = torch.cat([state.conv, conv_in], dim=1)      # [B, CONV_W, C]
    conv_out = silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]))
    new_conv = window[:, 1:, :]

    x_c = conv_out[:, :d_in].reshape(b, h, hd).float()
    b_c = conv_out[:, d_in:d_in + n].float()
    c_c = conv_out[:, d_in + n:].float()
    dt1 = dt[:, 0, :]                                     # [B, H]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt1 * a)                            # [B, H]

    h_new = state.h * decay[:, :, None, None] \
        + (x_c * dt1[:, :, None])[..., None] * b_c[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", c_c, h_new)
    y = y + p["d_skip"][None, :, None] * x_c
    y = y.reshape(b, 1, d_in).to(x.dtype)
    return y * silu(z), SSMState(h=h_new, conv=new_conv)


def ssd_decode(p, x: torch.Tensor, state: SSMState, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent step.  x: [B, 1, D] → ([B, 1, D], state)."""
    g, state = _ssd_step(p, x, state, cfg)
    out = torch.einsum("bse,ed->bsd", rmsnorm(g, p["norm"]), p["out_proj"])
    return out, state


# ----------------------------------------------------------------------
# the model axis: one slot's SSD heads
# ----------------------------------------------------------------------
Ranges = List[Tuple[int, int]]


def piece_range(t: torch.Tensor, dim: int, full: int, j: int, nm: int) -> Ranges:
    """The range of a ``full``-long dim that slot ``j``'s piece ``t`` holds:
    its equal part where the dim is split over the ``nm`` model slots, else
    all of it."""
    if t.shape[dim] == full:
        return [(0, full)]
    return [(j * t.shape[dim], (j + 1) * t.shape[dim])]


def take(xs: Sequence[torch.Tensor], have: Sequence[Ranges], want: Sequence[Ranges],
         mesh, dim: int, axis: str = "model") -> List[torch.Tensor]:
    """Each slot's ``want`` ranges of a dim, joined along ``dim``: the slot
    ``s`` piece ``xs[s]`` holds the ranges ``have[s]`` in that order, and
    every part of a wanted range comes from the slot itself where it holds
    it, else from the first slot of its group on ``axis`` that does (a
    gather of just the columns a slot uses).  Under a cost counter the
    parts fetched from other slots count as collective-permute bytes."""
    out = []
    with RL.collective("collective-permute") as moved:
        for s, group in enumerate(mesh.groups(axis)):
            if list(want[s]) == list(have[s]):
                out.append(xs[s])
                continue
            order = [s] + [g for g in group if g != s]
            parts = []
            for lo, hi in want[s]:
                pos = lo
                while pos < hi:
                    for src in order:
                        off = 0
                        for a, b in have[src]:
                            if a <= pos < b:
                                n = min(hi, b) - pos
                                part = xs[src].narrow(dim, off + pos - a, n)
                                if src != s:
                                    part = RL.grad_counted(part, "collective-permute")
                                    moved.append(part)
                                parts.append(part.to(mesh.slots[s]))
                                pos += n
                                break
                            off += b - a
                        else:
                            continue
                        break
                    else:
                        raise ValueError(f"no slot of {group} holds index {pos}")
            out.append(torch.cat(parts, dim) if len(parts) != 1 else parts[0])
    return out


def slot_heads(cfg: ModelConfig, j: int, nm: int) -> Tuple[Tuple[int, int], Ranges, Ranges]:
    """Slot ``j``'s SSD heads ``(h0, h1)``, their x channels, and those
    with the B and C channels after them (its conv channels)."""
    d_in, h, n = ssm_dims(cfg)
    h0, h1 = j * h // nm, (j + 1) * h // nm
    ch = [(h0 * cfg.ssm_head_dim, h1 * cfg.ssm_head_dim)]
    return (h0, h1), ch, ch + [(d_in, d_in + 2 * n)]


def slot_params(ps: Sequence[Dict[str, torch.Tensor]], cfg: ModelConfig, mesh
                ) -> List[Dict[str, torch.Tensor]]:
    """Each slot's weights for its heads, from the slots' ssm pieces (embed
    dims whole).  ``w_xz`` splits over ``model`` along [x | z] and
    ``conv_w`` along [x | B | C], so the x and z columns and conv channels
    of a slot's heads lie on other slots: :func:`take` fetches them, and
    ``norm`` and ``out_proj``'s rows where the heads do not divide as the
    channels do.  ``w_dt`` and the per-head vectors are whole on every
    slot: the slot's columns of them."""
    d_in, _, n = ssm_dims(cfg)
    nm = mesh.axis_size("model")
    js = [mesh.coords(s).get("model", 0) for s in range(mesh.size)]
    heads = [slot_heads(cfg, j, nm) for j in js]

    def fetch(name, dim, full, want):
        have = [piece_range(p[name], dim, full, j, nm) for p, j in zip(ps, js)]
        return take([p[name] for p in ps], have, want, mesh, dim)

    w_xz = fetch("w_xz", 1, 2 * d_in, [ch + [(d_in + a, d_in + b) for a, b in ch]
                                       for _, ch, _ in heads])
    conv_w = fetch("conv_w", 1, d_in + 2 * n, [conv for _, _, conv in heads])
    norm = fetch("norm", 0, d_in, [ch for _, ch, _ in heads])
    out_proj = fetch("out_proj", 0, d_in, [ch for _, ch, _ in heads])
    out = []
    for s, (p, ((h0, h1), _, _)) in enumerate(zip(ps, heads)):
        out.append({"w_xz": w_xz[s], "w_bc": p["w_bc"], "w_dt": p["w_dt"][:, h0:h1],
                    "dt_bias": p["dt_bias"][h0:h1], "a_log": p["a_log"][h0:h1],
                    "d_skip": p["d_skip"][h0:h1], "conv_w": conv_w[s], "norm": norm[s],
                    "out_proj": out_proj[s]})
    return out


def gated_out_slots(sps, gs: Sequence[torch.Tensor], d_in: int, mesh,
                    eps: float = 1e-6) -> List[torch.Tensor]:
    """Each slot's partial of ``rmsnorm(g) @ out_proj`` from its channels
    ``g`` of ``y · silu(z)``: the mean square over all ``d_in`` channels is
    the ``psum`` of the slots' sums over ``model``.  The partials sum over
    ``model`` to the block's output."""
    ss = psum([torch.sum(g.float() * g.float(), dim=-1, keepdim=True) for g in gs],
              mesh, "model")
    return [torch.einsum("bse,ed->bsd",
                         (g.float() * torch.rsqrt(t / d_in + eps)).to(g.dtype) * sp["norm"],
                         sp["out_proj"])
            for sp, g, t in zip(sps, gs, ss)]


def ssd_slots(sps, xs: Sequence[torch.Tensor], cfg: ModelConfig, mesh
              ) -> Tuple[List[torch.Tensor], List[SSMState]]:
    """The chunked SSD on every slot, each with its heads (``sps`` from
    :func:`slot_params`, ``xs`` its rows' [B, S, D] input): ``(partials,
    states)``, each state its heads' h and its conv channels' tail."""
    mixed = [_ssd_mix(sp, x, cfg) for sp, x in zip(sps, xs)]
    return (gated_out_slots(sps, [m[0] for m in mixed], ssm_dims(cfg)[0], mesh),
            [m[1] for m in mixed])


def ssd_decode_slots(sps, xs: Sequence[torch.Tensor], states: Sequence[SSMState],
                     cfg: ModelConfig, mesh) -> Tuple[List[torch.Tensor], List[SSMState]]:
    """One recurrent step on every slot, each with its heads and its state
    (as :func:`ssd_slots` returns it)."""
    mixed = [_ssd_step(sp, x, st, cfg) for sp, x, st in zip(sps, xs, states)]
    return (gated_out_slots(sps, [m[0] for m in mixed], ssm_dims(cfg)[0], mesh),
            [m[1] for m in mixed])
