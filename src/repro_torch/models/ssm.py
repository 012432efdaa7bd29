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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.layers import rmsnorm, silu
from repro_torch.models.params import ParamInfo
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


def ssd_forward_with_state(p, x: torch.Tensor, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, SSMState]:
    """Chunked SSD returning (output, final decode state) — exact prefill."""
    b, s, d = x.shape
    d_in, h, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} not divisible by ssm_chunk {q}"
    nc = s // q

    x_in, z, bc, dt = _project(p, x, cfg)
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

    # gated norm + out projection (mamba2 layout)
    y = rmsnorm(y * silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])

    # decode state: carried SSD state + causal-conv input tail
    conv_tail = conv_in[:, s - (CONV_W - 1):, :]
    return out, SSMState(h=hstate, conv=conv_tail)


def ssd_decode(p, x: torch.Tensor, state: SSMState, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent step.  x: [B, 1, D] → ([B, 1, D], state)."""
    b = x.shape[0]
    d_in, h, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim

    x_in, z, bc, dt = _project(p, x, cfg)                 # S = 1
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
    y = rmsnorm(y * silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, SSMState(h=h_new, conv=new_conv)
