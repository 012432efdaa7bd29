"""Core layers shared by every architecture of the zoo.

Pure functions over explicit parameter dicts, as in the JAX package
(``repro.models.layers``), so the parameters stay one tree the caller owns.
Attention is the reference's chunked online-softmax ("flash") formulation
in plain PyTorch: fp32 scores and softmax, KV heads expanded per chunk,
masking with :data:`NEG_INF` — not ``scaled_dot_product_attention``, whose
summation order differs from the reference's.

The JAX package's perf-harness switches (bf16 flash operands, the masked
cache update, sharded flash-decoding, inner-scan unrolling) are not ported
yet: this module runs the reference's defaults.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.params import ParamInfo
from repro_torch.utils.config import ModelConfig

NEG_INF = -2.0e38


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, two roundings as ``jax.nn.silu`` has them."""
    return x * torch.sigmoid(x)


# ----------------------------------------------------------------------
# normalisation + positional encoding
# ----------------------------------------------------------------------
def rmsnorm_info(d: int) -> ParamInfo:
    return ParamInfo((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * weight


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # [hd/2]
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        angles = positions[:, None].float() * freqs[None, :]
        angles = angles[None, :, None, :]                      # [1, S, 1, hd/2]
    else:
        angles = positions[..., None].float() * freqs
        angles = angles[:, :, None, :]                         # [B, S, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# chunked online-softmax attention
# ----------------------------------------------------------------------
def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``new`` at ``pos`` along axis 1 of a [B, S, ...] cache, into a
    copy.  The start clamps to ``[0, S - len]`` as XLA's
    ``dynamic_update_slice`` clamps it."""
    n = new.shape[1]
    start = min(max(int(pos), 0), cache.shape[1] - n)
    out = cache.clone()
    out[:, start:start + n] = new.to(cache.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, kv_chunk: int = 2048,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the reference's order.

    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] (grouped-query: H = KV * G),
    KV heads expanded to H per chunk.  q_offset: absolute position of q[0]
    (causal masking in decode).  kv_valid: [B, Skv] bool cache-validity
    mask.  Returns [B, Sq, H, hd_v] in q.dtype; scores and softmax in fp32.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    nchunks = max(skv // kv_chunk, 1)
    chunk = skv // nchunks
    assert skv % nchunks == 0, (skv, nchunks)
    dev = q.device

    qf = q.float() * scale                                   # [B, Sq, H, hd]
    q_pos = q_offset + torch.arange(sq, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=dev)

    hd_v = v.shape[-1]                        # MLA: v head dim != qk head dim
    acc = torch.zeros((b, sq, h, hd_v), dtype=torch.float32, device=dev)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, sq, h), dtype=torch.float32, device=dev)

    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_e, v_e = k[:, sl].float(), v[:, sl].float()
        if g > 1:
            k_e = torch.repeat_interleave(k_e, g, dim=2)     # [B, c, H, hd]
            v_e = torch.repeat_interleave(v_e, g, dim=2)
        s = torch.einsum("bqhd,bchd->bqhc", qf, k_e)
        mask = kv_valid[:, sl][:, None, None, :]
        if causal:
            kpos = torch.arange(sl.start, sl.stop, device=dev)
            cm = q_pos[:, None] >= kpos[None, :]              # [Sq, chunk]
            mask = mask & cm[None, :, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhc,bchd->bqhd", p, v_e)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(denom[..., None], 1e-30)
    return out.to(q.dtype)


# ----------------------------------------------------------------------
# grouped-query attention (GQA / MQA / MHA)
# ----------------------------------------------------------------------
def gqa_infos(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamInfo((d, h, hd), ("embed", "heads", "hd")),
        "wk": ParamInfo((d, kv, hd), ("embed", "kv_heads", "hd")),
        "wv": ParamInfo((d, kv, hd), ("embed", "kv_heads", "hd")),
        "wo": ParamInfo((h, hd, d), ("heads", "hd", "embed")),
    }


def gqa_project_kv(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    return k, v


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                  positions: Optional[torch.Tensor] = None,
                  kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  kv_valid: Optional[torch.Tensor] = None,
                  q_offset: int = 0, kv_chunk: int = 2048) -> torch.Tensor:
    """Full-sequence GQA (prefill / encoder / cross-attention).

    kv_override: use externally produced (k, v) — cross-attention or cache.
    """
    s = x.shape[1]
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    if kv_override is None:
        k, v = gqa_project_kv(p, x)
    else:
        k, v = kv_override
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.use_rope and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.use_rope:
        q = apply_rope(q, q_offset + torch.arange(s, device=x.device), cfg.rope_theta)
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                          kv_chunk=kv_chunk, kv_valid=kv_valid)
    return torch.einsum("bsqh,qhd->bsd", out, p["wo"])


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, kv_chunk: int = 2048):
    """Causal attention over the prompt, returning (out, k, v) for caching.

    The returned k is post-RoPE — exactly what ``gqa_decode`` appends to.
    """
    s = x.shape[1]
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    k, v = gqa_project_kv(p, x)
    if cfg.use_rope:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    return torch.einsum("bsqh,qhd->bsd", out, p["wo"]), k, v


def _decode_valid(b: int, s_max: int, cache_len: int, device) -> torch.Tensor:
    return (torch.arange(s_max, device=device) <= cache_len)[None, :].expand(b, s_max)


def gqa_decode(p, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
               cache_len: int, cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    """One-token decode against a [B, S_max, KV, hd] cache.

    Returns (out, new_k, new_v): caches updated at position cache_len.
    """
    b = x.shape[0]
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    k_new = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v_new = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if cfg.use_rope:
        pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    cache_k = _cache_write(cache_k, k_new, cache_len)
    cache_v = _cache_write(cache_v, v_new, cache_len)
    s_max = cache_k.shape[1]
    valid = _decode_valid(b, s_max, cache_len, x.device)
    out = flash_attention(q, cache_k, cache_v, causal=False, kv_valid=valid,
                          kv_chunk=s_max)
    out = torch.einsum("bsqh,qhd->bsd", out, p["wo"])
    return out, cache_k, cache_v


# ----------------------------------------------------------------------
# multi-head latent attention (MLA — minicpm3 / deepseek-v2 style)
# ----------------------------------------------------------------------
def mla_infos(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, h = cfg.d_model, cfg.num_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "q_down": ParamInfo((d, ql), ("embed", "lora")),
        "q_up": ParamInfo((ql, h, dn + dr), ("lora", "heads", "hd")),
        "kv_down": ParamInfo((d, kl + dr), ("embed", "lora")),
        "kv_up": ParamInfo((kl, h, dn + dv), ("lora", "heads", "hd")),
        "wo": ParamInfo((h, dv, d), ("heads", "hd", "embed")),
    }


def _mla_q(p, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dl,lqh->bsqh")`` in the reference's contraction order:
    ``x @ q_down`` first, its result rounded to x's dtype."""
    return torch.einsum("bsl,lqh->bsqh", torch.einsum("bsd,dl->bsl", x, p["q_down"]),
                        p["q_up"])


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    """Project to per-head q/k/v from the compressed latents."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kl = cfg.kv_lora_rank
    q = _mla_q(p, x)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = torch.einsum("bsd,dl->bsl", x, p["kv_down"])      # [B,S,kl+dr]
    c, k_rope = ckv[..., :kl], ckv[..., kl:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    kv = torch.einsum("bsl,lqh->bsqh", c, p["kv_up"])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope_b = k_rope.expand(k_nope.shape[:-1] + (dr,))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    return q_full, k_full, v, ckv


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                  q_offset: int = 0, kv_chunk: int = 2048) -> torch.Tensor:
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v, _ = _mla_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          kv_chunk=kv_chunk)
    return torch.einsum("bsqh,qhd->bsd", out, p["wo"])


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, kv_chunk: int = 2048):
    """MLA prefill returning (out, ckv_store [B, S, kl+dr]).

    The stored latent is [compressed c, post-RoPE k_rope] — the exact layout
    ``mla_decode`` appends to and re-expands.
    """
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v, ckv = _mla_qkv(p, x, cfg, positions)
    kl = cfg.kv_lora_rank
    c, k_rope_raw = ckv[..., :kl], ckv[..., kl:]
    k_roped = apply_rope(k_rope_raw[:, :, None, :], positions,
                         cfg.rope_theta)[:, :, 0, :]
    ckv_store = torch.cat([c, k_roped], dim=-1)
    out = flash_attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    return torch.einsum("bsqh,qhd->bsd", out, p["wo"]), ckv_store


def mla_decode(p, x: torch.Tensor, cache_ckv: torch.Tensor, cache_len: int,
               cfg: ModelConfig):
    """MLA decode with the *compressed* cache [B, S_max, kl + dr]: per token
    only kl + dr values are stored; k/v are re-expanded per step through
    kv_up."""
    b = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kl = cfg.kv_lora_rank
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
    q = _mla_q(p, x)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    ckv_new = torch.einsum("bsd,dl->bsl", x, p["kv_down"])
    c_new, kr_new = ckv_new[..., :kl], ckv_new[..., kl:]
    kr_new = apply_rope(kr_new[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    ckv_store = torch.cat([c_new, kr_new], dim=-1)
    cache_ckv = _cache_write(cache_ckv, ckv_store, cache_len)

    c_all = cache_ckv[..., :kl]
    kr_all = cache_ckv[..., kl:]
    kv = torch.einsum("bsl,lqh->bsqh", c_all, p["kv_up"])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_full = torch.cat([k_nope, kr_all[:, :, None, :].expand(
        k_nope.shape[:-1] + (dr,))], dim=-1)
    s_max = cache_ckv.shape[1]
    valid = _decode_valid(b, s_max, cache_len, x.device)
    out = flash_attention(q_full, k_full, v, causal=False, kv_valid=valid,
                          kv_chunk=s_max)
    out = torch.einsum("bsqh,qhd->bsd", out, p["wo"])
    return out, cache_ckv


# ----------------------------------------------------------------------
# MLPs + embedding
# ----------------------------------------------------------------------
def swiglu_infos(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamInfo]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamInfo((d, f), ("embed", "ff")),
        "w_up": ParamInfo((d, f), ("embed", "ff")),
        "w_down": ParamInfo((f, d), ("ff", "embed")),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", silu(g) * u, p["w_down"])


def embedding_infos(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    return {
        "tok": ParamInfo((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         scale=1.0 / (cfg.d_model ** 0.5)),
        "out": ParamInfo((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
        "final_norm": rmsnorm_info(cfg.d_model),
    }


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, p["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, p["out"])
