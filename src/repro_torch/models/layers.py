"""Core layers shared by every architecture of the zoo.

Pure functions over explicit parameter dicts, as in the JAX package
(``repro.models.layers``), so the parameters stay one tree the caller owns.
Attention is the reference's chunked online-softmax ("flash") formulation
in plain PyTorch: fp32 scores and softmax, KV heads expanded per chunk,
masking with :data:`NEG_INF` — not ``scaled_dot_product_attention``, whose
summation order differs from the reference's.

On a (data, model) mesh each slot runs the ``*_local`` / ``*_slots`` forms
on its part of the ``model`` axis — its heads (GQA self- and
cross-attention, MLA), its ff columns, its vocab rows — and returns a
partial sum that the caller reduces over ``model`` (Megatron-style tensor
parallelism, which the reference gets from GSPMD).
A slot's part of a dim that does not divide is its range of a replicated
copy (:func:`model_part`).  :func:`set_decode_shard` is the reference's
switch for flash-decoding over a sequence-sharded cache
(:func:`_flash_decode_sharded`).  The other perf-harness switches are the
reference's too, under its names and defaults: :func:`set_flash_bf16`
(bf16 flash operands, fp32 accumulation), :func:`set_cache_update_masked`
(the decode cache written by a one-hot select) and
:func:`set_inner_unroll` (no effect in eager torch, kept for the API).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import all_gather, pmax, psum
from repro_torch.models.params import ParamInfo
from repro_torch.utils.config import ModelConfig

NEG_INF = -2.0e38

# Set True (via set_inner_unroll) for the reference's dry-run cost
# compiles, which unroll its inner KV / SSD chunk scans so that XLA counts
# every chunk.  Eager torch runs every chunk in a Python loop whatever the
# flag: it is kept for the API and changes nothing here.
INNER_SCAN_UNROLL = False

# §Perf knobs (set by the perf harness, launch/perf.py):
#  FLASH_BF16          — flash-attention operands (scaled q, k, v, and p)
#                        rounded to bf16, products accumulated in fp32 with
#                        an fp32 result (:func:`_heads_matmul`).
#  CACHE_UPDATE_MASKED — decode-cache write by a one-hot select instead of
#                        a slice write; the same bits (a one-token write at
#                        a position inside the cache).
FLASH_BF16 = False
CACHE_UPDATE_MASKED = False

#  DECODE_SHARD — (mesh, batch_axes) or None.  When set, decode attention of
#  a Model on a mesh runs as explicit flash-decoding over the cache's
#  sequence split (local partial softmax per seq shard + pmax/psum combine)
#  wherever ``s_max % model == 0``, instead of gathering the whole cache.
DECODE_SHARD = None


def set_inner_unroll(flag: bool) -> None:
    global INNER_SCAN_UNROLL
    INNER_SCAN_UNROLL = bool(flag)


def set_flash_bf16(flag: bool) -> None:
    global FLASH_BF16
    FLASH_BF16 = bool(flag)


def set_cache_update_masked(flag: bool) -> None:
    global CACHE_UPDATE_MASKED
    CACHE_UPDATE_MASKED = bool(flag)


def set_decode_shard(mesh, batch_axes=("data",)) -> None:
    global DECODE_SHARD
    DECODE_SHARD = (mesh, tuple(batch_axes)) if mesh is not None else None


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
    ``dynamic_update_slice`` clamps it.  With :data:`CACHE_UPDATE_MASKED`
    a one-token ``new`` is selected in by a one-hot mask over S, as the
    reference's masked write does (nothing is written where ``pos`` lies
    outside the cache)."""
    if CACHE_UPDATE_MASKED:
        s_max = cache.shape[1]
        onehot = (torch.arange(s_max, device=cache.device) == int(pos)).reshape(
            (1, s_max) + (1,) * (cache.ndim - 2))
        return torch.where(onehot, new.to(cache.dtype), cache)
    n = new.shape[1]
    start = min(max(int(pos), 0), cache.shape[1] - n)
    out = cache.clone()
    out[:, start:start + n] = new.to(cache.dtype)
    return out


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 ``[N, M, K]`` × ``[N, K, P]``, fp32 products summed
    in fp32, an fp32 result.  On the card and on ``meta`` one bf16 GEMM
    with an fp32 output (``torch.bmm(..., out_dtype=torch.float32)``:
    cuBLAS's tensor-core order); on the CPU, where that op does not run,
    the same bf16 operands upcast to one fp32 GEMM (exact products, the
    CPU's summation order)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


class _BF16MatmulF32(torch.autograd.Function):
    """:func:`_bmm_f32` with its backward: each grad is a GEMM of the
    incoming fp32 grad rounded to bf16 with the other bf16 operand, fp32
    accumulation, rounded to the operand's bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        ga = _bmm_f32(g, b.transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _bmm_f32(a.transpose(1, 2), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def _heads_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per (batch, head) ``a @ b`` of bf16 ``a`` [B, M, H, K] and ``b``
    [B, K, H, P] → fp32 [B, M, H, P] (:data:`FLASH_BF16`'s two GEMMs)."""
    bsz, m, h, kd = a.shape
    p = b.shape[-1]
    a3 = a.permute(0, 2, 1, 3).reshape(bsz * h, m, kd)
    b3 = b.permute(0, 2, 1, 3).reshape(bsz * h, kd, p)
    out = _BF16MatmulF32.apply(a3, b3)
    return out.reshape(bsz, h, m, p).permute(0, 2, 1, 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, kv_chunk: int = 2048,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the reference's order.

    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] (grouped-query: H = KV * G),
    KV heads expanded to H per chunk.  q_offset: absolute position of q[0]
    (causal masking in decode).  kv_valid: [B, Skv] bool cache-validity
    mask.  Returns [B, Sq, H, hd_v] in q.dtype; scores and softmax in fp32.
    With :data:`FLASH_BF16` the scaled q, k, v and p are rounded to bf16 and
    both products accumulate in fp32 (:func:`_heads_matmul`), as the
    reference's ``preferred_element_type=float32`` GEMMs do.
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
    op = torch.bfloat16 if FLASH_BF16 else torch.float32
    if FLASH_BF16:
        qf = qf.to(op)
    q_pos = q_offset + torch.arange(sq, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=dev)

    hd_v = v.shape[-1]                        # MLA: v head dim != qk head dim
    acc = torch.zeros((b, sq, h, hd_v), dtype=torch.float32, device=dev)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, sq, h), dtype=torch.float32, device=dev)

    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_e, v_e = k[:, sl].to(op), v[:, sl].to(op)
        if g > 1:
            k_e = torch.repeat_interleave(k_e, g, dim=2)     # [B, c, H, hd]
            v_e = torch.repeat_interleave(v_e, g, dim=2)
        if FLASH_BF16:
            s = _heads_matmul(qf, k_e.transpose(1, 3))         # [B, Sq, H, c]
        else:
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
        if FLASH_BF16:
            pv = _heads_matmul(p.to(op), v_e)                 # [B, Sq, H, hd_v]
        else:
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


# ----------------------------------------------------------------------
# tensor-parallel forms: one slot's part of the model axis
# ----------------------------------------------------------------------
def local_range(n: int, j: int, nm: int) -> Tuple[int, int]:
    """Slot ``j`` of ``nm``'s range of ``n`` (equal parts when they divide)."""
    return j * n // nm, (j + 1) * n // nm


def model_part(t: torch.Tensor, dim: int, full: int, j: int, nm: int) -> torch.Tensor:
    """Slot ``j``'s part of dim ``dim`` (``full`` long when whole): the piece
    itself where the dim is split over ``model``, else the slot's range of
    the replicated copy."""
    if nm == 1 or t.shape[dim] != full:
        return t
    lo, hi = local_range(full, j, nm)
    return t.narrow(dim, lo, hi - lo)


def gqa_heads(cfg: ModelConfig, j: int, nm: int) -> Tuple[int, int, int, int]:
    """(h0, h1, k0, k1): slot ``j``'s query heads and the kv groups they
    read, ``h // G`` for a query head h (not the slot's index)."""
    g = cfg.num_heads // cfg.num_kv_heads
    h0, h1 = local_range(cfg.num_heads, j, nm)
    return h0, h1, h0 // g, (h1 - 1) // g + 1


def _slot_kv(t: torch.Tensor, cfg: ModelConfig, j: int, nm: int) -> torch.Tensor:
    """The kv groups of slot ``j``'s heads, from the slot's k or v
    ([B, S, kv_s, hd]: its kv piece, or every kv head), expanded to one
    group per head where the heads do not take whole groups."""
    h0, h1, k0, k1 = gqa_heads(cfg, j, nm)
    base = 0 if t.shape[2] == cfg.num_kv_heads else local_range(cfg.num_kv_heads, j, nm)[0]
    t = t[:, :, k0 - base:k1 - base]
    g = cfg.num_heads // cfg.num_kv_heads
    if h1 - h0 != (k1 - k0) * g:
        idx = torch.tensor([(h // g) - k0 for h in range(h0, h1)], device=t.device)
        t = t.index_select(2, idx)
    return t


def gqa_attention_local(p, x: torch.Tensor, cfg: ModelConfig, j: int, nm: int, *,
                        causal: bool = True, kv_override=None, kv_chunk: int = 2048):
    """Slot ``j``'s heads of :func:`gqa_attention` over ``x`` [B, S, D]:
    ``(partial, k, v)``.  ``partial`` is its share of ``out @ wo`` (sum
    over the model slots for the layer's output); k and v (post-RoPE) are
    the slot's kv heads: its piece of them, or all of them where ``wk`` is
    replicated.  ``kv_override`` gives cross-attention's (k, v) in that
    layout (q then takes RoPE at positions 0..S-1, k none)."""
    h0, h1, _, _ = gqa_heads(cfg, j, nm)
    wq = model_part(p["wq"], 1, cfg.num_heads, j, nm)
    wo = model_part(p["wo"], 0, cfg.num_heads, j, nm)
    q = torch.einsum("bsd,dqh->bsqh", x, wq)
    positions = torch.arange(x.shape[1], device=x.device)
    if kv_override is None:
        k, v = gqa_project_kv(p, x)
        if cfg.use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if h1 == h0:                              # more slots than heads
        return torch.zeros_like(x), k, v
    out = flash_attention(q, _slot_kv(k, cfg, j, nm), _slot_kv(v, cfg, j, nm),
                          causal=causal, kv_chunk=kv_chunk)
    return torch.einsum("bsqh,qhd->bsd", out, wo), k, v


def mla_attention_local(p, x: torch.Tensor, cfg: ModelConfig, j: int, nm: int, *,
                        kv_chunk: int = 2048):
    """Slot ``j``'s heads of :func:`mla_prefill` over ``x`` [B, S, D]:
    ``(partial, ckv_store)``.  ``q_up``, ``kv_up`` and ``wo`` are the
    slot's heads (its piece, or its range of a replicated copy);
    ``q_down`` and ``kv_down`` are whole, so every slot computes the same
    latent ``ckv_store`` [B, S, kl + dr]."""
    h = cfg.num_heads
    h0, h1 = local_range(h, j, nm)
    mp = {"q_down": p["q_down"], "kv_down": p["kv_down"],
          "q_up": model_part(p["q_up"], 1, h, j, nm),
          "kv_up": model_part(p["kv_up"], 1, h, j, nm)}
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v, ckv = _mla_qkv(mp, x, cfg, positions)
    kl = cfg.kv_lora_rank
    k_roped = apply_rope(ckv[..., kl:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    ckv_store = torch.cat([ckv[..., :kl], k_roped], dim=-1)
    if h1 == h0:                              # more slots than heads
        return torch.zeros_like(x), ckv_store
    out = flash_attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    return torch.einsum("bsqh,qhd->bsd", out, model_part(p["wo"], 0, h, j, nm)), ckv_store


def mla_decode_slots(ps: Sequence, xs: Sequence[torch.Tensor], caches: Sequence[torch.Tensor],
                     cache_len: int, cfg: ModelConfig, mesh, seq_split: bool):
    """One-token MLA decode on every slot: ``(partials, caches')``.

    ``caches`` are the slots' pieces of one layer's latent [B, S, kl + dr]:
    its sequence part where ``seq_split`` (``cache_pspecs`` never splits
    the latent by heads), else all of it.  The new token's latent is
    written by the slot that holds its position; each slot then gathers
    the latent's sequence parts (kl + dr values a token, far fewer than
    the K/V its heads expand them to) and attends with its heads over the
    whole cache.  ``partials`` sum over ``model``."""
    nm = mesh.axis_size("model")
    js = [mesh.coords(s).get("model", 0) for s in range(mesh.size)]
    h, kl = cfg.num_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    s_max = caches[0].shape[1] * (nm if seq_split else 1)
    at = min(max(int(cache_len), 0), s_max - 1)
    qs, new = [], []
    for p, x, c, j in zip(ps, xs, caches, js):
        pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
        q = _mla_q({"q_down": p["q_down"], "q_up": model_part(p["q_up"], 1, h, j, nm)}, x)
        q_rope = apply_rope(q[..., dn:], pos, cfg.rope_theta)
        qs.append(torch.cat([q[..., :dn], q_rope], dim=-1))
        ckv_new = torch.einsum("bsd,dl->bsl", x, p["kv_down"])
        kr_new = apply_rope(ckv_new[..., kl:][:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
        store = torch.cat([ckv_new[..., :kl], kr_new], dim=-1)
        if not seq_split:
            c = _cache_write(c, store, cache_len)
        elif at // c.shape[1] == j:
            c = _cache_write(c, store, at - j * c.shape[1])
        new.append(c)
    whole = all_gather(new, mesh, "model", 1) if seq_split else new
    parts = []
    for p, q, c, x, j in zip(ps, qs, whole, xs, js):
        h0, h1 = local_range(h, j, nm)
        if h1 == h0:
            parts.append(torch.zeros_like(x))
            continue
        kv = torch.einsum("bsl,lqh->bsqh", c[..., :kl], model_part(p["kv_up"], 1, h, j, nm))
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k_full = torch.cat([k_nope, c[..., kl:][:, :, None, :].expand(
            k_nope.shape[:-1] + (dr,))], dim=-1)
        valid = _decode_valid(x.shape[0], s_max, cache_len, x.device)
        out = flash_attention(q, k_full, v, causal=False, kv_valid=valid, kv_chunk=s_max)
        parts.append(torch.einsum("bsqh,qhd->bsd", out, model_part(p["wo"], 0, h, j, nm)))
    return parts, new


def cross_attention_slots(ps: Sequence, xs: Sequence[torch.Tensor], xks, xvs,
                          cfg: ModelConfig, mesh, seq_split: bool) -> List[torch.Tensor]:
    """Decode-time cross-attention on every slot (the encdec decoder's and
    the vlm's gated layers): each slot's heads attend over the cached
    ``xks`` / ``xvs`` pieces (its kv piece or every kv head, or its
    sequence part where ``seq_split``, gathered first).  Returns the
    partials, which sum over ``model``."""
    nm = mesh.axis_size("model")
    js = [mesh.coords(s).get("model", 0) for s in range(mesh.size)]
    if seq_split:
        xks, xvs = all_gather(xks, mesh, "model", 1), all_gather(xvs, mesh, "model", 1)
    return [gqa_attention_local(p, x, cfg, j, nm, causal=False, kv_override=(k, v),
                                kv_chunk=k.shape[1])[0]
            for p, x, k, v, j in zip(ps, xs, xks, xvs, js)]


def _flash_decode_sharded(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                         mesh, axis: str = "model") -> List[torch.Tensor]:
    """Flash-decoding over a sequence split (the reference's
    ``_flash_decode_sharded``), one entry per slot.

    q: [B, 1, H, hd], every head (replicated over ``axis``); k/v: the
    slot's sequence shard [B, S/n, KV, hd] of every kv head; valid: [B,
    S/n].  Per shard: fp32 scores and a local max; the global max by
    ``pmax``; ``exp(s − m_g)``; denominator and ``p·v`` by ``psum``; the
    quotient clamped below at 1e-30.  No online-softmax rescale.  Returns
    each slot's [B, 1, H, hd] (all heads) in q's dtype."""

    b, _, h, hd = qs[0].shape
    kv = ks[0].shape[2]
    g = h // kv
    scale = hd ** -0.5
    scores, m_loc = [], []
    for q, k, valid in zip(qs, ks, valids):
        q_g = (q.float() * scale).reshape(b, 1, kv, g, hd)
        sc = torch.einsum("bqkgd,bskd->bqkgs", q_g, k.float())
        sc = torch.where(valid[:, None, None, None, :], sc, NEG_INF)
        scores.append(sc)
        m_loc.append(sc.amax(dim=-1))
    m_g = pmax(m_loc, mesh, axis)
    probs = [torch.exp(sc - m[..., None]) for sc, m in zip(scores, m_g)]
    denom = psum([pr.sum(dim=-1) for pr in probs], mesh, axis)
    acc = psum([torch.einsum("bqkgs,bskd->bqkgd", pr, v.float())
                for pr, v in zip(probs, vs)], mesh, axis)
    return [(a / torch.clamp_min(d[..., None], 1e-30)).reshape(b, 1, h, hd).to(q.dtype)
            for a, d, q in zip(acc, denom, qs)]


def gqa_decode_slots(ps: Sequence, xs: Sequence[torch.Tensor], cks: Sequence[torch.Tensor],
                     cvs: Sequence[torch.Tensor], cache_len: int, cfg: ModelConfig,
                     mesh, mode: str):
    """One-token GQA decode on every slot of ``mesh``: ``(partials, k', v')``.

    ``ps`` are the slots' attention pieces (embed dims whole), ``xs`` their
    rows' [B, 1, D] inputs, ``cks`` / ``cvs`` their pieces of one layer's
    cache in ``mode`` — ``"kv"`` (kv heads split over ``model``), ``"seq"``
    (sequence split) or ``"rep"`` (whole), as ``cache_pspecs`` lays it out.
    The new token is written by the slot that holds its position.
    Attention: flash-decoding over the sequence split while
    :data:`DECODE_SHARD` is set and ``s_max % model == 0`` (q gathered over
    the model slots, every head, as in the reference's in_specs); else
    each slot attends with its heads over the whole cache (a sequence
    split gathered first).  ``partials`` sum over ``model`` to the layer's
    output."""
    nm = mesh.axis_size("model")
    js = [mesh.coords(s).get("model", 0) for s in range(mesh.size)]
    s_max = cks[0].shape[1] * (nm if mode == "seq" else 1)
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=xs[0].device)
    at = min(max(int(cache_len), 0), s_max - 1)
    qs, new_k, new_v = [], [], []
    for p, x, ck, cv, j in zip(ps, xs, cks, cvs, js):
        q = torch.einsum("bsd,dqh->bsqh", x, model_part(p["wq"], 1, cfg.num_heads, j, nm))
        k_new = torch.einsum("bsd,dkh->bskh", x, p["wk"])
        v_new = torch.einsum("bsd,dkh->bskh", x, p["wv"])
        if cfg.use_rope:
            q = apply_rope(q, pos.to(x.device), cfg.rope_theta)
            k_new = apply_rope(k_new, pos.to(x.device), cfg.rope_theta)
        if mode != "seq":
            ck, cv = _cache_write(ck, k_new, cache_len), _cache_write(cv, v_new, cache_len)
        elif at // ck.shape[1] == j:
            ck = _cache_write(ck, k_new, at - j * ck.shape[1])
            cv = _cache_write(cv, v_new, at - j * cv.shape[1])
        qs.append(q)
        new_k.append(ck)
        new_v.append(cv)

    if DECODE_SHARD is not None and s_max % DECODE_SHARD[0].shape["model"] == 0:
        if DECODE_SHARD[0].shape["model"] != nm:
            raise ValueError("set_decode_shard's mesh and the model's differ on 'model'")
        c = s_max // nm
        q_all = all_gather(qs, mesh, "model", 2)
        if mode == "kv":
            k_sh = [t.narrow(1, j * c, c) for t, j in zip(all_gather(new_k, mesh, "model", 2), js)]
            v_sh = [t.narrow(1, j * c, c) for t, j in zip(all_gather(new_v, mesh, "model", 2), js)]
        elif mode == "rep":
            k_sh = [t.narrow(1, j * c, c) for t, j in zip(new_k, js)]
            v_sh = [t.narrow(1, j * c, c) for t, j in zip(new_v, js)]
        else:
            k_sh, v_sh = new_k, new_v
        valid = [(torch.arange(j * c, (j + 1) * c, device=q.device) <= cache_len)[None, :]
                 .expand(q.shape[0], c) for q, j in zip(qs, js)]
        outs = [o[:, :, gqa_heads(cfg, j, nm)[0]:gqa_heads(cfg, j, nm)[1]] for o, j in
                zip(_flash_decode_sharded(q_all, k_sh, v_sh, valid, mesh), js)]
    else:
        k_all = all_gather(new_k, mesh, "model", 1) if mode == "seq" else new_k
        v_all = all_gather(new_v, mesh, "model", 1) if mode == "seq" else new_v
        outs = []
        for q, k, v, j in zip(qs, k_all, v_all, js):
            if q.shape[2] == 0:                   # more slots than heads
                outs.append(q)
                continue
            valid = _decode_valid(q.shape[0], s_max, cache_len, q.device)
            outs.append(flash_attention(q, _slot_kv(k, cfg, j, nm), _slot_kv(v, cfg, j, nm),
                                        causal=False, kv_valid=valid, kv_chunk=s_max))
    parts = [torch.einsum("bsqh,qhd->bsd", o, model_part(p["wo"], 0, cfg.num_heads, j, nm))
             for o, p, j in zip(outs, ps, js)]
    return parts, new_k, new_v


def swiglu_local(p, x: torch.Tensor, d_ff: int, j: int, nm: int) -> torch.Tensor:
    """Slot ``j``'s ff columns of :func:`swiglu` (column-parallel in,
    row-parallel out): its partial of the output."""
    g = torch.einsum("bsd,df->bsf", x, model_part(p["w_gate"], 1, d_ff, j, nm))
    u = torch.einsum("bsd,df->bsf", x, model_part(p["w_up"], 1, d_ff, j, nm))
    return torch.einsum("bsf,fd->bsd", silu(g) * u, model_part(p["w_down"], 0, d_ff, j, nm))


def embed_local(p, tokens: torch.Tensor, vocab: int, j: int, nm: int) -> torch.Tensor:
    """Slot ``j``'s vocab rows of :func:`embed`: the rows of its tokens,
    zeros for tokens outside its range (sum over the model slots)."""
    tok = model_part(p["tok"], 0, vocab, j, nm)
    t = tokens.long() - local_range(vocab, j, nm)[0]
    inside = (t >= 0) & (t < tok.shape[0])
    rows = tok[t.clamp(0, tok.shape[0] - 1)]
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))


def unembed_local(p, x: torch.Tensor, vocab: int, j: int, nm: int) -> torch.Tensor:
    """Slot ``j``'s vocab columns of :func:`unembed`'s logits."""
    x = rmsnorm(x, p["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, model_part(p["out"], 1, vocab, j, nm))
