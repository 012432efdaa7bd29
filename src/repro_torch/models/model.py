"""Model assembly for the architecture zoo (the JAX package's
``repro.models.model`` in PyTorch).

Families: dense (GQA or MLA), moe, ssm (Mamba2), hybrid (Zamba2-style),
encdec (Whisper-style), vlm (Llama-3.2-Vision-style).

Conventions:
  * :meth:`Model.infos` is the reference's parameter-spec tree, per-layer
    leaves stacked on a leading ``layers`` dim; the parameters themselves
    hold one entry per layer (:mod:`repro_torch.models.params`) and the
    bodies loop over them in order;
  * :meth:`Model.forward` is the shared body; :meth:`Model.train_loss`
    adds next-token CE; ``prefill`` additionally returns the KV/SSM cache
    and ``decode_step`` advances one token
    (:mod:`repro_torch.models.decoding`);
  * remat follows ``cfg.remat`` as the reference's layer scan does, on the
    same bodies (a layer of the dense / moe / ssm stacks, the encoder and
    the decoder; a whole group of the hybrid and the vlm): ``"none"``
    keeps every activation, ``"dots"`` and ``"full"`` run each body under
    ``torch.utils.checkpoint`` (its input is kept, its insides recomputed
    in the backward).  Remat changes memory, never values, and applies
    only while autograd records;
  * the modality frontends of [audio]/[vlm] archs are STUBS: the batch
    provides precomputed frame / patch embeddings.

The sharding constraints of the reference's layer scan wait for the
sharding slice: :meth:`Model.constrain_acts` and :meth:`Model.constrain_kv`
return their input.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import ParamInfo, init_params
from repro_torch.utils.config import ModelConfig
from repro_torch.utils.device import DeviceLike


def stack_infos(tree, n: int, axis_name: str = "layers"):
    if isinstance(tree, ParamInfo):
        return ParamInfo((n,) + tree.shape, (axis_name,) + tree.logical,
                         tree.dtype, tree.init, tree.scale)
    return {k: stack_infos(v, n, axis_name) for k, v in tree.items()}


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing per ``cfg.remat``.

    A checkpointed body keeps only its input, one [B, S, D] residual,
    where the reference's ``"dots"`` keeps each block's [B, S, D] output;
    both recompute the rest in the backward.  Outside autograd (serving)
    the body runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32.  logits [B,S,V], labels [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# ----------------------------------------------------------------------
# per-layer block bodies
# ----------------------------------------------------------------------
def _dense_layer_infos(cfg: ModelConfig) -> Dict[str, Any]:
    attn = L.mla_infos(cfg) if cfg.use_mla else L.gqa_infos(cfg)
    return {"ln1": L.rmsnorm_info(cfg.d_model),
            "attn": attn,
            "ln2": L.rmsnorm_info(cfg.d_model),
            "mlp": L.swiglu_infos(cfg)}


def _dense_layer(p, x, cfg: ModelConfig, *, kv_chunk=2048):
    h = L.rmsnorm(x, p["ln1"])
    if cfg.use_mla:
        a = L.mla_attention(p["attn"], h, cfg, kv_chunk=kv_chunk)
    else:
        a = L.gqa_attention(p["attn"], h, cfg, causal=True, kv_chunk=kv_chunk)
    x = x + a
    return x + L.swiglu(p["mlp"], L.rmsnorm(x, p["ln2"]))


def _moe_layer_infos(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": L.rmsnorm_info(cfg.d_model),
            "attn": L.gqa_infos(cfg),
            "ln2": L.rmsnorm_info(cfg.d_model),
            "moe": MOE.moe_infos(cfg)}


def _ssm_layer_infos(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": L.rmsnorm_info(cfg.d_model), "ssm": SSM.ssm_infos(cfg)}


def _attn_block_infos(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": L.rmsnorm_info(cfg.d_model),
            "attn": L.gqa_infos(cfg),
            "ln2": L.rmsnorm_info(cfg.d_model),
            "mlp": L.swiglu_infos(cfg)}


def cross_kv(attn_p, src: torch.Tensor):
    """Cross-attention K/V over encoder states or image embeddings."""
    return (torch.einsum("bsd,dkh->bskh", src, attn_p["wk"]),
            torch.einsum("bsd,dkh->bskh", src, attn_p["wv"]))


def gated_cross_block(cp, h, xk, xv, cfg: ModelConfig, kv_chunk: int):
    """The vlm's gated cross-attention layer onto (stub) image K/V."""
    a = L.gqa_attention(cp["attn"], L.rmsnorm(h, cp["ln1"]), cfg, causal=False,
                        kv_override=(xk, xv), kv_chunk=kv_chunk)
    h = h + torch.tanh(cp["gate"]).to(h.dtype) * a
    return h + L.swiglu(cp["mlp"], L.rmsnorm(h, cp["ln2"]))


# ----------------------------------------------------------------------
# the Model object
# ----------------------------------------------------------------------
class Model(nn.Module):
    """One architecture of the zoo; its parameters are the caller's tree
    (``Model.init`` or ``params_from_numpy``), passed to every call."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # ---------------- parameter trees ----------------
    def infos(self):
        cfg = self.cfg
        base = {"embed": L.embedding_infos(cfg)}
        if cfg.family == "dense":
            base["layers"] = stack_infos(_dense_layer_infos(cfg), cfg.num_layers)
        elif cfg.family == "moe":
            base["layers"] = stack_infos(_moe_layer_infos(cfg), cfg.num_layers)
        elif cfg.family == "ssm":
            base["layers"] = stack_infos(_ssm_layer_infos(cfg), cfg.num_layers)
        elif cfg.family == "hybrid":
            groups = cfg.num_layers // cfg.hybrid_attn_every
            per_group = stack_infos(_ssm_layer_infos(cfg), cfg.hybrid_attn_every)
            base["layers"] = stack_infos(per_group, groups)
            base["shared_attn"] = _attn_block_infos(cfg)
        elif cfg.family == "encdec":
            dec_layer = {"ln1": L.rmsnorm_info(cfg.d_model),
                         "self_attn": L.gqa_infos(cfg),
                         "ln_x": L.rmsnorm_info(cfg.d_model),
                         "cross_attn": L.gqa_infos(cfg),
                         "ln2": L.rmsnorm_info(cfg.d_model),
                         "mlp": L.swiglu_infos(cfg)}
            base["encoder"] = stack_infos(_attn_block_infos(cfg),
                                          cfg.num_encoder_layers)
            base["enc_norm"] = L.rmsnorm_info(cfg.d_model)
            base["layers"] = stack_infos(dec_layer, cfg.num_layers)
        elif cfg.family == "vlm":
            groups = cfg.num_layers // cfg.cross_attn_every
            self_per_group = cfg.cross_attn_every - 1
            cross_layer = {"ln1": L.rmsnorm_info(cfg.d_model),
                           "attn": L.gqa_infos(cfg),
                           "gate": ParamInfo((1,), (None,), init="zeros",
                                             dtype=torch.float32),
                           "ln2": L.rmsnorm_info(cfg.d_model),
                           "mlp": L.swiglu_infos(cfg)}
            base["layers"] = stack_infos(stack_infos(_dense_layer_infos(cfg),
                                                     self_per_group), groups)
            base["cross_layers"] = stack_infos(cross_layer, groups)
        else:
            raise ValueError(f"unknown family {cfg.family!r}")
        return base

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, dtype: Optional[torch.dtype] = None):
        return init_params(self.infos(), generator, device, dtype)

    # ---------------- forward bodies ----------------
    def _moe_apply(self, p, x):
        return MOE.moe_apply(p, x, self.cfg)

    def constrain_acts(self, x):
        """The reference's sequence-parallel constraint (a no-op without a
        mesh)."""
        return x

    def constrain_kv(self, x):
        """The reference's cache-layout constraint (a no-op without a mesh)."""
        return x

    def _backbone(self, params, x, *, kv_chunk=2048, img=None):
        """Token stream through the layers (no embed/unembed)."""
        cfg = self.cfg
        layers = params["layers"]

        if cfg.family == "dense":
            def body(h, lp):
                return _dense_layer(lp, self.constrain_acts(h), cfg, kv_chunk=kv_chunk)

        elif cfg.family == "moe":
            def body(h, lp):
                h = self.constrain_acts(h)
                a = L.gqa_attention(lp["attn"], L.rmsnorm(h, lp["ln1"]),
                                    cfg, causal=True, kv_chunk=kv_chunk)
                h = h + a
                return h + self._moe_apply(lp["moe"], L.rmsnorm(h, lp["ln2"]))

        elif cfg.family == "ssm":
            def body(h, lp):
                h = self.constrain_acts(h)
                return h + SSM.ssd_forward(lp["ssm"], L.rmsnorm(h, lp["ln"]), cfg)

        elif cfg.family == "hybrid":
            shared = params["shared_attn"]

            def body(h, gp):
                h = self.constrain_acts(h)
                for lp in gp:
                    h = h + SSM.ssd_forward(lp["ssm"], L.rmsnorm(h, lp["ln"]), cfg)
                a = L.gqa_attention(shared["attn"], L.rmsnorm(h, shared["ln1"]),
                                    cfg, causal=True, kv_chunk=kv_chunk)
                h = h + a
                return h + L.swiglu(shared["mlp"], L.rmsnorm(h, shared["ln2"]))

        elif cfg.family == "vlm":
            def body(h, gps):
                gp, cp = gps
                h = self.constrain_acts(h)
                for lp in gp:
                    h = _dense_layer(lp, h, cfg, kv_chunk=kv_chunk)
                # gated cross-attention onto the (stub) image embeddings
                xk, xv = cross_kv(cp["attn"], img)
                return gated_cross_block(cp, h, xk, xv, cfg, kv_chunk)
            layers = list(zip(layers, params["cross_layers"]))

        else:
            raise ValueError(cfg.family)

        run = _remat(body, cfg)
        for lp in layers:
            x = run(x, lp)
        return x

    def _encode(self, params, frames, *, kv_chunk=2048):
        """Whisper encoder over stub frame embeddings [B, S_enc, D]."""
        cfg = self.cfg

        def body(h, lp):
            h = self.constrain_acts(h)
            a = L.gqa_attention(lp["attn"], L.rmsnorm(h, lp["ln1"]), cfg,
                                causal=False, kv_chunk=kv_chunk)
            h = h + a
            return h + L.swiglu(lp["mlp"], L.rmsnorm(h, lp["ln2"]))

        run = _remat(body, cfg)
        h = frames
        for lp in params["encoder"]:
            h = run(h, lp)
        return L.rmsnorm(h, params["enc_norm"])

    def _decoder(self, params, x, enc, *, kv_chunk=2048):
        cfg = self.cfg

        def body(h, lp):
            h = self.constrain_acts(h)
            a = L.gqa_attention(lp["self_attn"], L.rmsnorm(h, lp["ln1"]), cfg,
                                causal=True, kv_chunk=kv_chunk)
            h = h + a
            xk, xv = cross_kv(lp["cross_attn"], enc)
            c = L.gqa_attention(lp["cross_attn"], L.rmsnorm(h, lp["ln_x"]),
                                cfg, causal=False, kv_override=(xk, xv),
                                kv_chunk=kv_chunk)
            h = h + c
            return h + L.swiglu(lp["mlp"], L.rmsnorm(h, lp["ln2"]))

        run = _remat(body, cfg)
        for lp in params["layers"]:
            x = run(x, lp)
        return x

    # ---------------- public entry points ----------------
    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> torch.Tensor:
        """Logits [B, S, V] for a full sequence (train / eval / datastore)."""
        cfg = self.cfg
        batch = batch_to(batch, params["embed"]["tok"].device)
        x = L.embed(params["embed"], batch["tokens"])
        if cfg.family == "encdec":
            enc = self._encode(params, batch["frames"], kv_chunk=kv_chunk)
            x = self._decoder(params, x, enc, kv_chunk=kv_chunk)
        elif cfg.family == "vlm":
            x = self._backbone(params, x, kv_chunk=kv_chunk,
                               img=batch["image_embeds"])
        else:
            x = self._backbone(params, x, kv_chunk=kv_chunk)
        return L.unembed(params["embed"], x)

    def train_loss(self, params, batch: Dict[str, torch.Tensor], *,
                   kv_chunk: int = 2048) -> torch.Tensor:
        """Next-token CE (fp32 scalar).  ``batch["tokens"]`` is [B, S+1]."""
        tokens = torch.as_tensor(batch["tokens"], device=params["embed"]["tok"].device)
        logits = self.forward(params, {**batch, "tokens": tokens[:, :-1]},
                              kv_chunk=kv_chunk)
        return cross_entropy(logits, tokens[:, 1:])


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on the parameters' device."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
