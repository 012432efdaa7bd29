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

``Model(cfg, mesh=mesh)`` runs on a (data, model)
:class:`~repro_torch.launch.mesh.DeviceMesh` from one process, as the
reference's GSPMD does on its mesh (a mesh without a ``model`` axis is one
with a single model slot): the parameters are a list with one tree of local
pieces per slot (:meth:`Model.param_layout`, the reference's
``param_pspecs``); each slot computes its data shard's rows with its heads,
ff columns and vocab rows (:mod:`repro_torch.models.layers`' ``*_local``
forms; an SSM layer's SSD heads, :func:`repro_torch.models.ssm.slot_params`),
and the partial sums meet in the collectives of
:mod:`repro_torch.distributed.sharding`.  An ``embed``-axis piece (FSDP,
split over ``data``) is gathered where it is used, per layer.  While
:data:`SEQ_SHARD_ACTS` is on (the reference's default) the layer carry is
split over the model slots along the sequence (:meth:`Model.constrain_acts`):
gathered before attention and the MLP, reduce-scattered after; the split
changes memory, never values.  Every family splits: dense (GQA or MLA),
MoE, SSM, hybrid, encdec and vlm.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (Layout, all_gather, flat_specs, gather,
                                              pmax, psum, psum_scatter, shard)
from repro_torch.launch.mesh import as_mesh, with_model_axis
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import local_range
from repro_torch.models.params import (ParamInfo, Spec, abstract_params, init_params,
                                       param_pspecs, tree_leaves, tree_map)
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


# §Perf knob of the reference: sequence-parallel sharding of the layer
# carry over the model slots.  ON keeps the carry (the remat residuals)
# 1/model smaller at the cost of per-layer gathers; OFF trades memory for
# collectives.  Values are the same either way.
SEQ_SHARD_ACTS = True


def set_seq_shard_acts(flag: bool) -> None:
    global SEQ_SHARD_ACTS
    SEQ_SHARD_ACTS = bool(flag)


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
    (``Model.init`` or ``params_from_numpy``), passed to every call.

    With ``mesh`` (a (data, model) DeviceMesh) the parameters are one tree
    of local pieces per slot (``model.param_layout().shard(params)``) and
    the activations' rows split over ``batch_axes``, as in the
    reference's ``Model(cfg, mesh, batch_axes)``."""

    def __init__(self, cfg: ModelConfig, mesh=None, batch_axes=("data",)):
        super().__init__()
        self.cfg = cfg
        self.mesh = with_model_axis(as_mesh(mesh))
        self.batch_axes = tuple(batch_axes)

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
        """The whole parameter tree on ``device`` (lay it out on the mesh
        with :meth:`param_layout`)."""
        return init_params(self.infos(), generator, device, dtype)

    def abstract(self):
        """The parameters as ``meta`` tensors: shapes only."""
        return abstract_params(self.infos())

    def param_specs(self):
        """The reference's ``param_pspecs`` of this model on its mesh."""
        if getattr(self, "_specs", None) is None:
            self._specs = param_pspecs(self.infos(), self.mesh.shape)
        return self._specs

    def param_layout(self):
        """The parameters' per-slot layout on the mesh."""
        return Layout(self.mesh, self.param_specs())

    # ---------------- forward bodies ----------------
    def _moe_apply(self, p, x):
        return MOE.moe_apply(p, x, self.cfg, mesh=self.mesh)

    def constrain_acts(self, x):
        """The reference's sequence-parallel constraint on the layer carry:
        on a mesh, each slot's [B, S, D] becomes its model coordinate's
        sequence part while :data:`SEQ_SHARD_ACTS` is on and S > 1 divides
        over the model slots (a no-op without a mesh)."""
        if self.mesh is None or not isinstance(x, list):
            return x
        return _SlotRun(self, x[0].shape[1]).scatter(x)

    def constrain_kv(self, x):
        """The reference's cache-layout constraint on prefill-produced K/V
        ([B, S, kv, hd] per slot: its kv piece, or every kv head) or MLA
        latents ([B, S, kl + dr], whole on every slot): each slot keeps what
        ``cache_pspecs`` gives it — its kv piece, its sequence part, or all
        (a no-op without a mesh)."""
        if self.mesh is None or not isinstance(x, list):
            return x
        nm = self.mesh.axis_size("model")
        kv_split = self.cfg.num_kv_heads % nm == 0 and not self.cfg.use_mla
        if kv_split or x[0].shape[1] % nm:
            return x
        size = x[0].shape[1] // nm
        return [t.narrow(1, j * size, size) for t, j in zip(x, _SlotRun.model_coords(self))]

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

    # ---------------- the mesh forms ----------------
    def local_trees(self, trees: Sequence[Any], specs, depth: int = 0) -> List[Any]:
        """Each slot's tree with its FSDP pieces (a dim split over a
        non-model axis) gathered over that axis: the slot's part of the
        model axis, whole elsewhere."""
        flats = [list(tree_leaves(t)) for t in trees]
        cols = []
        for i, sp in enumerate(flat_specs(trees[0], specs, depth)):
            xs = [f[i] for f in flats]
            for dim, axis in enumerate(sp):
                if axis is not None and axis != "model":
                    xs = all_gather(xs, self.mesh, axis, dim)
            cols.append(xs)
        out = []
        for s, tree in enumerate(trees):
            it = iter([c[s] for c in cols])
            out.append(tree_map(lambda _: next(it), tree))
        return out

    def mesh_mlp(self, run: "_SlotRun", xs: List[torch.Tensor], lps: List[Any],
                 ln: str = "ln2") -> List[torch.Tensor]:
        """``x + mlp(rmsnorm(x))`` on every slot: its ff columns of the
        SwiGLU (or its experts' columns of the MoE), summed over ``model``."""
        cfg = self.cfg
        h = run.full(xs)
        hn = [L.rmsnorm(hh, lp[ln]) for lp, hh in zip(lps, h)]
        if "moe" in lps[0]:
            mlp = run.scatter(self._moe_apply([lp["moe"] for lp in lps], hn))
        else:
            mlp = run.reduce([L.swiglu_local(lp["mlp"], hh, cfg.d_ff, j, run.nm)
                              for lp, hh, j in zip(lps, hn, run.js)])
        return run.add(xs, mlp)

    def mesh_layer(self, run: "_SlotRun", xs: List[torch.Tensor], lps: List[Any],
                   kv_chunk: int, *, specs=None, depth: int = 1, causal: bool = True):
        """One attention block — a dense (GQA or MLA) or MoE layer, the
        hybrid's shared block, an encoder layer — on every slot: ``xs`` is
        the carry (each slot's [B, S, D], or its sequence part) and ``lps``
        the slots' block pieces, laid out by ``specs`` (the stacked spec
        node, ``depth`` leading dims unstacked; the ``layers`` node by
        default).  Returns the new carry and each slot's cache part: its
        post-RoPE (k, v), or MLA's latent (ckv,)."""
        cfg, nm = self.cfg, run.nm
        specs = self.param_specs()["layers"] if specs is None else specs
        lps = self.local_trees(lps, specs, depth)
        h = run.full(xs)
        hn = [L.rmsnorm(hh, lp["ln1"]) for lp, hh in zip(lps, h)]
        if cfg.use_mla:
            att = [L.mla_attention_local(lp["attn"], hh, cfg, j, nm, kv_chunk=kv_chunk)
                   for lp, hh, j in zip(lps, hn, run.js)]
        else:
            att = [L.gqa_attention_local(lp["attn"], hh, cfg, j, nm, causal=causal,
                                         kv_chunk=kv_chunk)
                   for lp, hh, j in zip(lps, hn, run.js)]
        xs = run.add(xs, run.reduce([a[0] for a in att]))
        return self.mesh_mlp(run, xs, lps), [a[1:] for a in att]

    def mesh_ssm_layer(self, run: "_SlotRun", xs: List[torch.Tensor], lps: List[Any],
                       depth: int = 1):
        """One SSM layer on every slot, each with its SSD heads
        (:func:`repro_torch.models.ssm.slot_params`): the new carry and
        each slot's decode state of its heads."""
        lps = self.local_trees(lps, self.param_specs()["layers"], depth)
        h = run.full(xs)
        hn = [L.rmsnorm(hh, lp["ln"]) for lp, hh in zip(lps, h)]
        sps = SSM.slot_params([lp["ssm"] for lp in lps], self.cfg, self.mesh)
        y, states = SSM.ssd_slots(sps, hn, self.cfg, self.mesh)
        return run.add(xs, run.reduce(y)), states

    def mesh_dec_layer(self, run: "_SlotRun", xs: List[torch.Tensor], lps: List[Any],
                       enc: List[torch.Tensor], kv_chunk: int):
        """One encdec decoder layer on every slot: causal self-attention,
        cross-attention onto the slot's rows of the encoder states, MLP,
        each over the slot's heads.  Returns the new carry and each slot's
        (k, v, xk, xv)."""
        cfg, nm = self.cfg, run.nm
        lps = self.local_trees(lps, self.param_specs()["layers"], 1)
        h = run.full(xs)
        att = [L.gqa_attention_local(lp["self_attn"], L.rmsnorm(hh, lp["ln1"]), cfg, j, nm,
                                     kv_chunk=kv_chunk) for lp, hh, j in zip(lps, h, run.js)]
        xs = run.add(xs, run.reduce([a[0] for a in att]))
        xkv = [cross_kv(lp["cross_attn"], e) for lp, e in zip(lps, enc)]
        h = run.full(xs)
        c = [L.gqa_attention_local(lp["cross_attn"], L.rmsnorm(hh, lp["ln_x"]), cfg, j, nm,
                                   causal=False, kv_override=kv, kv_chunk=kv_chunk)[0]
             for lp, hh, kv, j in zip(lps, h, xkv, run.js)]
        xs = run.add(xs, run.reduce(c))
        return self.mesh_mlp(run, xs, lps), [a[1:] + kv for a, kv in zip(att, xkv)]

    def mesh_cross_layer(self, run: "_SlotRun", xs: List[torch.Tensor], cps: List[Any],
                         img: List[torch.Tensor], kv_chunk: int):
        """The vlm's gated cross-attention layer on every slot, onto the
        slot's rows of the image embeddings: the new carry and each slot's
        (xk, xv)."""
        cfg = self.cfg
        cps = self.local_trees(cps, self.param_specs()["cross_layers"], 1)
        xkv = [cross_kv(cp["attn"], im) for cp, im in zip(cps, img)]
        h = run.full(xs)
        a = run.reduce([L.gqa_attention_local(cp["attn"], L.rmsnorm(hh, cp["ln1"]), cfg, j,
                                              run.nm, causal=False, kv_override=kv,
                                              kv_chunk=kv_chunk)[0]
                        for cp, hh, kv, j in zip(cps, h, xkv, run.js)])
        xs = run.add(xs, run.map(lambda g, t: torch.tanh(g).to(t.dtype) * t,
                                 [cp["gate"] for cp in cps], a))
        return self.mesh_mlp(run, xs, cps), xkv

    def mesh_embed(self, run: "_SlotRun", params, tokens: List[torch.Tensor]):
        """Each slot's [B, S, D] embeddings: its vocab rows' lookups summed
        over the model slots."""
        emb = self.local_trees([p["embed"] for p in params], self.param_specs()["embed"])
        parts = [L.embed_local(e, t, self.cfg.vocab_size, j, run.nm)
                 for e, t, j in zip(emb, tokens, run.js)]
        return psum(parts, self.mesh, "model"), emb

    def mesh_logits(self, run: "_SlotRun", emb, xs: List[torch.Tensor]):
        """Each slot's logits over its vocab columns."""
        return [L.unembed_local(e, x, self.cfg.vocab_size, j, run.nm)
                for e, x, j in zip(emb, xs, run.js)]

    def _mesh_forward(self, params, batch: Dict[str, Any], kv_chunk: int,
                      batch_axes=None, parts: Optional[List[Any]] = None):
        """The family's layers on every slot: ``(run, each slot's logits over
        its vocab columns)``.  With ``parts`` (a list; prefill), each layer's
        — or group's — cache parts per slot are appended to it, and remat is
        off."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"])
        run = _SlotRun(self, tokens.shape[1], batch_axes)
        x, emb = self.mesh_embed(run, params, run.rows(tokens))
        xs = run.scatter(x)
        remat = (lambda f: f) if parts is not None else (lambda f: _remat(f, cfg))
        fam = cfg.family

        if fam in ("dense", "moe"):
            body = remat(lambda c, lps: self.mesh_layer(run, c, lps, kv_chunk))
            layers = [[p["layers"][i] for p in params] for i in range(cfg.num_layers)]
        elif fam == "ssm":
            body = remat(lambda c, lps: self.mesh_ssm_layer(run, c, lps))
            layers = [[p["layers"][i] for p in params] for i in range(cfg.num_layers)]
        elif fam == "hybrid":
            def group(c, gps):
                states = []
                for i in range(cfg.hybrid_attn_every):
                    c, st = self.mesh_ssm_layer(run, c, [g[i] for g, _ in gps], depth=2)
                    states.append(st)
                c, kv = self.mesh_layer(run, c, [sh for _, sh in gps], kv_chunk,
                                        specs=self.param_specs()["shared_attn"], depth=0)
                return c, (states, kv)
            body = remat(group)
            layers = [[(p["layers"][g], p["shared_attn"]) for p in params]
                      for g in range(cfg.num_layers // cfg.hybrid_attn_every)]
        elif fam == "encdec":
            frames = torch.as_tensor(batch["frames"])
            erun = _SlotRun(self, frames.shape[1], batch_axes)
            es = erun.scatter(erun.rows(frames))
            enc_body = remat(lambda c, lps: self.mesh_layer(
                erun, c, lps, kv_chunk, specs=self.param_specs()["encoder"], causal=False)[0])
            for i in range(cfg.num_encoder_layers):
                es = enc_body(es, [p["encoder"][i] for p in params])
            norm = self.local_trees([p["enc_norm"] for p in params],
                                    self.param_specs()["enc_norm"])
            enc = [L.rmsnorm(e, w) for e, w in zip(erun.full(es), norm)]
            body = remat(lambda c, lps: self.mesh_dec_layer(run, c, lps, enc, kv_chunk))
            layers = [[p["layers"][i] for p in params] for i in range(cfg.num_layers)]
        elif fam == "vlm":
            img = run.rows(torch.as_tensor(batch["image_embeds"]))

            def group(c, gps):
                kvs = []
                for i in range(cfg.cross_attn_every - 1):
                    c, kv = self.mesh_layer(run, c, [g[i] for g, _ in gps], kv_chunk, depth=2)
                    kvs.append(kv)
                c, xkv = self.mesh_cross_layer(run, c, [cp for _, cp in gps], img, kv_chunk)
                return c, (kvs, xkv)
            body = remat(group)
            layers = [[(p["layers"][g], p["cross_layers"][g]) for p in params]
                      for g in range(cfg.num_layers // cfg.cross_attn_every)]
        else:
            raise ValueError(fam)

        for lps in layers:
            xs, part = body(xs, lps)
            if parts is not None:
                parts.append(part)
        return run, self.mesh_logits(run, emb, run.full(xs))

    # ---------------- public entry points ----------------
    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> torch.Tensor:
        """Logits [B, S, V] for a full sequence (train / eval / datastore);
        on a mesh the whole logits, gathered to the lead device."""
        cfg = self.cfg
        if self.mesh is not None:
            run, local = self._mesh_forward(params, batch, kv_chunk)
            return run.gather_logits(local)
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
        """Next-token CE (fp32 scalar).  ``batch["tokens"]`` is [B, S+1].

        On a mesh the CE is vocab-parallel: each slot's max, sum of
        exponentials and gold logit over its vocab columns, combined by
        ``pmax`` / ``psum`` over the model slots; the loss is the mean of
        the data shards' means, on the lead device."""
        if self.mesh is not None:
            tokens = torch.as_tensor(batch["tokens"])
            run, local = self._mesh_forward(params, {**batch, "tokens": tokens[:, :-1]},
                                            kv_chunk)
            return run.vocab_parallel_ce(local, run.rows(tokens[:, 1:]))
        tokens = torch.as_tensor(batch["tokens"], device=params["embed"]["tok"].device)
        logits = self.forward(params, {**batch, "tokens": tokens[:, :-1]},
                              kv_chunk=kv_chunk)
        return cross_entropy(logits, tokens[:, 1:])


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on the parameters' device."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _SlotRun:
    """One mesh call's slot bookkeeping: each slot's model coordinate, the
    rows of its data shard, and the sequence split of the layer carry
    (``SEQ_SHARD_ACTS``, for a sequence of ``seq`` tokens)."""

    def __init__(self, model: Model, seq: int, batch_axes=None):
        self.mesh = model.mesh
        self.nm = self.mesh.axis_size("model")
        self.js = _SlotRun.model_coords(model)
        self.batch_axes = model.batch_axes if batch_axes is None else tuple(batch_axes)
        self.split = SEQ_SHARD_ACTS and self.nm > 1 and seq > 1 and seq % self.nm == 0
        self.vocab = model.cfg.vocab_size
        self.last_rows = Spec(None)

    @staticmethod
    def model_coords(model: Model) -> List[int]:
        return [model.mesh.coords(s).get("model", 0) for s in range(model.mesh.size)]

    def row_spec(self, rows: int) -> Spec:
        n = int(np.prod([self.mesh.axis_size(a) for a in self.batch_axes]))
        return Spec(self.batch_axes if rows % n == 0 else None)

    def rows(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Each slot's rows of a batch tensor (all rows where they do not
        split over the batch axes)."""
        self.last_rows = self.row_spec(t.shape[0])
        return shard(torch.as_tensor(t), self.mesh, self.last_rows)

    def full(self, xs):
        return all_gather(xs, self.mesh, "model", 1) if self.split else xs

    def reduce(self, parts):
        if self.split:
            return psum_scatter(parts, self.mesh, "model", 1)
        return psum(parts, self.mesh, "model")

    def scatter(self, xs):
        """Each slot's sequence part of a [B, S, D] that every model slot
        holds alike."""
        if not self.split:
            return xs
        size = xs[0].shape[1] // self.nm
        return [x.narrow(1, j * size, size) for x, j in zip(xs, self.js)]

    @staticmethod
    def map(fn, *lists):
        """``fn`` per slot, once for slots that share every operand."""
        memo: Dict[Any, torch.Tensor] = {}
        out = []
        for args in zip(*lists):
            key = tuple(map(id, args))
            if key not in memo:
                memo[key] = fn(*args)
            out.append(memo[key])
        return out

    def add(self, xs, ys):
        """``x + y`` per slot, once for slots that share both operands."""
        return self.map(torch.add, xs, ys)

    def gather_logits(self, local: List[torch.Tensor]) -> torch.Tensor:
        """The whole [B, S, V], on the lead device, from each slot's vocab
        columns of its rows (laid out by the last :meth:`rows`)."""
        full = all_gather(local, self.mesh, "model", -1)
        return gather(full, self.mesh, self.last_rows)

    def vocab_parallel_ce(self, local: List[torch.Tensor],
                          labels: List[torch.Tensor]) -> torch.Tensor:
        """Mean next-token CE from each slot's vocab columns of its rows'
        logits (``labels``: its rows' labels)."""
        mesh = self.mesh
        lg = [x.float() for x in local]
        m = pmax([x.amax(dim=-1).detach() for x in lg], mesh, "model")
        sumexp = psum([torch.exp(x - mm[..., None]).sum(dim=-1) for x, mm in zip(lg, m)],
                      mesh, "model")
        golds = []
        for x, lab, j in zip(lg, labels, self.js):
            t = lab.long() - local_range(self.vocab, j, self.nm)[0]
            inside = (t >= 0) & (t < x.shape[-1])
            g = torch.gather(x, -1, t.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
            golds.append(torch.where(inside, g, torch.zeros((), device=g.device)))
        gold = psum(golds, mesh, "model")
        losses = [torch.mean(mm + torch.log(se) - g) for mm, se, g in zip(m, sumexp, gold)]
        picks = [s for s, j in enumerate(self.js) if j == 0]
        return sum(losses[s].to(mesh.lead) for s in picks) / len(picks)
