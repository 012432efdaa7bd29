"""KV/SSM caches, prefill and single-token decode for every family (the JAX
package's ``repro.models.decoding`` in PyTorch).

Cache layouts (leading-``layers``-stacked, as in the reference):
  dense-GQA / moe : k, v   [L, B, S_max, KV, hd]
  dense-MLA       : ckv    [L, B, S_max, kv_lora + rope]      (compressed)
  ssm             : h [L, B, H, hd, N] fp32; conv [L, B, 3, C]
  hybrid          : per-group ssm states + shared-attn caches [G, B, S, KV, hd]
  encdec          : decoder self k/v + precomputed cross k/v over enc states
  vlm             : per-group self k/v + precomputed cross k/v over patches

``cache["len"]`` is the position decode writes at and masks validity with,
a host int here (the reference's 0-d int32).  Caches are values:
:func:`decode_step` returns a new cache and leaves its argument as it was.

On a mesh (a ``Model`` with ``mesh``, any family) the cache is a
:class:`MeshCache`, a list with one cache per slot, each entry that slot's
piece as :func:`repro_torch.distributed.sharding.cache_pspecs` lays it out
(kv heads over ``model`` where they divide, else the sequence; MLA's latent
by sequence; SSM states by heads, conv tails by channels), its rows those
of its data shard; ``prefill`` and ``decode_step`` take and return caches
in that layout and the whole logits on the lead device.  A slot's SSD heads
and conv channels are not its pieces of the SSM cache: each decode step
fetches what its heads read and hands back what the pieces hold
(:func:`repro_torch.models.ssm.take`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import (batch_axes, cache_pspecs,
                                              cache_shardings, psum)
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.model import (Model, _SlotRun, batch_to, cross_kv,
                                      gated_cross_block)
from repro_torch.utils.config import ModelConfig
from repro_torch.utils.device import DeviceLike, resolve_device


class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class MeshCache(list):
    """A cache on a mesh: one cache of local pieces per slot, in slot
    order, and the whole cache's ``batch``, ``max_len``, ``enc_len`` and
    ``img_len`` (which fix its layout, ``cache_pspecs``)."""

    def __init__(self, slots, batch: int, max_len: int, enc_len: int = 0,
                 img_len: int = 0):
        super().__init__(slots)
        self.batch, self.max_len = batch, max_len
        self.enc_len, self.img_len = enc_len, img_len

    def specs(self, cfg: ModelConfig, mesh) -> Dict[str, Any]:
        return cache_pspecs(cfg, mesh, self.batch, self.max_len, self.enc_len,
                            self.img_len)

    def gather(self, cfg: ModelConfig, mesh) -> Dict[str, Any]:
        """The whole cache, on the lead device."""
        lay = cache_shardings(cfg, mesh, self.batch, self.max_len, self.enc_len,
                              self.img_len)
        whole = lay.gather([{k: v for k, v in c.items() if k != "len"} for c in self])
        return dict(whole, len=self[0]["len"])


# ----------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------
def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 0, img_len: int = 0) -> Dict[str, CacheSpec]:
    """Shape and dtype of every entry of the decode cache."""
    dt = torch.bfloat16
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    sds = CacheSpec
    length = sds((), torch.int32)

    if cfg.family in ("dense", "moe") and not cfg.use_mla:
        return {"k": sds((cfg.num_layers, batch, max_len, kv, hd), dt),
                "v": sds((cfg.num_layers, batch, max_len, kv, hd), dt),
                "len": length}
    if cfg.use_mla:
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return {"ckv": sds((cfg.num_layers, batch, max_len, width), dt),
                "len": length}
    if cfg.family == "ssm":
        d_in, h, n = SSM.ssm_dims(cfg)
        conv_ch = d_in + 2 * n
        return {"h": sds((cfg.num_layers, batch, h, cfg.ssm_head_dim, n),
                         torch.float32),
                "conv": sds((cfg.num_layers, batch, SSM.CONV_W - 1, conv_ch), dt),
                "len": length}
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.hybrid_attn_every
        per = cfg.hybrid_attn_every
        d_in, h, n = SSM.ssm_dims(cfg)
        conv_ch = d_in + 2 * n
        return {"h": sds((groups, per, batch, h, cfg.ssm_head_dim, n),
                         torch.float32),
                "conv": sds((groups, per, batch, SSM.CONV_W - 1, conv_ch), dt),
                "k": sds((groups, batch, max_len, kv, hd), dt),
                "v": sds((groups, batch, max_len, kv, hd), dt),
                "len": length}
    if cfg.family == "encdec":
        return {"k": sds((cfg.num_layers, batch, max_len, kv, hd), dt),
                "v": sds((cfg.num_layers, batch, max_len, kv, hd), dt),
                "xk": sds((cfg.num_layers, batch, enc_len, kv, hd), dt),
                "xv": sds((cfg.num_layers, batch, enc_len, kv, hd), dt),
                "len": length}
    if cfg.family == "vlm":
        groups = cfg.num_layers // cfg.cross_attn_every
        spg = cfg.cross_attn_every - 1
        return {"k": sds((groups, spg, batch, max_len, kv, hd), dt),
                "v": sds((groups, spg, batch, max_len, kv, hd), dt),
                "xk": sds((groups, batch, img_len, kv, hd), dt),
                "xv": sds((groups, batch, img_len, kv, hd), dt),
                "len": length}
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               img_len: int = 0, *, device: DeviceLike = None, mesh=None):
    """An empty cache on ``device``; with ``mesh``, one cache of local
    pieces per slot (``cache_pspecs``' layout)."""
    if mesh is not None:
        whole = init_cache(cfg, batch, max_len, enc_len, img_len, device=mesh.lead)
        whole.pop("len")
        slots = cache_shardings(cfg, mesh, batch, max_len, enc_len, img_len).shard(whole)
        return MeshCache([dict(c, len=0) for c in slots], batch, max_len, enc_len, img_len)
    dev = resolve_device(device)
    return {name: 0 if name == "len" else torch.zeros(s.shape, dtype=s.dtype,
                                                      device=dev)
            for name, s in cache_shapes(cfg, batch, max_len, enc_len,
                                        img_len).items()}


def _kv_mode(spec) -> str:
    """How a [.., B, S, KV, hd] cache entry's ``spec`` splits it over
    ``model``: "kv" (kv heads), "seq" (sequence) or "rep" (not at all)."""
    spec = tuple(spec)
    return "kv" if spec[-2] == "model" else "seq" if spec[-3] == "model" else "rep"


class _SSMRanges(NamedTuple):
    """Per slot: the SSD heads and conv channels it computes (``heads``,
    ``conv``) and those its pieces of the cache's ``h`` and ``conv`` hold
    (``cache_h``, ``cache_conv``)."""
    heads: list
    conv: list
    cache_h: list
    cache_conv: list


def _ssm_ranges(cfg: ModelConfig, mesh, specs) -> _SSMRanges:
    d_in, h, n = SSM.ssm_dims(cfg)
    nm = mesh.axis_size("model")
    part = lambda full, split, j: [(j * full // nm, (j + 1) * full // nm)] if split \
        else [(0, full)]
    out = _SSMRanges([], [], [], [])
    for s in range(mesh.size):
        j = mesh.coords(s).get("model", 0)
        heads, _, conv = SSM.slot_heads(cfg, j, nm)
        out.heads.append([heads])
        out.conv.append(conv)
        out.cache_h.append(part(h, tuple(specs["h"])[-3] == "model", j))
        out.cache_conv.append(part(d_in + 2 * n, tuple(specs["conv"])[-1] == "model", j))
    return out


def _ssm_states(mesh, r: _SSMRanges, hs, convs):
    """The slots' SSM states of their heads from their pieces of one
    layer's cache (``hs`` [B, H_p, hd, N], ``convs`` [B, 3, C_p])."""
    h = SSM.take(hs, r.cache_h, r.heads, mesh, 1)
    c = SSM.take(convs, r.cache_conv, r.conv, mesh, 2)
    return [SSM.SSMState(a, b) for a, b in zip(h, c)]


def _ssm_pieces(mesh, r: _SSMRanges, states):
    """The slots' pieces of one layer's cache from their states: (h, conv)."""
    return (SSM.take([st.h for st in states], r.heads, r.cache_h, mesh, 1),
            SSM.take([st.conv for st in states], r.conv, r.cache_conv, mesh, 2))


def _stack(per_layer):
    """Per slot, its entries of ``per_layer`` (one per-slot list per layer)
    stacked; slots whose entries are the same tensors share the stack."""
    return _SlotRun.map(lambda *ts: torch.stack(ts), *per_layer)


def _mesh_decode_step(model: Model, params, cache: "MeshCache", token):
    cfg, mesh = model.cfg, model.mesh
    token = torch.as_tensor(token)
    run = _SlotRun(model, 1, batch_axes(mesh))
    x, emb = model.mesh_embed(run, params, run.rows(token))
    clen = int(cache[0]["len"])
    specs = cache.specs(cfg, mesh)
    n = len(params)
    local = lambda lps, depth=1, key="layers": model.local_trees(
        lps, model.param_specs()[key], depth)

    def gqa_block(x, lps, ck, cv, attn="attn", ln="ln1"):
        hn = [L.rmsnorm(h, lp[ln]) for h, lp in zip(x, lps)]
        parts, nk, nv = L.gqa_decode_slots([lp[attn] for lp in lps], hn, ck, cv, clen, cfg,
                                           mesh, _kv_mode(specs["k"]))
        return run.add(x, psum(parts, mesh, "model")), nk, nv

    def cross_block(x, lps, xk, xv, attn, ln):
        hn = [L.rmsnorm(h, lp[ln]) for h, lp in zip(x, lps)]
        return psum(L.cross_attention_slots([lp[attn] for lp in lps], hn, xk, xv, cfg, mesh,
                                            _kv_mode(specs["xk"]) == "seq"), mesh, "model")

    def ssm_layer(x, lps, r, hs, convs):
        hn = [L.rmsnorm(h, lp["ln"]) for h, lp in zip(x, lps)]
        sps = SSM.slot_params([lp["ssm"] for lp in lps], cfg, mesh)
        y, states = SSM.ssd_decode_slots(sps, hn, _ssm_states(mesh, r, hs, convs), cfg, mesh)
        return (run.add(x, psum(y, mesh, "model")),) + _ssm_pieces(mesh, r, states)

    fam = cfg.family
    if fam in ("dense", "moe") and not cfg.use_mla:
        ks, vs = [], []
        for li in range(cfg.num_layers):
            lps = local([p["layers"][li] for p in params])
            x, nk, nv = gqa_block(x, lps, [c["k"][li] for c in cache],
                                  [c["v"][li] for c in cache])
            x = model.mesh_mlp(run, x, lps)
            ks.append(nk)
            vs.append(nv)
        new = {"k": _stack(ks), "v": _stack(vs)}
    elif cfg.use_mla:
        seq_split = tuple(specs["ckv"])[2] == "model"
        ckvs = []
        for li in range(cfg.num_layers):
            lps = local([p["layers"][li] for p in params])
            hn = [L.rmsnorm(h, lp["ln1"]) for h, lp in zip(x, lps)]
            parts, nc = L.mla_decode_slots([lp["attn"] for lp in lps], hn,
                                           [c["ckv"][li] for c in cache], clen, cfg, mesh,
                                           seq_split)
            x = model.mesh_mlp(run, run.add(x, psum(parts, mesh, "model")), lps)
            ckvs.append(nc)
        new = {"ckv": _stack(ckvs)}
    elif fam == "ssm":
        r = _ssm_ranges(cfg, mesh, specs)
        hs, cs = [], []
        for li in range(cfg.num_layers):
            x, h, c = ssm_layer(x, local([p["layers"][li] for p in params]), r,
                                [c["h"][li] for c in cache], [c["conv"][li] for c in cache])
            hs.append(h)
            cs.append(c)
        new = {"h": _stack(hs), "conv": _stack(cs)}
    elif fam == "hybrid":
        r = _ssm_ranges(cfg, mesh, specs)
        shared = local([p["shared_attn"] for p in params], 0, "shared_attn")
        hs, cs, ks, vs = [], [], [], []
        for g in range(cfg.num_layers // cfg.hybrid_attn_every):
            hg, cg = [], []
            for i in range(cfg.hybrid_attn_every):
                x, h, c = ssm_layer(x, local([p["layers"][g][i] for p in params], 2), r,
                                    [c["h"][g][i] for c in cache],
                                    [c["conv"][g][i] for c in cache])
                hg.append(h)
                cg.append(c)
            x, nk, nv = gqa_block(x, shared, [c["k"][g] for c in cache],
                                  [c["v"][g] for c in cache])
            x = model.mesh_mlp(run, x, shared)
            hs.append(_stack(hg))
            cs.append(_stack(cg))
            ks.append(nk)
            vs.append(nv)
        new = {"h": _stack(hs), "conv": _stack(cs), "k": _stack(ks), "v": _stack(vs)}
    elif fam == "encdec":
        ks, vs = [], []
        for li in range(cfg.num_layers):
            lps = local([p["layers"][li] for p in params])
            x, nk, nv = gqa_block(x, lps, [c["k"][li] for c in cache],
                                  [c["v"][li] for c in cache], "self_attn")
            x = run.add(x, cross_block(x, lps, [c["xk"][li] for c in cache],
                                       [c["xv"][li] for c in cache], "cross_attn", "ln_x"))
            x = model.mesh_mlp(run, x, lps)
            ks.append(nk)
            vs.append(nv)
        new = {"k": _stack(ks), "v": _stack(vs)}
    elif fam == "vlm":
        ks, vs = [], []
        for g in range(cfg.num_layers // cfg.cross_attn_every):
            kg, vg = [], []
            for i in range(cfg.cross_attn_every - 1):
                lps = local([p["layers"][g][i] for p in params], 2)
                x, nk, nv = gqa_block(x, lps, [c["k"][g][i] for c in cache],
                                      [c["v"][g][i] for c in cache])
                x = model.mesh_mlp(run, x, lps)
                kg.append(nk)
                vg.append(nv)
            cps = local([p["cross_layers"][g] for p in params], 1, "cross_layers")
            a = cross_block(x, cps, [c["xk"][g] for c in cache], [c["xv"][g] for c in cache],
                            "attn", "ln1")
            x = run.add(x, run.map(lambda gt, t: torch.tanh(gt).to(t.dtype) * t,
                                   [cp["gate"] for cp in cps], a))
            x = model.mesh_mlp(run, x, cps)
            ks.append(_stack(kg))
            vs.append(_stack(vg))
        new = {"k": _stack(ks), "v": _stack(vs)}
    else:
        raise ValueError(fam)
    logits = run.gather_logits(model.mesh_logits(run, emb, x))
    slots = [dict(cache[s], **{k: v[s] for k, v in new.items()}, len=clen + 1)
             for s in range(n)]
    return logits, MeshCache(slots, cache.batch, cache.max_len, cache.enc_len, cache.img_len)


def _mesh_prefill(model: Model, params, batch, max_len: int, kv_chunk: int):
    cfg, mesh = model.cfg, model.mesh
    tokens = torch.as_tensor(batch["tokens"])
    s = tokens.shape[1]
    max_len = max(max_len, s)
    enc_len = batch["frames"].shape[1] if cfg.family == "encdec" else 0
    img_len = batch["image_embeds"].shape[1] if cfg.family == "vlm" else 0
    parts: list = []
    run, local = model._mesh_forward(params, batch, kv_chunk, batch_axes(mesh), parts)
    logits = run.gather_logits(local)
    pad = (lambda t: t) if max_len == s else (
        lambda t: torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, max_len - s)))
    kv = lambda per_slot, i, fill=pad: model.constrain_kv([fill(a[i]) for a in per_slot])
    same = lambda t: t
    fam = cfg.family
    if fam in ("dense", "moe") and not cfg.use_mla:
        new = {"k": _stack([kv(pl, 0) for pl in parts]), "v": _stack([kv(pl, 1) for pl in parts])}
    elif cfg.use_mla:
        new = {"ckv": _stack([kv(pl, 0) for pl in parts])}
    elif fam == "ssm":
        r = _ssm_ranges(cfg, mesh, cache_pspecs(cfg, mesh, tokens.shape[0], max_len))
        pieces = [_ssm_pieces(mesh, r, st) for st in parts]
        new = {"h": _stack([p[0] for p in pieces]), "conv": _stack([p[1] for p in pieces])}
    elif fam == "hybrid":
        r = _ssm_ranges(cfg, mesh, cache_pspecs(cfg, mesh, tokens.shape[0], max_len))
        pieces = [[_ssm_pieces(mesh, r, st) for st in states] for states, _ in parts]
        new = {"h": _stack([_stack([p[0] for p in g]) for g in pieces]),
               "conv": _stack([_stack([p[1] for p in g]) for g in pieces]),
               "k": _stack([kv(a, 0) for _, a in parts]),
               "v": _stack([kv(a, 1) for _, a in parts])}
    elif fam == "encdec":
        new = {"k": _stack([kv(pl, 0) for pl in parts]), "v": _stack([kv(pl, 1) for pl in parts]),
               "xk": _stack([kv(pl, 2, same) for pl in parts]),
               "xv": _stack([kv(pl, 3, same) for pl in parts])}
    elif fam == "vlm":
        new = {"k": _stack([_stack([kv(a, 0) for a in kvs]) for kvs, _ in parts]),
               "v": _stack([_stack([kv(a, 1) for a in kvs]) for kvs, _ in parts]),
               "xk": _stack([kv(x, 0, same) for _, x in parts]),
               "xv": _stack([kv(x, 1, same) for _, x in parts])}
    else:
        raise ValueError(fam)
    slots = [dict({k: v[i] for k, v in new.items()}, len=s) for i in range(len(params))]
    return logits, MeshCache(slots, tokens.shape[0], max_len, enc_len, img_len)


# ----------------------------------------------------------------------
# decode step
# ----------------------------------------------------------------------
def _ssm_decode_layer(lp, h, hs, cs, cfg):
    out, st = SSM.ssd_decode(lp["ssm"], L.rmsnorm(h, lp["ln"]),
                             SSM.SSMState(hs, cs), cfg)
    return h + out, st


def decode_step(model: Model, params, cache: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  token: [B, 1] int → (logits [B, 1, V], cache')."""
    if model.mesh is not None:
        return _mesh_decode_step(model, params, cache, token)
    cfg = model.cfg
    token = torch.as_tensor(token, device=params["embed"]["tok"].device)
    x = L.embed(params["embed"], token)
    clen = int(cache["len"])

    if cfg.family in ("dense", "moe") and not cfg.use_mla:
        ks, vs = [], []
        for lp, ck, cv in zip(params["layers"], cache["k"], cache["v"]):
            a, nk, nv = L.gqa_decode(lp["attn"], L.rmsnorm(x, lp["ln1"]),
                                     ck, cv, clen, cfg)
            x = x + a
            hn = L.rmsnorm(x, lp["ln2"])
            if cfg.family == "moe":
                x = x + model._moe_apply(lp["moe"], hn)
            else:
                x = x + L.swiglu(lp["mlp"], hn)
            ks.append(nk)
            vs.append(nv)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": clen + 1}

    elif cfg.use_mla:
        ckvs = []
        for lp, ckv in zip(params["layers"], cache["ckv"]):
            a, nckv = L.mla_decode(lp["attn"], L.rmsnorm(x, lp["ln1"]),
                                   ckv, clen, cfg)
            x = x + a
            x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
            ckvs.append(nckv)
        new_cache = {"ckv": torch.stack(ckvs), "len": clen + 1}

    elif cfg.family == "ssm":
        hs, cs = [], []
        for lp, h0, c0 in zip(params["layers"], cache["h"], cache["conv"]):
            x, st = _ssm_decode_layer(lp, x, h0, c0, cfg)
            hs.append(st.h)
            cs.append(st.conv)
        new_cache = {"h": torch.stack(hs), "conv": torch.stack(cs),
                     "len": clen + 1}

    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        hs, cs, ks, vs = [], [], [], []
        for gp, gh, gc, ck, cv in zip(params["layers"], cache["h"],
                                      cache["conv"], cache["k"], cache["v"]):
            hg, cg = [], []
            for lp, h0, c0 in zip(gp, gh, gc):
                x, st = _ssm_decode_layer(lp, x, h0, c0, cfg)
                hg.append(st.h)
                cg.append(st.conv)
            a, nk, nv = L.gqa_decode(shared["attn"], L.rmsnorm(x, shared["ln1"]),
                                     ck, cv, clen, cfg)
            x = x + a
            x = x + L.swiglu(shared["mlp"], L.rmsnorm(x, shared["ln2"]))
            hs.append(torch.stack(hg))
            cs.append(torch.stack(cg))
            ks.append(nk)
            vs.append(nv)
        new_cache = {"h": torch.stack(hs), "conv": torch.stack(cs),
                     "k": torch.stack(ks), "v": torch.stack(vs), "len": clen + 1}

    elif cfg.family == "encdec":
        ks, vs = [], []
        for lp, ck, cv, xk, xv in zip(params["layers"], cache["k"], cache["v"],
                                      cache["xk"], cache["xv"]):
            a, nk, nv = L.gqa_decode(lp["self_attn"], L.rmsnorm(x, lp["ln1"]),
                                     ck, cv, clen, cfg)
            x = x + a
            c = L.gqa_attention(lp["cross_attn"], L.rmsnorm(x, lp["ln_x"]),
                                cfg, causal=False, kv_override=(xk, xv),
                                kv_chunk=xk.shape[1])
            x = x + c
            x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
            ks.append(nk)
            vs.append(nv)
        new_cache = {**cache, "k": torch.stack(ks), "v": torch.stack(vs),
                     "len": clen + 1}

    elif cfg.family == "vlm":
        ks, vs = [], []
        for gp, cp, gk, gv, xk, xv in zip(params["layers"], params["cross_layers"],
                                          cache["k"], cache["v"], cache["xk"],
                                          cache["xv"]):
            kg, vg = [], []
            for lp, ck, cv in zip(gp, gk, gv):
                a, nk, nv = L.gqa_decode(lp["attn"], L.rmsnorm(x, lp["ln1"]),
                                         ck, cv, clen, cfg)
                x = x + a
                x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
                kg.append(nk)
                vg.append(nv)
            x = gated_cross_block(cp, x, xk, xv, cfg, xk.shape[1])
            ks.append(torch.stack(kg))
            vs.append(torch.stack(vg))
        new_cache = {**cache, "k": torch.stack(ks), "v": torch.stack(vs),
                     "len": clen + 1}

    else:
        raise ValueError(cfg.family)

    logits = L.unembed(params["embed"], x)
    return logits, new_cache


# ----------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------
def prefill(model: Model, params, batch: Dict[str, torch.Tensor], *,
            max_len: int = 0, kv_chunk: int = 2048
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, returning (logits [B, S, V], cache at len S)."""
    if model.mesh is not None:
        return _mesh_prefill(model, params, batch, max_len, kv_chunk)
    cfg = model.cfg
    batch = batch_to(batch, params["embed"]["tok"].device)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_len = max(max_len, s)
    x = L.embed(params["embed"], tokens)

    def pad_seq(t):
        if max_len == s:
            return t
        return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, max_len - s))

    if cfg.family in ("dense", "moe") and not cfg.use_mla:
        ks, vs = [], []
        for lp in params["layers"]:
            x = model.constrain_acts(x)
            a, k, v = L.gqa_prefill(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                    kv_chunk=kv_chunk)
            x = x + a
            hn = L.rmsnorm(x, lp["ln2"])
            if cfg.family == "moe":
                x = x + model._moe_apply(lp["moe"], hn)
            else:
                x = x + L.swiglu(lp["mlp"], hn)
            ks.append(model.constrain_kv(pad_seq(k)))
            vs.append(model.constrain_kv(pad_seq(v)))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": s}

    elif cfg.use_mla:
        ckvs = []
        for lp in params["layers"]:
            x = model.constrain_acts(x)
            a, ckv = L.mla_prefill(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                   kv_chunk=kv_chunk)
            x = x + a
            x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
            ckvs.append(model.constrain_kv(pad_seq(ckv)))
        cache = {"ckv": torch.stack(ckvs), "len": s}

    elif cfg.family == "ssm":
        hs, cs = [], []
        for lp in params["layers"]:
            x = model.constrain_acts(x)
            y, st = SSM.ssd_forward_with_state(lp["ssm"], L.rmsnorm(x, lp["ln"]), cfg)
            x = x + y
            hs.append(st.h)
            cs.append(st.conv)
        cache = {"h": torch.stack(hs), "conv": torch.stack(cs), "len": s}

    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        hs, cs, ks, vs = [], [], [], []
        for gp in params["layers"]:
            x = model.constrain_acts(x)
            hg, cg = [], []
            for lp in gp:
                y, st = SSM.ssd_forward_with_state(
                    lp["ssm"], L.rmsnorm(x, lp["ln"]), cfg)
                x = x + y
                hg.append(st.h)
                cg.append(st.conv)
            a, k, v = L.gqa_prefill(shared["attn"], L.rmsnorm(x, shared["ln1"]),
                                    cfg, kv_chunk=kv_chunk)
            x = x + a
            x = x + L.swiglu(shared["mlp"], L.rmsnorm(x, shared["ln2"]))
            hs.append(torch.stack(hg))
            cs.append(torch.stack(cg))
            ks.append(model.constrain_kv(pad_seq(k)))
            vs.append(model.constrain_kv(pad_seq(v)))
        cache = {"h": torch.stack(hs), "conv": torch.stack(cs),
                 "k": torch.stack(ks), "v": torch.stack(vs), "len": s}

    elif cfg.family == "encdec":
        enc = model._encode(params, batch["frames"], kv_chunk=kv_chunk)
        ks, vs, xks, xvs = [], [], [], []
        for lp in params["layers"]:
            x = model.constrain_acts(x)
            a, k, v = L.gqa_prefill(lp["self_attn"], L.rmsnorm(x, lp["ln1"]),
                                    cfg, kv_chunk=kv_chunk)
            x = x + a
            xk, xv = cross_kv(lp["cross_attn"], enc)
            c = L.gqa_attention(lp["cross_attn"], L.rmsnorm(x, lp["ln_x"]),
                                cfg, causal=False, kv_override=(xk, xv),
                                kv_chunk=kv_chunk)
            x = x + c
            x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
            ks.append(model.constrain_kv(pad_seq(k)))
            vs.append(model.constrain_kv(pad_seq(v)))
            xks.append(model.constrain_kv(xk))
            xvs.append(model.constrain_kv(xv))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "xk": torch.stack(xks), "xv": torch.stack(xvs), "len": s}

    elif cfg.family == "vlm":
        img = batch["image_embeds"]
        ks, vs, xks, xvs = [], [], [], []
        for gp, cp in zip(params["layers"], params["cross_layers"]):
            x = model.constrain_acts(x)
            kg, vg = [], []
            for lp in gp:
                a, k, v = L.gqa_prefill(lp["attn"], L.rmsnorm(x, lp["ln1"]), cfg,
                                        kv_chunk=kv_chunk)
                x = x + a
                x = x + L.swiglu(lp["mlp"], L.rmsnorm(x, lp["ln2"]))
                kg.append(model.constrain_kv(pad_seq(k)))
                vg.append(model.constrain_kv(pad_seq(v)))
            xk, xv = cross_kv(cp["attn"], img)
            x = gated_cross_block(cp, x, xk, xv, cfg, kv_chunk)
            ks.append(torch.stack(kg))
            vs.append(torch.stack(vg))
            xks.append(model.constrain_kv(xk))
            xvs.append(model.constrain_kv(xv))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "xk": torch.stack(xks), "xv": torch.stack(xvs), "len": s}

    else:
        raise ValueError(cfg.family)

    logits = L.unembed(params["embed"], x)
    return logits, cache
