"""The model axis of the port against the JAX package: the sharding rules,
the (data, model) mesh forms of the dense (GQA) and MoE families, the
sharded train step and the elastic checkpoint re-place.

* Rules: ``param_pspecs`` for all ten architectures' full configs, and
  ``cache_pspecs`` at the reference's ``SHAPES``, on the production meshes
  {data: 16, model: 16} and {pod: 2, data: 16, model: 16} (a stand-in mesh
  object: ``axis_names`` and ``devices = np.empty(shape)``, so no XLA
  device count is needed); ``batch_pspec``.
* Serving at smoke width, fp32 trees, on ``["cpu"] * D``: forward,
  prefill and two decodes of internlm2 and qwen2-moe on (1, 2) and (1, 4),
  with ``set_decode_shard`` on and off, against the port's one-device run
  within ``1e-4·(1+|x|)``; the sequence-split carry bit-equal to the
  unsplit one; olmoe on (2, 2) against the one-device run of each data
  half (the MoE capacity counts one data shard's tokens).
* Training: the port's (4, 2) step against its one-device step (loss
  and grad norm 1e-5 relative; AdamW's first moment, which after one step
  is the reduced grad times (1 - b1)·clip, within ``GRAD_RTOL`` of each
  leaf's largest entry, so that a piece's grad summed into the wrong slot,
  swapped or zeroed fails; weights 5e-2, the reference's bound); a
  non-finite loss leaves the (2, 2) slots' parameters and moments
  byte-equal; a (4, 2) save byte-equal in its files to a one-device save
  and restored onto (2, 2) byte-equal; ``train(mesh=(2, 2))`` against one
  device.
* One subprocess on 8 host XLA devices holds the port to the reference's
  own sharded runs: the (4, 2) train step in fp32 (the first moment
  within ``GRAD_RTOL`` leaf by leaf; loss and ``embed/out`` within 5e-2,
  the reference's bound), olmoe's shard_map MoE forward on (2, 2) and
  internlm2's decode under ``set_decode_shard`` on (1, 4)
  (``1e-4·(1+|x|)``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_models import both_batches, both_params, rel_err  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import cache_pspecs as j_cache_pspecs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.params import param_pspecs as j_param_pspecs  # noqa: E402
from repro.train.train_step import batch_pspec as j_batch_pspec  # noqa: E402
from repro.utils.config import SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import Model as TModel, decode_step, prefill  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import (named_params, param_pspecs, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.train import (AdamW, batch_pspec, constant_lr,  # noqa: E402
                               make_batch_shardings, make_state_shardings,
                               make_train_step, restore_checkpoint, save_checkpoint,
                               shard_train_step)

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SERVE_TOL = 1e-4
GRAD_RTOL = 1e-4              # fp32 grads: |Δ| within this share of a leaf's largest
# the families split over the model axis after dense GQA and MoE
SPLIT = ("minicpm3-4b", "mamba2-780m", "zamba2-2.7b", "whisper-large-v3",
         "llama-3.2-vision-90b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandIn:
    """What the rules read of a mesh: its axis names and grid shape."""

    def __init__(self, shape, axes):
        self.axis_names, self.devices = axes, np.empty(shape)


def spec_items(tree, path=""):
    """``[(path, tuple(spec))]`` of a nested dict of specs."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_items(tree[k], f"{path}/{k}")]
    return [(path, tuple(tree))]


def cpu_mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def worst_leaf(ref, got):
    """(largest per-leaf ``rel_err``, its name) of two trees in the port's
    layout."""
    ref, got = named_params(ref), named_params(got)
    assert ref.keys() == got.keys()
    return max((rel_err(ref[n].float().numpy(), got[n]), n) for n in ref)


def close(got, ref, tol=SERVE_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref) / (1 + np.abs(ref))))


# ----------------------------------------------------------------------
# the rules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch):
    infos_j = JModel(j_get_config(arch)).infos()
    infos_t = TModel(t_get_config(arch)).infos()
    for shape, axes in MESHES.values():
        sizes = dict(zip(axes, shape))
        assert spec_items(param_pspecs(infos_t, sizes)) == \
            spec_items(j_param_pspecs(infos_j, sizes))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch):
    jc, tc = j_get_config(arch), t_get_config(arch)
    for shape, axes in MESHES.values():
        mesh = StandIn(shape, axes)
        for sh in SHAPES:
            enc = sh.seq_len if jc.family == "encdec" else 0
            img = jc.num_image_tokens if jc.family == "vlm" else 0
            want = j_cache_pspecs(jc, mesh, sh.global_batch, sh.seq_len, enc, img)
            got = S.cache_pspecs(tc, mesh, sh.global_batch, sh.seq_len, enc, img)
            assert spec_items(got) == spec_items(want), (sh.name, axes)


def test_batch_pspec_matches_reference():
    for shape, axes in MESHES.values():
        mesh = StandIn(shape, axes)
        for extra in (0, 1, 2):
            assert tuple(batch_pspec(mesh, extra)) == tuple(j_batch_pspec(mesh, extra))
    lay = make_batch_shardings(cpu_mesh((4, 2)), {"tokens": torch.zeros(8, 5),
                                                  "one": torch.zeros(1, 5)})
    assert tuple(lay.specs["tokens"]) == ("data", None) and tuple(lay.specs["one"]) == ()


def test_abstract_params_allocate_nothing():
    tm = TModel(t_get_config("internlm2-1.8b"))
    leaves = list(named_params(tm.abstract()).values())
    assert all(x.device.type == "meta" for x in leaves)
    assert tuple(leaves[0].shape) == (92544, 2048)


# ----------------------------------------------------------------------
# meshes and collectives
# ----------------------------------------------------------------------
def test_device_mesh_grid_and_collectives():
    mesh = cpu_mesh((2, 3))
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 2, "model": 3}
    assert mesh.devices.shape == (2, 3) and mesh.size == 6
    assert mesh.coords(4) == {"data": 1, "model": 1}
    assert mesh.groups("model")[4] == [3, 4, 5] and mesh.groups("data")[4] == [1, 4]
    one = make_mesh(3, ["cpu"] * 3)                       # the 1-D call of PR 17
    assert one.shape == {"data": 3} and one.axis == "data"
    xs = [torch.full((2, 3), float(s)) for s in range(6)]
    assert [float(x[0, 0]) for x in S.psum(xs, mesh, "model")] == [3, 3, 3, 12, 12, 12]
    assert [float(x[0, 0]) for x in S.pmax(xs, mesh, "data")] == [3, 4, 5, 3, 4, 5]
    g = S.all_gather(xs, mesh, "model", 1)
    assert g[5].shape == (2, 9) and float(g[5][0, 8]) == 5
    rs = S.psum_scatter([torch.arange(6.0).reshape(1, 6)] * 6, mesh, "model", 1)
    assert rs[1].tolist() == [[6.0, 9.0]]
    t = torch.arange(24.0).reshape(4, 6)
    spec = S.Spec("data", "model")
    pieces = S.shard(t, mesh, spec)
    assert pieces[4].tolist() == [[14.0, 15.0], [20.0, 21.0]]
    assert torch.equal(S.gather(pieces, mesh, spec), t)
    rep = S.shard(t, mesh, S.Spec(None, "model"))
    assert rep[0] is rep[3] and rep[0] is not rep[1]       # one device: shared


def test_production_mesh():
    with pytest.raises(RuntimeError, match="256 CUDA devices"):
        make_production_mesh()
    mesh = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    mesh = make_production_mesh(devices=["cpu"] * 256)
    tm = TModel(t_get_config("internlm2-1.8b", smoke=True), mesh=mesh)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    back = tm.param_layout().gather(tm.param_layout().shard(params))
    for (name, a), b in zip(named_params(params).items(), named_params(back).values()):
        assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8)), name


# ----------------------------------------------------------------------
# serving on (data, model) slots
# ----------------------------------------------------------------------
def serve_run(model, params, batch, nxt, max_len=16, kv_chunk=8):
    """forward, prefill and two decodes of ``batch`` (a dict, or tokens):
    the logits of each."""
    batch = batch if isinstance(batch, dict) else {"tokens": batch}
    out = [model.forward(params, batch, kv_chunk=kv_chunk)]
    lg, cache = prefill(model, params, batch, max_len=max_len, kv_chunk=kv_chunk)
    out.append(lg)
    for i in range(nxt.shape[1]):
        lg, cache = decode_step(model, params, cache, nxt[:, i:i + 1])
        out.append(lg)
    return out, cache


@pytest.mark.parametrize("decode_shard", [False, True], ids=["gathered", "flash"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_mesh_serving_matches_one_device(arch, shape, decode_shard):
    _, _, tm, tp, _ = both_params(arch, 0, fp32=True)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 8)))
    nxt = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 2)))
    ref, ref_cache = serve_run(tm, tp, tokens, nxt)
    mesh = cpu_mesh(shape)
    mm = TModel(tm.cfg, mesh=mesh)
    TL.set_decode_shard(mesh if decode_shard else None)
    try:
        got, cache = serve_run(mm, mm.param_layout().shard(tp), tokens, nxt)
    finally:
        TL.set_decode_shard(None)
    errs = [close(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= SERVE_TOL, errs
    whole = cache.gather(mm.cfg, mesh)
    assert close(whole["k"], ref_cache["k"]) <= SERVE_TOL and whole["len"] == 10


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 1, 2)], ids=["1x2", "1x4", "pod2x1x2"])
@pytest.mark.parametrize("arch", SPLIT)
def test_split_family_serving_matches_one_device(arch, shape):
    """MLA, SSM, hybrid, encdec and vlm on the model axis: forward, prefill
    and two decodes against the one-device port, and the cache gathered
    from its ``cache_pspecs`` pieces against the one-device cache; the
    three-axis case splits rows over ``("pod", "data")`` as the multi-pod
    production mesh does."""
    _, _, tm, tp, _ = both_params(arch, 0, fp32=True)
    rng = np.random.default_rng(1)
    _, batch = both_batches(tm.cfg, rng, 2, 8, fp32=True)
    nxt = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 2)))
    ref, ref_cache = serve_run(tm, tp, batch, nxt)
    mesh = cpu_mesh(shape)
    mm = TModel(tm.cfg, mesh=mesh, batch_axes=mesh.axis_names[:-1])
    got, cache = serve_run(mm, mm.param_layout().shard(tp), batch, nxt)
    errs = [close(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= SERVE_TOL, errs
    whole = cache.gather(mm.cfg, mesh)
    assert whole.keys() == ref_cache.keys() and whole["len"] == 10
    errs = {k: close(whole[k].float(), ref_cache[k].float()) for k in whole if k != "len"}
    assert max(errs.values()) <= SERVE_TOL, errs


def test_mla_heads_that_do_not_divide():
    """minicpm3-smoke's 4 heads on 8 model slots: ``param_pspecs`` drops
    ``heads`` (q_up, kv_up and wo stay whole on every slot), the latent
    cache splits by sequence, and half the slots hold no head."""
    _, _, tm, tp, _ = both_params("minicpm3-4b", 1, fp32=True)
    mesh = cpu_mesh((1, 8))
    mm = TModel(tm.cfg, mesh=mesh)
    attn = mm.param_specs()["layers"]["attn"]
    assert tuple(attn["q_up"]) == (None, None, None, None)
    assert tuple(attn["kv_up"]) == (None, None, None, None)
    assert tuple(attn["wo"]) == (None, None, None, "data")     # embed: FSDP
    assert tuple(mm.param_specs()["layers"]["mlp"]["w_up"]) == (None, "data", "model")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 8)))
    nxt = torch.from_numpy(rng.integers(0, 256, (2, 2)))
    ref, ref_cache = serve_run(tm, tp, tokens, nxt)
    got, cache = serve_run(mm, mm.param_layout().shard(tp), tokens, nxt)
    assert max(close(g, r) for g, r in zip(got, ref)) <= SERVE_TOL
    assert tuple(cache[3]["ckv"].shape) == (2, 2, 2, 24)          # [L, B, 16 / 8, kl + dr]
    assert close(cache.gather(mm.cfg, mesh)["ckv"], ref_cache["ckv"]) <= SERVE_TOL


def test_seq_split_carry_changes_no_value(monkeypatch):
    _, _, tm, tp, _ = both_params("internlm2-1.8b", 2, fp32=True)
    mm = TModel(tm.cfg, mesh=cpu_mesh((1, 4)))
    ps = mm.param_layout().shard(tp)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16)))
    carry = mm.constrain_acts([torch.zeros(2, 16, 64)] * 4)
    assert [tuple(c.shape) for c in carry] == [(2, 4, 64)] * 4
    split = mm.forward(ps, {"tokens": tokens}, kv_chunk=8)
    monkeypatch.setattr(TM, "SEQ_SHARD_ACTS", False)
    assert torch.equal(split, mm.forward(ps, {"tokens": tokens}, kv_chunk=8))


def test_moe_capacity_counts_one_data_shard():
    """olmoe on (2, 2): each data shard routes under its own capacity, so
    the mesh forward equals each data half run alone on one device."""
    _, _, tm, tp, _ = both_params("olmoe-1b-7b", 4, fp32=True)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 16)))
    mm = TModel(tm.cfg, mesh=cpu_mesh((2, 2)))
    got = mm.forward(mm.param_layout().shard(tp), {"tokens": tokens}, kv_chunk=16)
    halves = torch.cat([tm.forward(tp, {"tokens": tokens[:2]}, kv_chunk=16),
                        tm.forward(tp, {"tokens": tokens[2:]}, kv_chunk=16)])
    assert close(got, halves) <= SERVE_TOL
    whole = tm.forward(tp, {"tokens": tokens}, kv_chunk=16)
    assert close(got, whole) > SERVE_TOL          # the whole batch drops other tokens


# ----------------------------------------------------------------------
# training on (data, model) slots
# ----------------------------------------------------------------------
def test_sharded_step_matches_one_device():
    """fp32 parameters; the grad norm counts each piece once, however
    many slots hold it."""
    tm = TModel(t_get_config("internlm2-1.8b", smoke=True))
    params = tm.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(0, 256, (8, 33)))}
    opt = AdamW(lr=constant_lr(1e-3))
    one = tree_map(torch.clone, params)
    one, s1, m1 = make_train_step(tm, opt, kv_chunk=32)(one, opt.init(one), batch)
    mesh = cpu_mesh((4, 2))
    mm = TModel(tm.cfg, mesh=mesh)
    p_lay, o_lay = make_state_shardings(mesh, mm)
    ps = p_lay.shard(params)
    ps, os_, m2 = shard_train_step(mm, opt, mesh, kv_chunk=32)(ps, opt.init_slots(ps), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
    assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 * float(m1["grad_norm"])
    got = p_lay.gather(ps)
    w = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(named_params(one).values(), named_params(got).values()))
    assert w < 5e-2, w
    state = o_lay.gather(os_)
    assert int(state.step) == 1
    # after one step m = (1 - b1)·clip·g: each leaf's reduced grad
    worst = worst_leaf(s1.m, state.m)
    assert worst[0] <= GRAD_RTOL, worst


@pytest.mark.parametrize("arch", SPLIT)
def test_split_family_step_matches_one_device(arch):
    """The (2, 2) step of each newly split family against the one-device
    step: AdamW's first moment leaf by leaf within ``GRAD_RTOL`` — MLA's
    ``lora`` weights whole on every model slot, the SSM's replicated
    ``a_log`` / ``dt_bias`` / ``d_skip`` and its x / z columns fetched
    from other slots, the hybrid's shared block summed over its groups,
    the vlm's fp32 gate."""
    _, _, tm, tp, _ = both_params(arch, 2, fp32=True)
    rng = np.random.default_rng(7)
    _, batch = both_batches(tm.cfg, rng, 4, 16, fp32=True)
    batch["tokens"] = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (4, 17)))
    opt = AdamW(lr=constant_lr(1e-3))
    one = tree_map(torch.clone, tp)
    _, s1, m1 = make_train_step(tm, opt, kv_chunk=8)(one, opt.init(one), batch)
    mesh = cpu_mesh((2, 2))
    mm = TModel(tm.cfg, mesh=mesh)
    p_lay, o_lay = make_state_shardings(mesh, mm)
    ps = p_lay.shard(tp)
    _, os_, m2 = shard_train_step(mm, opt, mesh, kv_chunk=8)(ps, opt.init_slots(ps), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
    worst = worst_leaf(s1.m, o_lay.gather(os_).m)
    assert worst[0] <= GRAD_RTOL, worst


def test_non_finite_loss_leaves_the_mesh_state(monkeypatch):
    """A NaN loss on (2, 2) slots applies no update: every slot's
    parameters, moments and step stay byte-equal."""
    tm = TModel(t_get_config("internlm2-1.8b", smoke=True), mesh=cpu_mesh((2, 2)))
    opt = AdamW(lr=constant_lr(1e-3))
    batch = {"tokens": torch.randint(0, 256, (4, 17), generator=torch.Generator().manual_seed(0))}
    p_lay, o_lay = make_state_shardings(tm.mesh, tm)
    ps = p_lay.shard(tm.init(torch.Generator().manual_seed(0), "cpu", torch.float32))
    step = shard_train_step(tm, opt, tm.mesh, kv_chunk=16)
    ps, os_, _ = step(ps, opt.init_slots(ps), batch)      # moments no longer zero
    snap = lambda *t: [x.clone().view(-1).view(torch.uint8) for x in tree_leaves(list(t))]
    before = snap(ps, os_)
    real = TModel.train_loss
    monkeypatch.setattr(TModel, "train_loss",
                        lambda self, *a, **kw: real(self, *a, **kw) * float("nan"))
    p2, s2, met = step(ps, os_, batch)
    assert not np.isfinite(float(met["loss"])) and int(o_lay.gather(s2).step) == 1
    after = snap(p2, s2)
    assert len(after) == len(before) and all(map(torch.equal, before, after))


def test_checkpoint_reshards_to_smaller_mesh(tmp_path):
    tm = TModel(t_get_config("internlm2-1.8b", smoke=True), mesh=cpu_mesh((4, 2)))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(tmp_path / "one", 3, params)
    save_checkpoint(tmp_path / "mesh", 3, tm.param_layout().shard(params),
                    layout=tm.param_layout())
    for name in ("MANIFEST.json", "shard_p0.npz"):
        assert (tmp_path / "one" / "step_00000003" / name).read_bytes() == \
            (tmp_path / "mesh" / "step_00000003" / name).read_bytes()
    small = TModel(tm.cfg, mesh=cpu_mesh((2, 2)))
    slots, step, _ = restore_checkpoint(tmp_path / "mesh", small.abstract(),
                                        device=small.param_layout())
    assert step == 3 and len(slots) == 4
    assert tuple(slots[0]["embed"]["tok"].shape) == (128, 32)
    back = small.param_layout().gather(slots)
    assert all(torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
               for a, b in zip(named_params(params).values(), named_params(back).values()))


def test_train_on_a_data_model_mesh():
    from repro_torch.launch.train import train
    kw = dict(smoke=True, batch=4, seq=32, lr=3e-3, kv_chunk=32, seed=0,
              data_mode="periodic", steps=3)
    _, one = train("internlm2-1.8b", device="cpu", **kw)
    _, two = train("internlm2-1.8b", mesh=cpu_mesh((2, 2)), **kw)
    assert np.abs(np.array(one) - np.array(two)).max() <= 1e-4 * max(one)


# ----------------------------------------------------------------------
# the reference's own sharded runs, on 8 host XLA devices
# ----------------------------------------------------------------------
REFERENCE_RUNS = """
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch
from repro.configs import get_config as jcfg
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import Model as JModel
from repro.models import decoding as JD, layers as JL
from repro.models.params import ParamInfo as JParamInfo
from repro.train.optimizer import AdamW as JAdamW, constant_lr as j_const
from repro.train.train_step import shard_train_step as j_shard_step
from repro_torch.configs import get_config as tcfg
from repro_torch.launch import make_mesh
from repro_torch.models import Model as TModel, decode_step, params_from_numpy, prefill
from repro_torch.models import layers as TL
from repro_torch.models import named_params
from repro_torch.train import AdamW, constant_lr, make_state_shardings, shard_train_step

assert jax.device_count() == 8
torch.set_num_threads(1)
SPLIT = __SPLIT__
out = {}
as_np = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
cpu = lambda shape: make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))
fp32 = lambda t: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), t)

# the reference's sharded train step in fp32 against the port's on the same
# mesh shape: loss, AdamW's first moment leaf by leaf, embed/out
def ref_step(arch, shape, params):
    cfg = jcfg(arch, smoke=True)
    batch = TokenPipeline(cfg, 8, 32, seed=1).batch_at(0)
    jmesh = j_make_mesh(shape, ("data", "model"))
    jopt = JAdamW(lr=j_const(1e-3))
    shapes = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch)
    fn, (psh, osh, bsh) = j_shard_step(JModel(cfg, mesh=jmesh, batch_axes=("data",)), jopt,
                                       jmesh, shapes, kv_chunk=32, donate=False)
    jp, jst, jmet = fn(jax.device_put(params, psh), jax.device_put(jopt.init(params), osh),
                       jax.device_put(batch, bsh))
    tm = TModel(tcfg(arch, smoke=True), mesh=cpu(shape))
    p_lay, o_lay = make_state_shardings(tm.mesh, tm)
    opt = AdamW(lr=constant_lr(1e-3))
    port = lambda t: params_from_numpy(as_np(t), tm.infos(), device="cpu", dtype=torch.float32)
    ps = p_lay.shard(port(params))
    ps, os_, met = shard_train_step(tm, opt, tm.mesh, kv_chunk=32)(
        ps, opt.init_slots(ps), {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    ref_m, got_m = named_params(port(jst.m)), named_params(o_lay.gather(os_).m)
    m_rel = {n: float(np.abs(ref_m[n].numpy() - got_m[n].numpy()).max()
                      / max(float(np.abs(ref_m[n].numpy()).max()), 1e-30)) for n in ref_m}
    return {"loss_ref": float(jmet["loss"]), "loss": float(met["loss"]),
            "m_rel": max(m_rel.values()), "m_worst": max(m_rel, key=m_rel.get),
            "w_delta": float(np.abs(np.asarray(jp["embed"]["out"], np.float32)
                                    - p_lay.gather(ps)["embed"]["out"].float().numpy()).max())}


# the reference's (4, 2) sharded train step, fp32 parameters
cfg = jcfg("internlm2-1.8b", smoke=True)
out["step"] = ref_step("internlm2-1.8b", (4, 2), fp32(JModel(cfg).init(jax.random.PRNGKey(0))))


# fp32 parameters drawn with numpy (faster than the reference's init): every
# leaf random, the zeros / ones ones (a_log, dt_bias, d_skip, norms, the vlm
# gate) about their init value
def draw(infos, rng):
    if isinstance(infos, JParamInfo):
        x = rng.standard_normal(infos.shape).astype(np.float32)
        return jnp.asarray({"ones": 1.0 + 0.1 * x, "zeros": 0.5 * x}.get(infos.init,
                                                                           x * infos.scale))
    return {k: draw(v, rng) for k, v in infos.items()}


# olmoe's shard_map MoE forward on (2, 2), fp32
cfg = jcfg("olmoe-1b-7b", smoke=True)
jmesh = j_make_mesh((2, 2), ("data", "model"))
jm = JModel(cfg, mesh=jmesh)
params = fp32(JModel(cfg).init(jax.random.PRNGKey(1)))
tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
ref = np.asarray(jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, kv_chunk=16))(params, tok))
tm = TModel(tcfg("olmoe-1b-7b", smoke=True), mesh=cpu((2, 2)))
got = tm.forward(tm.param_layout().shard(params_from_numpy(
    as_np(params), tm.infos(), device="cpu", dtype=torch.float32)),
    {"tokens": torch.from_numpy(tok)}, kv_chunk=16).numpy()
out["olmoe"] = float(np.max(np.abs(got - ref) / (1 + np.abs(ref))))

# internlm2's prefill and two decodes under set_decode_shard on (1, 4), fp32
cfg = jcfg("internlm2-1.8b", smoke=True)
jmesh = j_make_mesh((1, 4), ("data", "model"))
jm = JModel(cfg, mesh=jmesh)
params = fp32(JModel(cfg).init(jax.random.PRNGKey(2)))
tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
nxt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
JL.set_decode_shard(jmesh)
lg, cache = jax.jit(lambda p, t: JD.prefill(jm, p, {"tokens": t}, max_len=16,
                                            kv_chunk=8))(params, tok)
dec = jax.jit(lambda p, c, t: JD.decode_step(jm, p, c, t))
refs = [np.asarray(lg)]
for i in range(2):
    lg, cache = dec(params, cache, nxt[:, i:i + 1])
    refs.append(np.asarray(lg))
JL.set_decode_shard(None)
tm = TModel(tcfg("internlm2-1.8b", smoke=True), mesh=cpu((1, 4)))
ps = tm.param_layout().shard(params_from_numpy(as_np(params), tm.infos(), device="cpu",
                                               dtype=torch.float32))
TL.set_decode_shard(tm.mesh)
lg, c = prefill(tm, ps, {"tokens": torch.from_numpy(tok)}, max_len=16, kv_chunk=8)
gots = [lg.numpy()]
for i in range(2):
    lg, c = decode_step(tm, ps, c, torch.from_numpy(nxt[:, i:i + 1]))
    gots.append(lg.numpy())
TL.set_decode_shard(None)
out["decode"] = [float(np.max(np.abs(a - b) / (1 + np.abs(b)))) for a, b in zip(gots, refs)]

# the newly split families' forward, prefill and two decodes on (1, 4), fp32,
# through the reference's sharded model
out["families"] = {}
for i, arch in enumerate(SPLIT):
    cfg = jcfg(arch, smoke=True)
    jm = JModel(cfg, mesh=j_make_mesh((1, 4), ("data", "model")))
    rng = np.random.default_rng(4 + i)
    params = draw(JModel(cfg).infos(), rng)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)

    refs = [np.asarray(jax.jit(lambda p, bb: jm.forward(p, bb, kv_chunk=8))(params, b))]
    lg, c = jax.jit(lambda p, bb: JD.prefill(jm, p, bb, max_len=16, kv_chunk=8))(params, b)
    refs.append(np.asarray(lg))
    dec = jax.jit(lambda p, cc, t: JD.decode_step(jm, p, cc, t))
    for t in range(2):
        lg, c = dec(params, c, nxt[:, t:t + 1])
        refs.append(np.asarray(lg))
    tm = TModel(tcfg(arch, smoke=True), mesh=cpu((1, 4)))
    ps = tm.param_layout().shard(params_from_numpy(as_np(params), tm.infos(), device="cpu",
                                                   dtype=torch.float32))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    gots = [tm.forward(ps, tb, kv_chunk=8).numpy()]
    lg, c = prefill(tm, ps, tb, max_len=16, kv_chunk=8)
    gots.append(lg.numpy())
    for t in range(2):
        lg, c = decode_step(tm, ps, c, torch.from_numpy(nxt[:, t:t + 1]))
        gots.append(lg.numpy())
    out["families"][arch] = [float(np.max(np.abs(a - r) / (1 + np.abs(r))))
                             for a, r in zip(gots, refs)]

# the reference's fp32 (2, 2) sharded step for mamba2: SSD heads whose
# weights lie on other slots
out["ssm_step"] = ref_step("mamba2-780m", (2, 2), draw(
    JModel(jcfg("mamba2-780m", smoke=True)).infos(), np.random.default_rng(9)))
print(json.dumps(out))
"""


def test_port_matches_the_reference_sharded_runs():
    code = ('import os\nos.environ["XLA_FLAGS"] = '
            '"--xla_force_host_platform_device_count=8"\n' + REFERENCE_RUNS.replace("__SPLIT__", repr(SPLIT)))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=400, env=env)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["step"]["m_rel"] <= GRAD_RTOL, out
    assert abs(out["step"]["loss"] - out["step"]["loss_ref"]) < 5e-2, out
    assert out["step"]["w_delta"] < 5e-2, out
    assert out["olmoe"] <= SERVE_TOL, out
    assert max(out["decode"]) <= SERVE_TOL, out
    assert sorted(out["families"]) == sorted(SPLIT), out
    assert max(max(v) for v in out["families"].values()) <= SERVE_TOL, out
    assert out["ssm_step"]["m_rel"] <= GRAD_RTOL, out
    assert abs(out["ssm_step"]["loss"] - out["ssm_step"]["loss_ref"]) < 5e-2, out
    assert out["ssm_step"]["w_delta"] < 5e-2, out
