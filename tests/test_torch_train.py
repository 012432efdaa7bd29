"""The training plane's arithmetic against the JAX package: ``train_loss``
and its gradients for all ten architectures, remat, AdamW leaf for leaf,
the schedules, one train step (plain and microbatched), and the
data-parallel step over a CPU mesh.

Parameters and batches are drawn with numpy from a seed and carried across
with ``params_from_numpy`` (fp32 trees, as ``test_torch_models.py`` does);
the reference runs on the CPU, its update and train step jitted as its own
tests run them.  The port's per-layer leaves are held against the
reference's stacked leaves sliced by layer.

Tolerances, each on max |Δ| / max |reference| of a leaf:
  * ``train_loss`` and every gradient leaf: ``GRAD_RTOL`` = 1e-4 (measured
    ≤ 4e-6, the SSD decay's ``a_log``);
  * AdamW over three steps: m, v and parameters ``OPT_RTOL`` = 1e-6, the
    grad norm 1e-6 relative, ``lr`` equal; the schedules equal at steps
    0-20;
  * one train step: loss and grad norm 1e-5 relative, m and v ``GRAD_RTOL``,
    and each parameter within ``STEP_ATOL`` = 2·lr absolute: after one step
    AdamW's delta is g / (|g| + eps), so a gradient entry within rounding of
    zero may move its weight by up to lr on one side and not the other;
  * the data-parallel step against the one-device step: loss 1e-6
    relative, parameters ``STEP_ATOL``;
  * remat: bit-equal gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_models import both_batches, both_params, numpy_params, rel_err  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import constant_lr as j_constant_lr  # noqa: E402
from repro.train.optimizer import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import Model as TModel, named_params, params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.train import (AdamW, constant_lr, make_state_shardings,  # noqa: E402
                               make_train_step, shard_train_step, value_and_grad,
                               warmup_cosine)

B, S, KV_CHUNK = 2, 16, 8
GRAD_RTOL = 1e-4
OPT_RTOL = 1e-6
LR = 1e-3
STEP_ATOL = 2 * LR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_batches(cfg, seed, rows=B, seq=S):
    """The same training batch for both packages: ``seq + 1`` tokens a row
    (``train_loss`` predicts tokens 1..seq from 0..seq-1)."""
    jb, tb = both_batches(cfg, np.random.default_rng(seed), rows, seq + 1, fp32=True)
    for k in ("frames",):                       # the encoder reads seq frames
        if k in jb:
            jb[k], tb[k] = jb[k][:, :seq], tb[k][:, :seq]
    return jb, tb


def as_port(tree, model):
    """A reference-layout numpy / JAX tree in the port's layout (fp32)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), model.infos(),
                             device="cpu", dtype=torch.float32)


def assert_trees_close(ref_port_layout, got, rtol, what):
    ref, got = named_params(ref_port_layout), named_params(got)
    assert ref.keys() == got.keys()
    worst = max((rel_err(ref[n], got[n]), n) for n in ref)
    assert worst[0] <= rtol, f"{what}: {worst}"


# ----------------------------------------------------------------------
# train_loss and its gradients, all ten architectures
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    jm, jp, tm, tp, _ = both_params(arch, 0, fp32=True)
    jb, tb = train_batches(jm.cfg, 1)
    jl, jg = jax.value_and_grad(lambda p, b: jm.train_loss(p, b, kv_chunk=KV_CHUNK))(jp, jb)
    tl, tg = value_and_grad(tm, tp, tb, kv_chunk=KV_CHUNK)
    assert abs(float(tl) - float(jl)) <= GRAD_RTOL * abs(float(jl))
    it = iter(tg)
    assert_trees_close(as_port(jg, tm), tree_map(lambda _: next(it), tp), GRAD_RTOL,
                       f"{arch} grads")
    # train_loss is the forward's CE on the shifted tokens
    from repro_torch.models import cross_entropy
    with torch.no_grad():
        logits = tm(tp, {**tb, "tokens": tb["tokens"][:, :-1]}, kv_chunk=KV_CHUNK)
        assert float(cross_entropy(logits, tb["tokens"][:, 1:])) == float(tl)


def count_saved(model, params, batch):
    """Tensors autograd saves outside any checkpointed body."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.train_loss(leaves, batch, kv_chunk=KV_CHUNK)
    return n[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_memory_not_values(arch):
    """``remat="none"``, ``"dots"`` and ``"full"`` give bit-equal loss and
    gradients; with remat, autograd keeps far fewer tensors."""
    _, _, tm, tp, _ = both_params(arch, 0, fp32=True)
    _, tb = train_batches(tm.cfg, 1)
    runs, saved = {}, {}
    for remat in ("none", "dots", "full"):
        model = TModel(tm.cfg.replace(remat=remat))
        runs[remat] = value_and_grad(model, tp, tb, kv_chunk=KV_CHUNK)
        saved[remat] = count_saved(model, tp, tb)
    for remat in ("dots", "full"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], runs["none"][1]))
        assert saved[remat] * 2 < saved["none"], saved


def test_ssd_backward_finite_where_decay_overflows():
    """Where exp(cum_i - cum_j) overflows above the SSD chunk's diagonal,
    the reference's gradients are NaN (it exponentiates before masking);
    the port's forward equals the reference's and its gradients are
    finite."""
    jm, _, tm, _, tree = both_params("mamba2-780m", 0, fp32=True)
    tree["layers"]["ssm"]["a_log"][:] = 3.0            # A = -e^3
    tree["layers"]["ssm"]["dt_bias"][:] = 2.0          # dt ≈ 2: da ≈ -40 a token
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jb, tb = train_batches(jm.cfg, 1, seq=32)
    jl, jg = jax.value_and_grad(lambda p, b: jm.train_loss(p, b, kv_chunk=KV_CHUNK))(jp, jb)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree_util.tree_leaves(jg))
    tl, tg = value_and_grad(tm, as_port(tree, tm), tb, kv_chunk=KV_CHUNK)
    assert abs(float(tl) - float(jl)) <= GRAD_RTOL * abs(float(jl))
    assert all(bool(torch.isfinite(g).all()) for g in tg)


# ----------------------------------------------------------------------
# AdamW and the schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama-3.2-vision-90b"])
def test_adamw_matches_reference_leaf_for_leaf(arch):
    """Three updates on random fp32 trees shaped like the model's (stacked
    ``ln1`` / ``ln2``, and the vlm's nested ``[groups, k, ...]`` stacks and
    ``[groups, 1]`` gate): m, v and parameters leaf for leaf."""
    jm = JModel(j_get_config(arch, smoke=True))
    tm = TModel(t_get_config(arch, smoke=True))
    rng = np.random.default_rng(5)
    tree = numpy_params(jm.infos(), rng, fp32=True)
    jopt = JAdamW(lr=j_warmup_cosine(1e-2, 2, 10))
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = as_port(tree, tm)
    js, ts = jopt.init(jp), topt.init(tp)
    j_update = jax.jit(jopt.update)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32)
                                   * 0.3, tree)
        before = tree_map(torch.clone, tp)
        jp, js, jstats = j_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tstats = topt.update(as_port(g, tm), ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        assert float(tstats["lr"]) == float(jstats["lr"])
        assert abs(float(tstats["grad_norm"]) - float(jstats["grad_norm"])) \
            <= OPT_RTOL * float(jstats["grad_norm"])
        assert_trees_close(as_port(js.m, tm), ts.m, OPT_RTOL, f"m, step {step}")
        assert_trees_close(as_port(js.v, tm), ts.v, OPT_RTOL, f"v, step {step}")
        assert_trees_close(as_port(jp, tm), tp, OPT_RTOL, f"params, step {step}")
    # the stacked-rank rule has teeth: a per-layer norm is decayed, and
    # the decay is far above the tolerance
    ln1 = [lp["ln1"] for lp in (tp["layers"] if tm.cfg.family == "dense"
                                else tp["layers"][0])]
    old = [lp["ln1"] for lp in (before["layers"] if tm.cfg.family == "dense"
                                else before["layers"][0])]
    lr = float(tstats["lr"])
    wd_step = max(float((lr * topt.weight_decay * o).abs().max()) for o in old)
    assert wd_step > 100 * OPT_RTOL * max(float(x.abs().max()) for x in ln1)


def test_schedules_match_reference():
    for args in ((3e-4, 5, 20), (1e-3, 2, 12, 0.2), (1e-2, 0, 7)):
        jf, tf = j_warmup_cosine(*args), warmup_cosine(*args)
        for s in range(21):
            ref = float(jf(jnp.int32(s)))
            assert float(tf(torch.tensor(s, dtype=torch.int32))) == ref, (args, s)
    for s in range(21):
        assert float(constant_lr(3e-4)(torch.tensor(s))) == float(j_constant_lr(3e-4)(s))


# ----------------------------------------------------------------------
# one train step, plain and microbatched; the data-parallel step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m"])
def test_train_step_matches_reference(arch, microbatches):
    jm, jp, tm, tp, _ = both_params(arch, 0, fp32=True)
    jb, tb = train_batches(jm.cfg, 2, rows=8)
    jopt, topt = JAdamW(lr=j_constant_lr(LR)), AdamW(lr=constant_lr(LR))
    jfn = jax.jit(j_make_train_step(jm, jopt, kv_chunk=KV_CHUNK, microbatches=microbatches))
    jp2, js2, jmet = jfn(jp, jopt.init(jp), jb)
    tfn = make_train_step(tm, topt, kv_chunk=KV_CHUNK, microbatches=microbatches)
    tp2, ts2, tmet = tfn(tp, topt.init(tp), tb)
    assert tp2 is tp                                   # updated in place
    for k in ("loss", "grad_norm"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert_trees_close(as_port(js2.m, tm), ts2.m, GRAD_RTOL, "m")
    assert_trees_close(as_port(js2.v, tm), ts2.v, GRAD_RTOL, "v")
    ref = named_params(as_port(jp2, tm))
    got = named_params(tp2)
    worst = max(float((ref[n] - got[n]).abs().max()) for n in ref)
    assert worst <= STEP_ATOL, worst


@pytest.mark.parametrize("microbatches", [1, 2])
def test_shard_train_step_matches_one_device(microbatches):
    """Two slots of the CPU (a 1-D mesh: one model slot), each microbatch
    of 8 / ``microbatches`` rows split over them, against one device on
    all 8 (in ``2 × microbatches``); the state laid out by the mesh's
    layout, each slot's pieces updated on its own."""
    _, _, tm, tp, _ = both_params("internlm2-1.8b", 0, fp32=True)
    _, tb = train_batches(tm.cfg, 2, rows=8)
    opt = AdamW(lr=constant_lr(LR))
    one = tree_map(torch.clone, tp)
    one, _, m1 = make_train_step(tm, opt, kv_chunk=KV_CHUNK,
                                 microbatches=2 * microbatches)(one, opt.init(one), tb)
    mesh = make_mesh(2, ["cpu"] * 2)
    p_lay, o_lay = make_state_shardings(mesh, tm)
    slots = p_lay.shard(tp)
    slots, states, m2 = shard_train_step(tm, opt, mesh, kv_chunk=KV_CHUNK,
                                         microbatches=microbatches)(
        slots, opt.init_slots(slots), tb)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6 * float(m1["loss"])
    assert int(o_lay.gather(states).step) == 1
    a, b = named_params(one), named_params(p_lay.gather(slots))
    assert max(float((a[n] - b[n]).abs().max()) for n in a) <= STEP_ATOL
