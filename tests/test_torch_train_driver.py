"""The training plane's files, recovery and ``train()`` against the JAX
package: checkpoints across packages, fault tolerance, gradient compression
and ``launch/train.py``.

* Checkpoints: a checkpoint written by ``repro.train`` restores in the port
  and the port's in ``repro.train``, values equal (bf16 leaves included),
  for the internlm2 smoke tree of params and ``AdamWState``; the port's
  manifest and every ``.npy`` entry equal the reference's byte for byte;
  atomic publish, ``latest_step``, ``prune_checkpoints``, a shape mismatch
  (``ValueError``) and a missing leaf (``KeyError``), re-placing onto a
  mesh's slots.
* Fault tolerance: ``WatchdogPolicy``, ``plan_remesh`` and
  ``run_with_recovery`` give the reference's answers and events on the same
  scripted failures.
* Compression: ``quantize_int8`` / ``dequantize_int8`` bit-equal to the
  reference; ``ef_allreduce_tree`` over 8 CPU slots within the reference's
  0.05 of the true mean; error feedback keeps the running sum within one
  quantisation step, as the reference's test holds it; a model tree in the
  port's layout, given its info tree, takes one scale per stacked leaf as
  the reference's stacked tree does, and a list of leaves that is no
  layers stack one scale per leaf.
* ``train()``: both packages resume their own copy of one reference
  checkpoint for 3 steps with the same token draws; losses within
  ``RESUME_RTOL`` = 1e-2 relative (bf16 parameters; measured 1.6e-5).  The
  port's run on a 2-slot CPU mesh tracks its one-device run within 1e-5
  relative; an injected ``StepFailure`` restores and replays its step to
  the same loss bit for bit; with no card and no device it raises.
"""
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_serve import JaxTokenDraws  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import compression as j_comp  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import fault_tolerance as j_ft  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import constant_lr as j_constant_lr  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.distributed import compression as t_comp  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch.train import train as t_train  # noqa: E402
from repro_torch.models import Model as TModel, named_params, params_from_numpy  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import fault_tolerance as t_ft  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402

ARCH = "internlm2-1.8b"
RESUME_RTOL = 1e-2
TRAIN_KW = dict(smoke=True, batch=4, seq=32, lr=3e-3, kv_chunk=32, seed=0,
                data_mode="periodic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# checkpoints across packages
# ----------------------------------------------------------------------
def both_states():
    """The internlm2 smoke tree of bf16 params and a stepped AdamWState in
    both packages, equal values (fp32 moments, int32 step)."""
    jm = JModel(j_get_config(ARCH, smoke=True))
    tm = TModel(t_get_config(ARCH, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = JAdamW(lr=j_constant_lr(1e-3))
    g = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, js, _ = jopt.update(g, jopt.init(jp), jp)
    jtree = {"params": jp, "opt": js}
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    unstack = lambda t, dt: params_from_numpy(t, tm.infos(), device="cpu", dtype=dt)
    ttree = {"params": unstack(np_tree["params"], None),
             "opt": AdamWState(step=torch.tensor(int(js.step), dtype=torch.int32),
                               m=unstack(np_tree["opt"].m, torch.float32),
                               v=unstack(np_tree["opt"].v, torch.float32))}
    return jtree, ttree, tm


def port_numpy(ttree, tm):
    """The port's state as the reference's numpy tree (fp32 for bf16)."""
    from repro_torch.train.checkpoint import _flatten
    return {k: torch.stack([x.float() for x in leaves]).reshape(shape).numpy()
            for k, (shape, leaves) in _flatten(ttree).items()}


def reference_numpy(jtree):
    flat, _ = j_ckpt._flatten_with_paths(jtree)
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in flat}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree, tm = both_states()
    j_ckpt.save_checkpoint(tmp_path, 7, jtree, extra={"pipeline": {"step": 7}})
    zeros = {"params": jax.tree_util.tree_map(torch.zeros_like, ttree["params"]),
             "opt": AdamWState(torch.zeros((), dtype=torch.int32),
                               *(jax.tree_util.tree_map(torch.zeros_like, x)
                                 for x in ttree["opt"][1:]))}
    got, step, extra = t_ckpt.restore_checkpoint(tmp_path, zeros)
    assert step == 7 and extra == {"pipeline": {"step": 7}}
    assert got["params"]["layers"][1]["mlp"]["w_up"].dtype == torch.bfloat16
    assert isinstance(got["opt"], AdamWState)
    ref, mine = reference_numpy(jtree), port_numpy(got, tm)
    assert ref.keys() == mine.keys() and len(ref) == 37
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree, tm = both_states()
    t_ckpt.save_checkpoint(tmp_path / "port", 7, ttree, extra={"note": "x"})
    got, step, extra = j_ckpt.restore_checkpoint(tmp_path / "port", jtree)
    assert step == 7 and extra == {"note": "x"}
    assert got["params"]["layers"]["mlp"]["w_up"].dtype == jnp.bfloat16
    ref, mine = reference_numpy(jtree), reference_numpy(got)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    # the files themselves: the manifest's keys and every .npy entry
    # (bf16 as '<V2') are the reference's byte for byte
    j_ckpt.save_checkpoint(tmp_path / "ref", 7, jtree, extra={"note": "x"})
    man = {w: json.loads((tmp_path / w / "step_00000007" / "MANIFEST.json").read_text())
           for w in ("port", "ref")}
    assert man["port"]["keys"] == man["ref"]["keys"]
    assert man["port"]["extra"] == man["ref"]["extra"] and man["port"]["step"] == 7
    entries = {}
    for w in ("port", "ref"):
        with zipfile.ZipFile(tmp_path / w / "step_00000007" / "shard_p0.npz") as zf:
            entries[w] = {name: zf.read(name) for name in zf.namelist()}
    assert list(entries["port"]) == list(entries["ref"])
    for name, data in entries["ref"].items():
        assert entries["port"][name] == data, name
    bf16 = [e for e in man["port"]["keys"] if e["dtype"] == "bfloat16"]
    assert bf16 and all(b"'descr': '<V2'" in entries["port"][e["name"] + ".npy"][:128]
                        for e in bf16)


def test_checkpoint_atomic_latest_and_prune(tmp_path):
    tree = {"a": torch.randn(4, 8), "nested": {"b": torch.randn(3),
                                                "step": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        t_ckpt.save_checkpoint(tmp_path, s, tree)
    # no step_* directory without its manifest, no .tmp left behind
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (1, 2, 3, 4)]
    assert all((tmp_path / n / "MANIFEST.json").exists() for n in os.listdir(tmp_path))
    assert t_ckpt.latest_step(tmp_path) == 4 == j_ckpt.latest_step(tmp_path)
    t_ckpt.prune_checkpoints(tmp_path, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_checkpoint(tmp_path, tree, step=1)
    got, step, extra = t_ckpt.restore_checkpoint(tmp_path, tree)
    assert step == 4 and extra == {}
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(got)))
    # a stale .tmp of an unfinished write is neither listed nor restored
    (tmp_path / "step_00000009.tmp0").mkdir()
    assert t_ckpt.latest_step(tmp_path) == 4
    assert t_ckpt.latest_step(tmp_path / "absent") is None


def test_checkpoint_rejects_shape_mismatch_and_missing_leaf(tmp_path):
    t_ckpt.save_checkpoint(tmp_path, 1, {"a": torch.zeros((2, 2)),
                                         "layers": [{"w": torch.zeros(3)}] * 2})
    with pytest.raises(ValueError):
        t_ckpt.restore_checkpoint(tmp_path, {"a": torch.zeros((3, 3)),
                                             "layers": [{"w": torch.zeros(3)}] * 2})
    with pytest.raises(ValueError):          # 3 layers where 2 were saved
        t_ckpt.restore_checkpoint(tmp_path, {"a": torch.zeros((2, 2)),
                                             "layers": [{"w": torch.zeros(3)}] * 3})
    with pytest.raises(KeyError):
        t_ckpt.restore_checkpoint(tmp_path, {"a": torch.zeros((2, 2)),
                                             "b": torch.zeros(1),
                                             "layers": [{"w": torch.zeros(3)}] * 2})


def test_restore_onto_every_slot_of_a_mesh(tmp_path):
    tree = {"layers": [{"w": torch.randn(3, 2)} for _ in range(4)], "b": torch.randn(5)}
    t_ckpt.save_checkpoint(tmp_path, 2, tree)
    mesh = make_mesh(3, ["cpu"] * 3)
    slots, step, _ = t_ckpt.restore_checkpoint(tmp_path, tree, device=mesh)
    assert step == 2 and len(slots) == 3 and slots[0]["b"] is slots[1]["b"] is slots[2]["b"]
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(slots[0]["layers"], tree["layers"]))
    one, _, _ = t_ckpt.restore_checkpoint(tmp_path, tree, device="cpu")
    assert torch.equal(one["b"], tree["b"])


# ----------------------------------------------------------------------
# fault tolerance
# ----------------------------------------------------------------------
def scripted_run(ft, fails_at, num_steps=10, every=2, max_retries=3):
    """run_with_recovery over a step function that fails at ``fails_at``
    (step → times); returns (final step or the exception's type name,
    completed steps, events)."""
    left = dict(fails_at)
    completed, events, saved = [], [], {"step": 0}

    def step_fn(step):
        if left.get(step, 0) > 0:
            left[step] -= 1
            raise ft.StepFailure(f"simulated failure at {step}")
        completed.append(step)
        return {}

    def save(step):
        saved["step"] = step

    try:
        final = ft.run_with_recovery(
            step_fn, start_step=0, num_steps=num_steps, save_fn=save,
            restore_fn=lambda: saved["step"], checkpoint_every=every,
            max_retries=max_retries, on_event=lambda k, i: events.append((k, i)))
    except ft.StepFailure:
        final = "StepFailure"
    return final, completed, events


@pytest.mark.parametrize("fails_at", [{}, {5: 2}, {3: 1, 7: 1}, {4: 9}])
def test_recovery_matches_reference(fails_at):
    assert scripted_run(t_ft, fails_at) == scripted_run(j_ft, fails_at)


def test_watchdog_and_remesh_match_reference():
    rng = np.random.default_rng(0)
    times = list(rng.exponential(1.0, 130))
    policies = [(mod.WatchdogPolicy(warmup_steps=3, multiplier=2.0, min_deadline_s=0.0),
                 mod) for mod in (t_ft, j_ft)]
    for t in times:
        answers = [(w.deadline_s, w.is_straggler(t)) for w, _ in policies]
        assert answers[0] == answers[1]
        for w, _ in policies:
            w.record(t)
    for chips in range(0, 300):
        for mp in (1, 8, 16):
            assert t_ft.plan_remesh(chips, model_parallel=mp) == \
                j_ft.plan_remesh(chips, model_parallel=mp)


# ----------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------
def test_quantize_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(1000).astype(np.float32) * 3,
             rng.standard_normal((16, 64)).astype(np.float32) * 1e-3,
             np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0], np.float32),  # ties
             np.zeros(8, np.float32)]
    for x in cases:
        jq, js = j_comp.quantize_int8(jnp.asarray(x))
        tq, ts = t_comp.quantize_int8(torch.from_numpy(x))
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert t_comp.dequantize_int8(tq, ts).numpy().tobytes() == \
            np.asarray(j_comp.dequantize_int8(jq, js)).tobytes()
    tree = {"w": np.zeros((128, 128)), "b": [np.zeros(3), np.zeros((2, 5))]}
    assert t_comp.compression_ratio(jax.tree_util.tree_map(torch.from_numpy, tree)) == \
        j_comp.compression_ratio(tree)


def test_ef_allreduce_tree_over_eight_slots():
    g = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 256)))
    true_mean = g.mean(0)
    mesh = make_mesh(8, ["cpu"] * 8)
    grads = [{"w": torch.from_numpy(g[i:i + 1])} for i in range(8)]
    errors = [t_comp.init_error_tree(x) for x in grads]
    red, err = t_comp.ef_allreduce_tree(grads, errors, mesh)
    rel = float(np.abs(red["w"][0].numpy() - true_mean).max()
                / (np.abs(true_mean).max() + 1e-9))
    assert rel < 0.05, rel
    # each slot's new error is what its quantisation left out
    for i in range(8):
        q, s = t_comp.quantize_int8(grads[i]["w"])
        assert torch.equal(err[i]["w"], grads[i]["w"] - t_comp.dequantize_int8(q, s))


def test_error_feedback_keeps_the_mean_over_steps():
    mesh = make_mesh(1, ["cpu"])
    grads = [{"w": torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(3), (1, 64))))}]
    errs = [t_comp.init_error_tree(grads[0])]
    total = torch.zeros(64)
    for _ in range(10):
        red, errs = t_comp.ef_allreduce_tree(grads, errs, mesh)
        total = total + red["w"][0]
    true_total = grads[0]["w"][0] * 10
    _, scale = t_comp.quantize_int8(grads[0]["w"][0])
    assert float((total - true_total).abs().max()) <= float(scale) + 1e-5


def test_ef_allreduce_one_scale_per_stacked_leaf():
    """A model-shaped gradient tree in the port's layout (per-layer lists)
    against the reference's stacked tree, two slots, layer l scaled by
    1000**l: one int8 scale per stacked leaf, so the reduced mean, the
    errors and the wire ratio are the reference's."""
    tm = TModel(t_get_config(ARCH, smoke=True))
    rng = np.random.default_rng(7)

    def draw(info):
        if not isinstance(info, dict):
            x = rng.standard_normal(info.shape).astype(np.float32)
            if info.logical[0] == "layers":
                x = x * (1000.0 ** np.arange(info.shape[0], dtype=np.float32)
                         ).reshape((-1,) + (1,) * (x.ndim - 1))
            return x
        return {k: draw(v) for k, v in info.items()}

    slots = [draw(tm.infos()) for _ in range(2)]
    port = [params_from_numpy(t, tm.infos(), device="cpu", dtype=torch.float32)
            for t in slots]
    red, err = t_comp.ef_allreduce_tree(port, [t_comp.init_error_tree(g) for g in port],
                                        make_mesh(2, ["cpu"] * 2), infos=tm.infos())
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *slots)
    j_red, j_err = jax.vmap(lambda g, e: j_comp.ef_allreduce_tree(g, e, "pod"),
                            axis_name="pod")(stacked, j_comp.init_error_tree(stacked))
    as_port = lambda t: params_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                                          tm.infos(), device="cpu", dtype=torch.float32)
    want = as_port(jax.tree_util.tree_map(lambda x: x[0], j_red))
    for (name, got), ref in zip(named_params(red).items(), named_params(want).values()):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=0,
                                   err_msg=name)
    for s in range(2):
        want_e = as_port(jax.tree_util.tree_map(lambda x: x[s], j_err))
        for got, ref in zip(named_params(err[s]).values(), named_params(want_e).values()):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=0)
    assert t_comp.compression_ratio(port[0], tm.infos()) == \
        j_comp.compression_ratio(slots[0])


def test_ef_allreduce_list_of_leaves_matches_reference():
    """A jax-style list of equal-shaped leaves that is no layers stack,
    1000x apart, over two slots: with no info tree each leaf keeps its own
    scale, as ``jax.tree_util`` takes the list in the reference."""
    rng = np.random.default_rng(8)
    slots = [{"w": [rng.standard_normal((4, 8)).astype(np.float32) * 1000.0 ** i
                    for i in range(2)], "b": rng.standard_normal(8).astype(np.float32)}
             for _ in range(2)]
    port = [jax.tree_util.tree_map(torch.from_numpy, t) for t in slots]
    red, err = t_comp.ef_allreduce_tree(port, [t_comp.init_error_tree(g) for g in port],
                                        make_mesh(2, ["cpu"] * 2))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *slots)
    j_red, j_err = jax.vmap(lambda g, e: j_comp.ef_allreduce_tree(g, e, "pod"),
                            axis_name="pod")(stacked, j_comp.init_error_tree(stacked))
    for got, ref in zip(jax.tree_util.tree_leaves(red),
                        jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x[0], j_red))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    for s in range(2):
        for got, ref in zip(jax.tree_util.tree_leaves(err[s]), jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda x: x[s], j_err))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    assert t_comp.compression_ratio(port[0]) == j_comp.compression_ratio(slots[0])


# ----------------------------------------------------------------------
# train()
# ----------------------------------------------------------------------
def test_train_resumes_a_reference_checkpoint(tmp_path):
    j_train(ARCH, steps=6, checkpoint_every=3, ckpt_dir=str(tmp_path / "ref"), **TRAIN_KW)
    assert j_ckpt.latest_step(tmp_path / "ref") == 6
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    _, ref = j_train(ARCH, steps=3, checkpoint_every=3, ckpt_dir=str(tmp_path / "ref"),
                     **TRAIN_KW)
    _, got = t_train(ARCH, steps=3, checkpoint_every=3, ckpt_dir=str(tmp_path / "port"),
                     device="cpu", draws=JaxTokenDraws(), **TRAIN_KW)
    assert len(got) == len(ref) == 3
    rel = np.abs(np.array(got) - np.array(ref)) / np.array(ref)
    assert rel.max() <= RESUME_RTOL, rel
    # and the port's final checkpoint restores in the reference
    assert t_ckpt.latest_step(tmp_path / "port") == 9
    jm = JModel(j_get_config(ARCH, smoke=True))
    like = {"params": jm.init(jax.random.PRNGKey(0))}
    like["opt"] = JAdamW(lr=j_constant_lr(1e-3)).init(like["params"])
    state, step, extra = j_ckpt.restore_checkpoint(tmp_path / "port", like)
    assert step == 9 and extra["pipeline"]["step"] == 9 and int(state["opt"].step) == 9


class FailOnce(JaxTokenDraws):
    """The reference's draws, raising ``StepFailure`` the first time step
    ``at``'s batch is drawn: the step fails before it computes."""

    def __init__(self, at):
        self.at, self.failed = at, False

    def phase(self, seed, step, lo, n, vocab):
        if step == self.at and not self.failed:
            self.failed = True
            raise t_ft.StepFailure(f"injected at step {step}")
        return super().phase(seed, step, lo, n, vocab)


def test_train_recovers_and_replays_bit_for_bit(tmp_path):
    events = []
    kw = dict(TRAIN_KW, device="cpu", ckpt_dir=str(tmp_path), checkpoint_every=2)
    _, losses = t_train(ARCH, steps=6, draws=FailOnce(3),
                        on_event=lambda k, i: events.append((k, i)), **kw)
    kinds = [(k, i["step"]) for k, i in events if k != "step"]
    assert kinds == [("checkpoint", 2), ("failure", 3), ("restored", 2),
                     ("checkpoint", 4), ("checkpoint", 6)]
    steps = [(i["step"], i["loss"]) for k, i in events if k == "step"]
    assert [s for s, _ in steps] == [0, 1, 2, 2, 3, 4, 5]
    assert steps[2][1] == steps[3][1]          # step 2 replayed from the checkpoint
    assert len(losses) == 7 and t_ckpt.latest_step(tmp_path) == 6
    # an uninterrupted run gives the same losses
    shutil.rmtree(tmp_path)
    _, clean = t_train(ARCH, steps=6, draws=JaxTokenDraws(), **kw)
    assert clean == [loss for _, loss in steps[:2] + steps[3:]]


def test_train_on_a_two_slot_mesh(tmp_path):
    kw = dict(TRAIN_KW, steps=3, draws=JaxTokenDraws())
    _, one = t_train(ARCH, device="cpu", **kw)
    _, two = t_train(ARCH, mesh=make_mesh(2, ["cpu"] * 2), **kw)
    assert np.abs(np.array(one) - np.array(two)).max() <= 1e-5 * max(one)


def test_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train(ARCH, steps=1)


def test_non_finite_loss_leaves_the_state(monkeypatch):
    """A step whose loss is NaN applies no update: parameters, moments and
    the step count stay byte-equal, on one device and on two slots."""
    from repro_torch.train import (AdamW, constant_lr, make_state_shardings,
                                   make_train_step, shard_train_step)
    tm = TModel(t_get_config(ARCH, smoke=True))
    opt = AdamW(lr=constant_lr(1e-3))
    batch = {"tokens": torch.randint(0, 256, (4, 17), generator=torch.Generator().manual_seed(0))}
    params = tm.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    state = opt.init(params)
    params, state, _ = make_train_step(tm, opt, kv_chunk=16)(params, state, batch)
    snap = lambda t: [x.clone() for x in t_params_leaves(t)]
    before = snap({"p": params, "s": state})
    real = TModel.train_loss
    monkeypatch.setattr(TModel, "train_loss",
                        lambda self, *a, **kw: real(self, *a, **kw) * float("nan"))
    p2, s2, met = make_train_step(tm, opt, kv_chunk=16)(params, state, batch)
    assert not np.isfinite(float(met["loss"])) and int(s2.step) == 1
    assert all(torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
               for a, b in zip(before, snap({"p": p2, "s": s2})))
    mesh = make_mesh(2, ["cpu"] * 2)
    p_lay, o_lay = make_state_shardings(mesh, tm)
    slots, states = p_lay.shard(params), o_lay.shard(state)
    p3, s3, _ = shard_train_step(tm, opt, mesh, kv_chunk=16)(slots, states, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, snap({"p": p_lay.gather(p3),
                                                               "s": o_lay.gather(s3)})))


def t_params_leaves(tree):
    from repro_torch.models.params import tree_leaves
    return list(tree_leaves(tree))


def test_train_retries_a_non_finite_step_from_the_last_good_state(monkeypatch):
    """No checkpoint directory, a NaN loss injected into the third
    ``train_loss`` call (step 2): the retry starts from the parameters that
    step 2 first saw, byte for byte, and the run completes."""
    seen, events = [], []
    real = TModel.train_loss

    def train_loss(self, params, batch, **kw):
        seen.append([x.detach().clone() for x in t_params_leaves(params)])
        loss = real(self, params, batch, **kw)
        return loss * float("nan") if len(seen) == 3 else loss

    monkeypatch.setattr(TModel, "train_loss", train_loss)
    def on_event(kind, info):            # the live state, copied as it is now
        if "state" in info:
            info = dict(info, state=[x.detach().clone()
                                     for x in t_params_leaves(info["state"])])
        events.append((kind, info))

    _, losses = t_train(ARCH, steps=4, device="cpu", draws=JaxTokenDraws(),
                        on_event=on_event, **TRAIN_KW)
    kinds = [(k, i["step"]) for k, i in events if k not in ("step", "straggler")]
    assert kinds == [("failure", 2), ("restored", 0)]
    assert all(np.isfinite(losses)) and len(losses) == 6
    assert all(torch.equal(a, b) for a, b in zip(seen[2], seen[3]))
    restored = dict(events)["restored"]["state"]     # params, opt step, m, v
    n = len(seen[2])
    assert int(restored[n]) == 2
    assert all(torch.equal(a, b) for a, b in zip(restored[:n], seen[2]))
