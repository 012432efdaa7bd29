"""The port's dry-run tools against the JAX package's: the roofline
arithmetic, the report tables, the cells' inputs and rules, the counts on
``meta`` slots, the kernels' ``meta`` paths and the CLIMBER dry-run steps.

Small: smoke widths and at most 8 slots (a full-width count on 256 slots
takes tens of seconds).  The reference's launch modules set ``XLA_FLAGS``
to 512 host devices at import; :func:`ref_module` restores the variable
so no later JAX initialisation in this process sees it.
"""
import importlib
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_roofline_dryrun as ref_test  # noqa: E402  (its HLO text and cases)
from repro.utils import report as ref_report  # noqa: E402
from repro.utils import roofline as ref_rl  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.l2 import (pairwise_l2_plain, pairwise_l2_work, qdots_plain,  # noqa: E402
                                    qdots_work)
from repro_torch.kernels.paa_kernel import paa_plain, paa_work  # noqa: E402
from repro_torch.kernels.pivot_rank import pivot_rank_plain, pivot_rank_work  # noqa: E402
from repro_torch.kernels.refine_topk import refine_topk_plain, refine_topk_work  # noqa: E402
from repro_torch.launch import climber_dryrun as CD  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.utils import report as t_report  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402
from repro_torch.utils.config import SHAPES, ClimberConfig, ShapeConfig  # noqa: E402


def ref_module(name):
    """Import a reference launch module without leaving its XLA_FLAGS."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meta_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


def stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


# ----------------------------------------------------------------------
# roofline arithmetic
# ----------------------------------------------------------------------
def test_collective_parse_equals_reference():
    hlo = ref_test.TestCollectiveParse.HLO
    assert RL.collective_bytes(hlo) == ref_rl.collective_bytes(hlo)
    assert RL.collective_bytes(hlo)["all-gather"] == 128 * 128 * 2 + 256 * 2
    plain = "ENTRY e {\n  a = f32[10]{0} add(x, y)\n}"
    assert RL.collective_bytes(plain) == ref_rl.collective_bytes(plain)
    for s in ("bf16[2,3]", "f32[]", "s8[100]", "f8e4m3fn[7,3]", "bogus[2]", "nothing"):
        assert RL._shape_bytes(s) == ref_rl._shape_bytes(s)
    for args in ((1e9, 100, "train"), (1e9, 100, "serve"), (1e9, 100, "serve", 5e8)):
        assert RL.model_flops(*args) == ref_rl.model_flops(*args)


def test_roofline_report_on_h100_constants():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.ICI_BW) == (989e12, 3.35e12, 450e9)
    r = RL.RooflineReport(arch="a", shape="s", mesh="m", flops_per_device=RL.PEAK_FLOPS,
                          bytes_per_device=RL.HBM_BW / 2, coll_bytes_per_device=RL.ICI_BW / 4,
                          coll_breakdown={}, model_flops_per_device=RL.PEAK_FLOPS / 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1.0, 0.5, 0.25))
    assert r.bottleneck == "compute" and r.roofline_fraction == pytest.approx(0.5)
    d = RL.RooflineReport(arch="a", shape="s", mesh="m", flops_per_device=1e9,
                          bytes_per_device=RL.HBM_BW, coll_bytes_per_device=0.0,
                          coll_breakdown={}, model_flops_per_device=1e6,
                          model_bytes_per_device=RL.HBM_BW / 2)
    assert d.bottleneck == "memory" and d.roofline_fraction == pytest.approx(0.5, rel=1e-3)
    ref = ref_rl.RooflineReport(arch="a", shape="s", mesh="m", flops_per_device=1.0,
                                bytes_per_device=1.0, coll_bytes_per_device=1.0,
                                coll_breakdown={})
    assert list(r.to_dict()) == list(ref.to_dict())


# ----------------------------------------------------------------------
# report tables
# ----------------------------------------------------------------------
def _cell(arch, shape, mesh, status="ok", **kw):
    base = {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
            "num_params": 1.89e9, "compile_s": 12.5, "compute_s": 0.118, "memory_s": 0.935,
            "collective_s": 0.094, "bottleneck": "memory", "useful_flops_ratio": 0.87,
            "roofline_fraction": 0.0502,
            "memory": {"argument_bytes": 133096772, "temp_bytes": 6486151188}}
    base.update(kw)
    return base


def test_report_tables_equal_reference(tmp_path, monkeypatch):
    files = {
        "dryrun/internlm2-1.8b_train_4k_16x16.json": _cell("internlm2-1.8b", "train_4k",
                                                           "16x16"),
        "dryrun/internlm2-1.8b_decode_32k_16x16.json": _cell(
            "internlm2-1.8b", "decode_32k", "16x16", bottleneck="collective"),
        "dryrun/olmoe-1b-7b_long_500k_16x16.json": {
            "arch": "olmoe-1b-7b", "shape": "long_500k", "mesh": "16x16",
            "status": "skipped", "reason": "x"},
        "dryrun/bad_prefill_32k_2x16x16.json": {"arch": "bad", "shape": "prefill_32k",
                                                "mesh": "2x16x16", "status": "error"},
        "dryrun/climber_build_16x16.json": _cell("climber", "build", "16x16"),
        "perf/internlm2-1.8b_train_4k_flash_bf16.json": _cell(
            "internlm2-1.8b", "train_4k", "16x16", variant="flash_bf16"),
        "perf/internlm2-1.8b_train_4k_baseline.json": _cell("internlm2-1.8b", "train_4k",
                                                            "16x16"),
    }
    for name, d in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(json.dumps(d))
    monkeypatch.setattr(ref_report, "ART", tmp_path)
    monkeypatch.setattr(t_report, "ART", tmp_path)
    for fn in ("dryrun_table", "roofline_table", "climber_table", "perf_table"):
        assert getattr(t_report, fn)() == getattr(ref_report, fn)(), fn
    text = "a\n<!-- PERF_LOG -->\nold\n<!-- /PERF_LOG -->\nb"
    assert t_report.fill("PERF_LOG", "new", text) == ref_report.fill("PERF_LOG", "new", text)
    assert t_report.fill("NONE", "new", text) == text
    doc = tmp_path / "doc.md"
    doc.write_text("<!-- CLIMBER_TABLE -->\n<!-- /CLIMBER_TABLE -->\n")
    t_report.main(["--fill", str(doc)])
    assert "| build | 16x16 |" in doc.read_text()


# ----------------------------------------------------------------------
# cells: inputs and rules, all ten archs × four shapes
# ----------------------------------------------------------------------
def test_cells_equal_reference():
    ref_dr = ref_module("repro.launch.dryrun")
    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models import count_params as ref_count
    from repro_torch.models import count_params
    import jax
    single, multi = stand_in((16, 16), ("data", "model")), \
        stand_in((2, 16, 16), ("pod", "data", "model"))
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        n = count_params(Model(cfg).infos())
        assert n == ref_count(RefModel(rcfg).infos())
        assert DR.active_params(cfg, n) == ref_dr.active_params(rcfg, n)
        units, make = DR.unit_scaler(cfg)
        r_units, r_make = ref_dr.unit_scaler(rcfg)
        assert units == r_units
        for u in (1, 2):
            assert (make(u).num_layers, make(u).num_encoder_layers) == \
                (r_make(u).num_layers, r_make(u).num_encoder_layers)
        for shape in SHAPES:
            assert DR.cell_is_skipped(cfg, shape.name) == ref_dr.cell_is_skipped(
                rcfg, shape.name)
            for mesh in (single, multi):
                assert DR.pick_microbatches(cfg, shape, mesh) == \
                    ref_dr.pick_microbatches(rcfg, shape, mesh)
            got = DR.input_specs(cfg, shape.name)
            want = ref_dr.input_specs(rcfg, shape.name)
            flat = lambda t: {k: v for k, v in t.items() if k != "cache"}
            got_leaves = dict(flat(got), **got.get("cache", {}))
            want_leaves = dict(flat(want), **want.get("cache", {}))
            assert list(got_leaves) == list(want_leaves)
            for key, t in got_leaves.items():
                w = want_leaves[key]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(w.shape), (arch, shape.name, key)
                assert str(t.dtype).split(".")[-1] == str(w.dtype), (arch, shape.name, key)
            if shape.kind == "decode":
                cache = want["cache"]
                ref_bytes = n * 2 + sum(float(np.prod(s.shape)) * s.dtype.itemsize
                                        for s in jax.tree_util.tree_leaves(cache))
                assert DR.model_bytes(cfg, shape.name, n) == ref_bytes


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b", "mamba2-780m"])
def test_slot0_state_bytes_follow_reference_pspecs(arch):
    """Slot 0's parameter + AdamW bytes on (16, 16): each leaf's bytes
    divided by the mesh axes the reference's ``param_pspecs`` split it over."""
    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models.params import param_pspecs as ref_pspecs
    import jax
    cfg = get_config(arch)
    sizes = {"data": 16, "model": 16}
    infos = RefModel(ref_config(arch)).infos()
    specs = ref_pspecs(infos, sizes)
    leaves = jax.tree_util.tree_leaves(infos, is_leaf=lambda x: hasattr(x, "logical"))
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    want = 0
    for info, sp in zip(leaves, spec_leaves):
        split = 1
        for e in sp:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                split *= sizes[a]
        numel = int(np.prod(info.shape)) // split
        want += numel * (np.dtype(info.dtype).itemsize if info.dtype != "bfloat16" else 2)
        want += 2 * 4 * numel
    got = DR.argument_bytes(cfg, "train_4k", meta_mesh((16, 16)))
    batch = (256 // 16) * 4097 * 4
    assert sum(got) - 4 - batch == want


# ----------------------------------------------------------------------
# counting on meta
# ----------------------------------------------------------------------
TINY_TRAIN = ShapeConfig("tiny_train", 32, 8, "train")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_two_point_count_equals_full_depth(arch):
    cfg = get_config(arch, smoke=True)
    per = cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    cfg = cfg.replace(num_layers=3 * per)
    mesh = meta_mesh((1, 2))
    flops, byts, coll, _ = DR.measure_scaled_cost(cfg, TINY_TRAIN, mesh, 16)
    direct, _ = DR.lower_cell(cfg, TINY_TRAIN, mesh, 16)
    assert flops == pytest.approx(direct.flops_per_device, rel=1e-9)
    assert byts == pytest.approx(direct.bytes_per_device, rel=1e-9)
    assert coll == {k: int(v) for k, v in direct.coll_per_device.items()}
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0


def test_forward_counts_equal_on_cpu_and_meta_and_over_slots():
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = Model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32)
    real = model.init(torch.Generator().manual_seed(0), "cpu")
    with RL.CostCounter() as on_cpu, torch.no_grad():
        model.forward(real, {"tokens": tokens})
    abstract, meta_tokens = model.abstract(), tokens.to("meta")
    with RL.CostCounter() as on_meta, torch.no_grad():
        model.forward(abstract, {"tokens": meta_tokens})
    assert on_cpu.flops == on_meta.flops > 0
    assert on_cpu.bytes == on_meta.bytes > 0
    mesh = meta_mesh((2, 2))
    mm = Model(cfg, mesh=mesh)
    pieces = mm.param_layout().shard(mm.abstract())
    with RL.CostCounter(mesh.size) as on_mesh, torch.no_grad():
        mm.forward(pieces, {"tokens": meta_tokens})
    assert on_mesh.flops == on_meta.flops
    assert on_mesh.coll["all-reduce"] > 0


def test_psum_counts_its_result_bytes_and_no_op_bytes():
    from repro_torch.distributed.sharding import all_gather, psum, psum_scatter
    mesh = meta_mesh((1, 4))
    xs = [torch.empty((8, 16), device="meta") for _ in range(4)]
    with RL.CostCounter(4) as c:
        psum(xs, mesh, "model")
    assert c.coll["all-reduce"] == 4 * 8 * 16 * 4 and c.bytes == 0
    with RL.CostCounter(4) as c:
        all_gather(xs, mesh, "model", 1)
        psum_scatter(xs, mesh, "model", 1)
        psum(xs, mesh, "data")                     # a group of one slot moves nothing
    assert c.coll["all-gather"] == 4 * 8 * 64 * 4
    assert c.coll["reduce-scatter"] == 4 * 8 * 4 * 4 and c.coll["all-reduce"] == 0


class _NoAllocation(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op result that is not on ``meta``."""

    def __init__(self):
        super().__init__()
        self.real = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" and t.numel() > 1:
                self.real.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_on_meta_slots_is_ok_and_allocates_nothing(monkeypatch, shape):
    monkeypatch.setattr(DR, "get_config", lambda a: get_config(a, smoke=True))
    monkeypatch.setattr(DR, "make_production_mesh",
                        lambda multi_pod=False, devices=None: meta_mesh((2, 2)))
    with _NoAllocation() as mode:
        res = DR.run_cell("internlm2-1.8b", shape, multi_pod=False, verbose=False)
    assert res["status"] == "ok" and not mode.real
    assert res["num_devices"] == 4 and res["flops_per_device"] > 0
    assert res["memory"]["argument_bytes"] > 0 and res["bottleneck"] in (
        "compute", "memory", "collective")


# ----------------------------------------------------------------------
# the kernels' meta paths
# ----------------------------------------------------------------------
def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    p, cap, n, qn, mp, k = 5, 6, 16, 3, 4, 7
    sp = torch.sort(torch.randint(-1, p, (qn, mp), generator=g, dtype=torch.int32), -1).values
    store = (r(p, cap, n), r(p, cap), torch.zeros((p, cap), dtype=torch.int32),
             torch.arange(p * cap, dtype=torch.int32).reshape(p, cap))
    rows = qn * mp * cap
    return {
        "paa": (ops.paa, paa_plain, (r(10, 32), 4), paa_work(10, 32, 4)),
        "pivot_rank": (ops.pivot_rank, pivot_rank_plain, (r(10, 16), r(12, 16), 5),
                       pivot_rank_work(10, 16, 12, 5)),
        "pairwise_l2": (ops.pairwise_l2, pairwise_l2_plain, (r(3, 8), r(9, 8)),
                        pairwise_l2_work(3, 9, 8)),
        "qdots": (ops.qdots, qdots_plain, (r(3, 8), r(3, 9, 8)), qdots_work(3, 9, 8)),
        "refine_topk": (ops.refine_topk, refine_topk_plain,
                        (*store, r(qn, n), sp, torch.zeros_like(sp), torch.ones_like(sp), k),
                        refine_topk_work(rows, rows, rows, qn, mp, n, k)),
    }


@pytest.mark.parametrize("name", ["paa", "pivot_rank", "pairwise_l2", "qdots", "refine_topk"])
def test_kernel_meta_path_counts_its_work(name):
    wrapper, plain, args, work = _kernel_cases()[name]
    want = plain(*args)
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    before = ops.launch_counts()
    with RL.CostCounter() as c:
        got = wrapper(*meta_args)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(t.device.type, tuple(t.shape), t.dtype) for t in got] == \
        [("meta", tuple(t.shape), t.dtype) for t in want]
    assert (c.flops, c.bytes) == (work.flops, work.nbytes)
    assert ops.launch_counts() == before                  # no launch on meta
    cpu = wrapper(*args)                                   # a CPU tensor: the plain version
    for a, b in zip(cpu if isinstance(cpu, tuple) else (cpu,), want):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the CLIMBER dry-run
# ----------------------------------------------------------------------
SMALL = ClimberConfig(series_len=64, paa_segments=16, num_pivots=32, prefix_len=4,
                      capacity=100, sample_frac=0.2, max_centroids=32, k=20,
                      candidate_groups=4, adaptive_factor=4)


def test_synthetic_skeleton_is_the_reference_forest():
    ref_cd = ref_module("repro.launch.climber_dryrun")
    forest, trie, onehot = CD.synthetic_skeleton(CD.CFG, num_groups=32, sample=3000,
                                                device="cpu")
    r_forest, _, r_onehot = ref_cd.synthetic_skeleton(ref_cd.CFG, num_groups=32,
                                                      sample=3000)
    assert forest.num_partitions == r_forest.num_partitions > 0
    for f in ("edge_key", "edge_child", "child_start", "node_size", "node_depth",
              "dfs_in", "dfs_out", "part_start", "part_ids", "group_root",
              "group_default_part"):
        np.testing.assert_array_equal(np.asarray(getattr(forest, f)),
                                      np.asarray(getattr(r_forest, f)), err_msg=f)
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(r_onehot))
    assert trie.num_partitions == forest.num_partitions


def _walks(n, length, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, length)), axis=1).astype(np.float32)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    return torch.from_numpy(x)


def test_build_step_on_four_slots_equals_one_device():
    from repro_torch.core.index import _route_full_dataset
    skeleton = CD.synthetic_skeleton(SMALL, num_groups=16, sample=2000, device="cpu")
    data = _walks(4002, SMALL.series_len, 1)
    pivots = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (SMALL.num_pivots, SMALL.paa_segments)).astype(np.float32))
    blocks = [data[slice(*CD.slot_rows(len(data), 4, d))] for d in range(4)]
    outs = CD.build_step(blocks, pivots, skeleton, SMALL)
    part, dfs = _route_full_dataset(data, pivots, skeleton[2], skeleton[1], SMALL)
    assert torch.equal(torch.cat([o[0] for o in outs]), part)
    assert torch.equal(torch.cat([o[1] for o in outs]), dfs)
    with RL.CostCounter(4) as c:
        CD.build_step([b.to("meta") for b in blocks], pivots.to("meta"),
                      CD.synthetic_skeleton(SMALL, num_groups=16, sample=2000), SMALL)
    assert sum(c.coll.values()) == 0 and c.flops > 0


def test_query_step_on_four_slots_equals_one_device():
    from repro_torch.core.index import build_index
    from repro_torch.core.query import compact_plan, plan_adaptive
    from repro_torch.core.refine import refine
    data = _walks(3000, SMALL.series_len, 3)
    index = build_index(data, SMALL, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    q = data[::300][:10] + 0.01
    d4, g4 = CD.query_step(index, q, make_mesh(4, ["cpu"] * 4))
    p4r, _ = index.featurize(q)
    plan = compact_plan(plan_adaptive(index, p4r), CD.PLAN_SLOTS)
    d1, g1 = refine(index.store, q, plan.sel_part, plan.sel_lo, plan.sel_hi, SMALL.k)
    assert torch.equal(g4, g1)
    tol = 1e-5 * ((q * q).sum(-1, keepdim=True) + index.store.norms.max())
    assert bool(((d4.double() ** 2 - d1.double() ** 2).abs() <= tol).all())


def test_climber_run_counts_on_meta_slots(monkeypatch):
    monkeypatch.setattr(CD, "production_mesh", lambda multi_pod, device="meta":
                        meta_mesh((2, 4)))
    build = CD.run("build", False, n_series=8 * 1000, skeleton_sample=2000)
    query = CD.run("query", False, n_series=8 * 3 * CD.CFG.capacity, n_queries=4,
                   skeleton_sample=2000)
    assert build["status"] == query["status"] == "ok"
    assert build["coll_bytes_per_device"] == 0
    # the 8 slots' [4, k] (d², gid) lists gathered once, on the lead
    assert query["coll_breakdown"]["all-gather"] == 8 * 4 * CD.CFG.k * 8 // 8
    kernels = paa_work(1000, 256, 16).flops + pivot_rank_work(1000, 16, 200, 10).flops
    assert build["flops_per_device"] > kernels
    rows = 4 * CD.PLAN_SLOTS * CD.CFG.capacity
    assert query["flops_per_device"] >= refine_topk_work(rows, rows, rows, 4, CD.PLAN_SLOTS,
                                                         256, CD.CFG.k).flops
