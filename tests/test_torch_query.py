"""Query parity: plans, ``knn_query`` and the serving engine of the port
against the JAX package, over one reference index carried across with
``index_from_arrays`` (sizes of ``small_index`` in
``tests/test_query_engine.py``).

Plans and gids are exact; squared distances agree to
1e-5·(‖q‖² + ‖x‖²) — a self-match's near-zero distance comes out of
different summation orders (ROADMAP queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import candidates_scanned as j_candidates_scanned  # noqa: E402
from repro.core import default_slot_budget as j_default_slot_budget  # noqa: E402
from repro.core import knn_query as j_knn_query  # noqa: E402
from repro.core import merge_topk as j_merge_topk  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.distributed.store import store_to_arrays  # noqa: E402
from repro.fleet.lifecycle.snapshot import _FOREST_ARRAYS  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core.index import index_from_arrays  # noqa: E402
from repro_torch.core.refine import PAD_DIST, dispatch_refine, merge_topk, refine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.serve import ClimberEngine, QueryRequest, ServingConfig  # noqa: E402
from repro_torch.utils.config import ClimberConfig as TConfig  # noqa: E402

CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=10,
           candidate_groups=4, adaptive_factor=4)
VARIANTS = ["knn", "adaptive", "od_smallest", "exhaustive"]
TOL = 1e-5 * 2 * CFG["series_len"]      # ‖q‖² = ‖x‖² = n for z-normalised rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=-1)
    return ((x - x.mean(-1, keepdims=True))
            / (x.std(-1, keepdims=True) + 1e-8)).astype(np.float32)


@pytest.fixture(scope="module")
def indexes():
    data = random_walks(0, 3000, CFG["series_len"])
    ref = j_build_index(jax.random.PRNGKey(1), jnp.asarray(data), JConfig(**CFG))
    arrays = store_to_arrays(ref.store)
    arrays["pivots"] = np.asarray(ref.pivots)
    arrays["centroid_onehot"] = np.asarray(ref.centroid_onehot)
    for name in _FOREST_ARRAYS:
        arrays["forest_" + name] = np.asarray(getattr(ref.forest, name))
    port = index_from_arrays(arrays, TConfig(**CFG), device="cpu")
    rng = np.random.default_rng(2)
    queries = data[rng.choice(len(data), 11, replace=False)]
    # a few perturbed queries too, so not every answer starts at a self-match
    queries[6:] += 0.3 * rng.standard_normal(queries[6:].shape).astype(np.float32)
    return ref, port, queries


@pytest.mark.parametrize("variant", VARIANTS)
def test_plans_equal(indexes, variant):
    ref, port, queries = indexes
    p4r_j, _ = ref.featurize(jnp.asarray(queries))
    p4r_t, _ = port.featurize(torch.as_tensor(queries))
    np.testing.assert_array_equal(p4r_t.numpy(), np.asarray(p4r_j))
    qp_j = j_plan(ref, p4r_j, variant=variant)
    qp_t = tq.plan(port, p4r_t, variant=variant)
    for field in ("sel_part", "sel_lo", "sel_hi", "node", "pathlen"):
        np.testing.assert_array_equal(getattr(qp_t, field).numpy(),
                                      np.asarray(getattr(qp_j, field)), err_msg=field)
    np.testing.assert_array_equal(qp_t.partitions_touched().numpy(),
                                  np.asarray(qp_j.partitions_touched()))
    np.testing.assert_array_equal(
        tq.candidates_scanned(qp_t, port.store).numpy(),
        np.asarray(j_candidates_scanned(qp_j, ref.store)))
    assert tq.default_slot_budget(port, variant) == \
        j_default_slot_budget(ref, variant)


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_knn_query_equal(indexes, variant, use_kernel):
    ref, port, queries = indexes
    d_j, g_j, _ = j_knn_query(ref, jnp.asarray(queries), 10, variant=variant)
    d_t, g_t, _ = tq.knn_query(port, torch.as_tensor(queries), 10, variant=variant,
                               use_kernel=use_kernel)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert np.all(np.abs(d_t.numpy() ** 2 - np.asarray(d_j) ** 2) <= TOL)
    assert (np.diff(d_t.numpy(), axis=1) >= 0).all()


def test_knn_query_pads_past_the_pool(indexes):
    ref, port, queries = indexes
    d_t, g_t, _ = tq.knn_query(port, torch.as_tensor(queries[:2]), 400, variant="knn")
    d_j, g_j, _ = j_knn_query(ref, jnp.asarray(queries[:2]), 400, variant="knn")
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert (g_t[:, -1] == -1).all() and float(d_t[0, -1]) == pytest.approx(PAD_DIST)


@pytest.mark.parametrize("variant", ["knn", "adaptive", "od_smallest"])
def test_engine_equals_per_query_knn_query(indexes, variant):
    ref, port, queries = indexes
    engine = ClimberEngine(port, batch_size=4, variant=variant, k=10)
    dist, gid, metrics = engine.run(queries)
    assert len(metrics) == len(queries)
    for i in range(len(queries)):
        d1, g1, _ = tq.knn_query(port, torch.as_tensor(queries[i:i + 1]), 10,
                                 variant=variant)
        np.testing.assert_array_equal(g1.numpy()[0], gid[i])
        np.testing.assert_array_equal(d1.numpy()[0], dist[i])
    _, g_j, _ = j_knn_query(ref, jnp.asarray(queries), 10, variant=variant)
    np.testing.assert_array_equal(gid, np.asarray(g_j))


def test_engine_queue_cache_and_config(indexes):
    _, port, queries = indexes
    engine = ClimberEngine(port, config=ServingConfig(batch_size=4, k=10))
    tickets = [engine.submit_request(QueryRequest(series=q, request_id=i, k=5))
               for i, q in enumerate(queries)]
    engine.run_until_drained()
    assert all(t.ok for t in tickets) and not engine.queue
    assert engine.stats.ticks == 3 and engine.stats.queries == len(queries)
    d, g, _ = engine.run(queries)
    for i, t in enumerate(tickets):
        assert t.result.request_id == i
        np.testing.assert_array_equal(t.result.gid, g[i, :5])
    assert engine.stats.plan_cache_hits >= len(queries)   # second pass hits
    snap = engine.stats.snapshot()
    assert snap["queries_per_sec"] > 0 and snap["plan_s"] >= 0
    with pytest.raises(ValueError):
        engine.submit_request(QueryRequest(series=queries[0][:10]))
    with pytest.raises(ValueError):
        engine.run(queries, k=11)
    with pytest.raises(TypeError):
        ClimberEngine(port, config=ServingConfig(), batch_size=3)
    with pytest.raises(TypeError, match="not a mesh"):
        ClimberEngine(port, mesh=object())
    # on a mesh of two slots the engine answers as on one device
    one = ClimberEngine(port, batch_size=4, k=10).run(queries)
    two = ClimberEngine(port, batch_size=4, k=10, mesh=["cpu", "cpu"]).run(queries)
    np.testing.assert_array_equal(two[1], one[1])
    np.testing.assert_array_equal(two[0], one[0])


def test_engine_without_plan_cache_matches(indexes):
    _, port, queries = indexes
    a = ClimberEngine(port, batch_size=3, k=10, plan_cache_size=0).run(queries)
    b = ClimberEngine(port, batch_size=5, k=10).run(queries)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_no_kernel_launch_on_the_cpu(indexes):
    _, port, queries = indexes
    before = ops.launch_counts()
    tq.knn_query(port, torch.as_tensor(queries), 10)
    assert ops.launch_counts() == before


def test_planner_registry(indexes):
    _, port, queries = indexes
    assert set(VARIANTS) <= set(tq.planner_names())
    with pytest.raises(KeyError):
        tq.get_planner("nope")
    tq.register_planner("knn_alias", tq.plan_knn)
    try:
        p4r, _ = port.featurize(torch.as_tensor(queries))
        a = tq.plan(port, p4r, variant="knn_alias")
        b = tq.plan(port, p4r, variant="knn")
        assert torch.equal(a.sel_part, b.sel_part)
        assert tq.default_slot_budget(port, "knn_alias") is None
    finally:
        tq._PLANNERS.pop("knn_alias")


def test_compact_plan_is_lossless_at_budget(indexes):
    _, port, queries = indexes
    p4r, _ = port.featurize(torch.as_tensor(queries))
    raw = tq.plan_adaptive(port, p4r)
    small = tq.compact_plan(raw, tq.default_slot_budget(port, "adaptive"))
    assert torch.equal(raw.partitions_touched(), small.partitions_touched())
    live = (raw.sel_part >= 0).sum(-1)
    assert torch.equal(live, (small.sel_part >= 0).sum(-1))


def test_dispatch_refine_refuses_a_mesh(indexes):
    """``dispatch_refine`` refuses what is not a mesh; on a one-device mesh
    it is ``refine``."""
    _, port, queries = indexes
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="not a mesh"):
        dispatch_refine(port.store, torch.as_tensor(queries[:1]), z, z, z, 5,
                        mesh=object())
    q = torch.as_tensor(queries)
    qp = tq.plan(port, port.featurize(q)[0], variant="adaptive")
    args = (port.store, q, qp.sel_part, qp.sel_lo, qp.sel_hi, 10)
    want = refine(*args)
    for mesh in (["cpu"], make_mesh(1, ["cpu"])):
        got = dispatch_refine(*args, mesh=mesh)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


MERGE_CASES = {
    "disjoint": ([[1.0, 3.0]], [[10, 11]], [[2.0, PAD_DIST]], [[20, -1]], 3, False),
    "ties_prefer_a": ([[1.0, 2.0]], [[1, 2]], [[1.0, 2.0]], [[3, 4]], 3, False),
    "k_beyond_inputs": ([[0.5]], [[7]], [[0.25]], [[8]], 4, False),
    "dedupe": ([[1.0, 2.0, 5.0]], [[1, 2, 3]], [[1.5, 2.0, 0.5]], [[2, 1, 9]], 4, True),
}


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_topk_matches_reference(name):
    da, ga, db, gb, k, dedupe = MERGE_CASES[name]
    d_j, g_j = j_merge_topk(jnp.asarray(da, jnp.float32), jnp.asarray(ga),
                            jnp.asarray(db, jnp.float32), jnp.asarray(gb), k,
                            dedupe=dedupe)
    d_t, g_t = merge_topk(torch.tensor(da), torch.tensor(ga), torch.tensor(db),
                          torch.tensor(gb), k, dedupe=dedupe)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
