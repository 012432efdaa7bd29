"""Fleet parity: the port's ``repro_torch.fleet`` against ``repro.fleet``.

Both fleets are built from the same numpy data at the reference's
``small_cfg()`` size (``tests/test_fleet.py``: n=64, 3 × 800 series, K=10),
the port with a draw hook that replays the reference's
``jax.random.fold_in(PRNGKey(seed), fold)`` draws, so the two fleets hold
the same shards.  The reference answers at ``placement="host"`` (its own
mesh bit-identity tests fail under jax 0.9.0, ROADMAP queue 3).

Gids are exact; squared distances agree within 1e-5·(‖q‖² + ‖x‖²) — a
self-match's near-zero distance comes out of different summation orders
(ROADMAP queue 3).  Inside the port, host and mesh placement agree bit for
bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.distributed import store as j_store  # noqa: E402
from repro.core.traversal import pad_trie as j_pad_trie  # noqa: E402
from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import IndexFleet as JIndexFleet  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import index as t_index  # noqa: E402
from repro_torch.core import query as t_query  # noqa: E402
from repro_torch.core.query import (ShardPlanContext, get_device_planner,  # noqa: E402
                                    knn_query, plan)
from repro_torch.distributed import store as t_store  # noqa: E402
from repro_torch.core.traversal import descend, pad_trie  # noqa: E402
from repro_torch.fleet import (FleetConfig, FleetDraws, FleetEngine,  # noqa: E402
                               IndexFleet)
from repro_torch.fleet.device_plan import (ShardView, descend_stacked,  # noqa: E402
                                           stack_tries, trie_row)
from repro_torch.utils.config import ClimberConfig  # noqa: E402

K = 10
CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=K,
           candidate_groups=4, adaptive_factor=4)
TOL = 1e-5 * 2 * CFG["series_len"]      # ‖q‖² = ‖x‖² = n for z-normalised rows
ROUTINGS = ["signature", "adaptive", "exhaustive"]
VARIANTS = ["adaptive", "exhaustive"]


class JaxDraws(FleetDraws):
    """Replays the reference fleet's draws: ``fold_in(PRNGKey(seed), fold)``
    split as ``repro.core.index.build_index`` splits it, and the router's
    ``select_pivots_random(PRNGKey(seed), ...)``."""

    def build(self, seed, fold, n_rec, cfg):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        k_sample, k_pivot, _ = jax.random.split(key, 3)
        s = t_index.sample_size(n_rec, cfg)
        return (np.array(jax.random.choice(k_sample, n_rec, shape=(s,), replace=False)),
                np.array(jax.random.choice(k_pivot, s, shape=(cfg.num_pivots,),
                                           replace=False)))

    def router(self, seed, n_sample, r):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n_sample,
                                          shape=(r,), replace=False))


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


def port_fleet(**kw):
    fc = dict(shard_cfg=ClimberConfig(**CFG), fanout=2, delta_capacity=4096,
              auto_compact=False)
    fc.update(kw)
    return IndexFleet(FleetConfig(**fc), device="cpu", mesh=["cpu"], draws=JaxDraws())


@pytest.fixture(scope="module")
def fleets():
    data = random_walks(0, 2400, CFG["series_len"])
    rng = np.random.default_rng(2)
    queries = data[rng.choice(len(data), 7, replace=False)]
    queries[3:] += 0.3 * rng.standard_normal(queries[3:].shape).astype(np.float32)
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=2,
                                   delta_capacity=4096, auto_compact=False))
    port = port_fleet()
    for i in range(3):
        ref.add_shard(f"tenant{i}", data[i * 800:(i + 1) * 800])
        port.add_shard(f"tenant{i}", data[i * 800:(i + 1) * 800])
    return ref, port, data, queries


@pytest.fixture(scope="module")
def reference_answers(fleets):
    ref, _, _, queries = fleets
    return {(r, v): ref.query(queries, K, routing=r, variant=v, placement="host")
            for r in ROUTINGS for v in VARIANTS}


def test_shards_equal_reference(fleets):
    ref, port, _, _ = fleets
    for js, ts in zip(ref.shards, port.shards):
        assert js.key == ts.key
        np.testing.assert_array_equal(ts.global_ids, js.global_ids)
        for name in js.index.store._fields:
            np.testing.assert_array_equal(getattr(ts.index.store, name).numpy(),
                                          np.asarray(getattr(js.index.store, name)))


def test_router_scores_and_routes_equal(fleets):
    ref, port, _, queries = fleets
    np.testing.assert_array_equal(port.router.pivots.numpy(),
                                  np.asarray(ref.router.pivots))
    for js, ts in zip(ref.router._summaries, port.router._summaries):
        np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(port.router.score(queries), ref.router.score(queries))
    for fanout in (1, 2, 3):
        np.testing.assert_array_equal(port.router.route(queries, fanout),
                                      ref.router.route(queries, fanout))
    for th in (0.0, 0.5, 0.85, 1.0):
        np.testing.assert_array_equal(port.router.route_adaptive(queries, th),
                                      ref.router.route_adaptive(queries, th))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_answers_match_reference(fleets, reference_answers, routing, variant):
    _, port, _, queries = fleets
    dj, gj, ij = reference_answers[routing, variant]
    dt, gt, it = port.query(queries, K, routing=routing, variant=variant,
                            placement="host")
    np.testing.assert_array_equal(gt, gj)
    assert np.abs(dt.astype(np.float64) ** 2 - np.asarray(dj, np.float64) ** 2).max() <= TOL
    np.testing.assert_array_equal(it.routed_mask, ij.routed_mask)
    np.testing.assert_array_equal(it.partitions_touched, ij.partitions_touched)
    np.testing.assert_array_equal(it.candidates_scanned, ij.candidates_scanned)


@pytest.mark.parametrize("variant", ["knn", "adaptive", "od_smallest", "exhaustive"])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_host_equals_mesh_bit_for_bit(fleets, routing, variant):
    _, port, _, queries = fleets
    dh, gh, ih = port.query(queries, K, routing=routing, variant=variant,
                            placement="host")
    for _ in range(2):                    # the stacked pass, then its cache hit
        dm, gm, im = port.query(queries, K, routing=routing, variant=variant,
                                placement="mesh")
        np.testing.assert_array_equal(gm, gh)
        np.testing.assert_array_equal(dm, dh)
        np.testing.assert_array_equal(im.partitions_touched, ih.partitions_touched)
        np.testing.assert_array_equal(im.candidates_scanned, ih.candidates_scanned)
    assert im.plan_cache_hits == len(queries)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_host_only_planner_on_mesh_equals_host(fleets, monkeypatch, routing):
    """A planner registered without a device variant plans on the host and
    refines through the stacked placement's refine-only pass, bit-equal to
    the host loop."""
    _, port, _, queries = fleets
    monkeypatch.setitem(t_query._PLANNERS, "host_only_knn", t_query.get_planner("knn"))
    assert t_query.get_device_planner("host_only_knn") is None
    dh, gh, ih = port.query(queries, K, routing=routing, variant="host_only_knn",
                            placement="host")
    dm, gm, im = port.query(queries, K, routing=routing, variant="host_only_knn",
                            placement="mesh")
    assert not port._placement.supports_device_planning("host_only_knn")
    np.testing.assert_array_equal(gm, gh)
    np.testing.assert_array_equal(dm, dh)
    np.testing.assert_array_equal(im.partitions_touched, ih.partitions_touched)
    np.testing.assert_array_equal(im.candidates_scanned, ih.candidates_scanned)
    dk, gk, _ = port.query(queries, K, routing=routing, variant="knn", placement="host")
    np.testing.assert_array_equal(gh, gk)
    np.testing.assert_array_equal(dh, dk)


def test_exhaustive_fleet_equals_union_index(fleets):
    _, port, data, queries = fleets
    draws = JaxDraws().build(0, 1, len(data), ClimberConfig(**CFG))
    union = t_index.build_index(torch.as_tensor(data), ClimberConfig(**CFG),
                                device="cpu", sample_idx=draws[0], pivot_idx=draws[1])
    du, gu, _ = knn_query(union, torch.as_tensor(queries), K, variant="exhaustive")
    df, gf, _ = port.query(queries, K, routing="exhaustive", variant="exhaustive")
    np.testing.assert_array_equal(gf, gu.numpy())
    np.testing.assert_array_equal(df, du.numpy())
    ds, gs = port.scan_exact(queries, K)
    np.testing.assert_array_equal(gs, gf)
    np.testing.assert_array_equal(ds, df)


def test_device_planners_equal_host_planners(fleets):
    """Each registered device planner, over the stacked (padded) skeleton
    with its ShardPlanContext, yields the host plan's live entries in the
    host order."""
    _, port, _, queries = fleets
    port.query(queries[:1], K, placement="mesh")
    pl = port._placement
    q = torch.as_tensor(queries)
    for variant in ("knn", "adaptive", "od_smallest", "exhaustive"):
        b = pl.plan_width(variant)
        for j, shard in enumerate(port.shards):
            p4r, _ = shard.index.featurize(q)
            host = plan(shard.index, p4r, variant=variant)
            view = ShardView(pl.cfg, pl.centroids[j], trie_row(
                pl.tables, j, num_pivots=pl.cfg.num_pivots, num_partitions=pl._p_static))
            ctx = ShardPlanContext(pl._g_real[j], pl._t_real[j], pl._p_real[j],
                                   pl._t_static, pl._p_static)
            dev = get_device_planner(variant)(view, p4r, ctx)
            assert host.sel_part.shape[-1] <= b
            np.testing.assert_array_equal(dev.node.numpy(), host.node.numpy())
            np.testing.assert_array_equal(dev.pathlen.numpy(), host.pathlen.numpy())
            for row in range(len(queries)):
                live_h, live_d = host.sel_part[row] >= 0, dev.sel_part[row] >= 0
                for a, c in ((host.sel_part, dev.sel_part), (host.sel_lo, dev.sel_lo),
                             (host.sel_hi, dev.sel_hi)):
                    np.testing.assert_array_equal(c[row][live_d].numpy(),
                                                  a[row][live_h].numpy())


def test_pad_shards_and_pad_rows_inert(fleets):
    _, port, _, queries = fleets
    tries = [s.index.trie for s in port.shards]
    tables = stack_tries(tries, pad_to=len(tries) + 2)
    r = CFG["num_pivots"]
    q = torch.as_tensor(queries)
    p4 = torch.stack([s.index.featurize(q)[0] for s in port.shards]
                     + [port.shards[0].index.featurize(q)[0]] * 2)
    grp = torch.zeros((tables.num_slots, len(queries)), dtype=torch.long)
    node, pathlen, parent = descend_stacked(tables, p4, grp, num_pivots=r)
    for s, trie in enumerate(tries):                 # padded rows ≡ the real trie
        n0, l0, p0 = descend(trie, p4[s], grp[s])
        np.testing.assert_array_equal(node[s].numpy(), n0.numpy())
        np.testing.assert_array_equal(pathlen[s].numpy(), l0.numpy())
        np.testing.assert_array_equal(parent[s].numpy(), p0.numpy())
    inert = tables.has_children.shape[1] - 1
    assert (node[len(tries):] == inert).all() and (pathlen[len(tries):] == 0).all()
    # a pad shard plans nothing under every device planner
    view = ShardView(port.cfg.shard_cfg, torch.zeros((tables.group_root.shape[1], r)),
                     trie_row(tables, len(tries), num_pivots=r))
    ctx = ShardPlanContext(1, 1, 0, 1, 8)
    for variant in ("knn", "adaptive", "od_smallest", "exhaustive"):
        qp = get_device_planner(variant)(view, p4[0], ctx)
        assert (qp.sel_part == -1).all()
    # pad groups of a padded trie descend to the inert node
    t0 = tries[0]
    g = int(t0.group_root.shape[0])
    padded = pad_trie(t0, num_nodes=int(t0.has_children.shape[0]) + 3,
                      num_edges=int(t0.edge_key.shape[0]) + 5,
                      max_parts=int(t0.part_ids_pad.shape[1]) + 2, num_groups=g + 2)
    n_pad, l_pad, _ = descend(padded, p4[0], torch.full((len(queries),), g + 1))
    assert (n_pad == padded.has_children.shape[0] - 1).all() and (l_pad == 0).all()


def test_layouts_equal_reference(fleets):
    """stack_stores, concat_stores and pad_trie give the reference's arrays."""
    ref, port, _, _ = fleets
    gmaps = [s.global_ids for s in ref.shards]
    for j_fn, t_fn in ((j_store.stack_stores, t_store.stack_stores),
                       (j_store.concat_stores, t_store.concat_stores)):
        a = j_fn([s.index.store for s in ref.shards], gmaps)
        b = t_fn([s.index.store for s in port.shards], gmaps)
        for name in a._fields:
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)))
    a = j_store.pad_store(ref.shards[0].index.store, 8)
    b = t_store.pad_store(port.shards[0].index.store, 8)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)))
    jt, tt = ref.shards[1].index.trie, port.shards[1].index.trie
    dims = dict(num_nodes=int(tt.has_children.shape[0]) + 4,
                num_edges=int(tt.edge_key.shape[0]) + 3,
                max_parts=int(tt.part_ids_pad.shape[1]) + 1,
                num_groups=int(tt.group_root.shape[0]) + 2)
    jp, tp = j_pad_trie(jt, **dims), pad_trie(tt, **dims)
    for name in tp._fields[:11]:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)).astype(
                                          getattr(tp, name).numpy().dtype))


def test_compact_leaves_answers_unchanged():
    data = random_walks(3, 1600, CFG["series_len"])
    fleet = port_fleet()
    fleet.add_shard("t0", data[:800])
    fleet.add_shard("t1", data[800:])
    batch = random_walks(6, 120, CFG["series_len"])
    fleet.insert(batch)
    queries = batch[:5] + 0.1 * random_walks(7, 5, CFG["series_len"])
    before = [fleet.query(queries, K, routing="exhaustive", variant="exhaustive",
                          placement=p) for p in ("host", "mesh")]
    handle = fleet.compact()
    assert handle is not None and fleet.delta.occupancy == 0
    assert fleet.stats.compactions == 1
    for p, (d1, g1, _) in zip(("host", "mesh"), before):
        d2, g2, _ = fleet.query(queries, K, routing="exhaustive",
                                variant="exhaustive", placement=p)
        np.testing.assert_array_equal(g2, g1)
        np.testing.assert_array_equal(d2, d1)
    assert fleet.compact() is None


def test_inserts_land_through_assignment_path():
    """Inserts into the delta: the first batch builds its index, the next
    scatters in place; the delta store equals the reference's array for
    array, and inserted rows are visible at once."""
    shard = random_walks(3, 800, CFG["series_len"])
    batch = random_walks(5, 100, CFG["series_len"])
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=2,
                                   delta_capacity=4096, auto_compact=False))
    port = port_fleet()
    for f in (ref, port):
        f.add_shard("t0", shard)
        f.insert(batch)
        f.insert(batch[:30] * 1.1)
    assert port.delta.rebuilds == ref.delta.rebuilds == 1      # one scatter
    assert port.delta.occupancy == 130
    js, ts = ref.delta.index.store, port.delta.index.store
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    d, g, _ = port.query(batch[:2] * 1.1, K, routing="exhaustive", variant="exhaustive")
    assert g[0, 0] == 900 and g[1, 0] == 901 and d[0, 0] < 1e-2


def test_delta_rebuilds_as_the_reference():
    """A batch that overflows a delta partition rebuilds the delta in both
    packages alike: the first batches scatter in place, later ones rebuild,
    batch for batch the same, and the stores end equal."""
    shard = random_walks(3, 800, CFG["series_len"])
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=2,
                                   delta_capacity=4096, auto_compact=False))
    port = port_fleet()
    history = []
    for f in (ref, port):
        f.add_shard("t0", shard)
    for b in range(6):
        batch = random_walks(20 + b, 64, CFG["series_len"])
        for f in (ref, port):
            f.insert(batch)
        history.append((port.delta.rebuilds, ref.delta.rebuilds))
    assert [p for p, _ in history] == [r for _, r in history]
    assert history[2][0] == 1 and history[-1][0] > 2     # scatters, then rebuilds
    js, ts = ref.delta.index.store, port.delta.index.store
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


def test_fleet_engine_equals_query(fleets):
    _, port, _, queries = fleets
    for placement in ("host", "mesh"):
        eng = FleetEngine(port, batch_size=4, k=K, routing="signature",
                          variant="adaptive", placement=placement)
        dist, gid, metrics = eng.run(queries)
        df, gf, info = port.query(queries, K, placement=placement)
        np.testing.assert_array_equal(gid, gf)
        np.testing.assert_array_equal(dist, df)
        assert [m.partitions_touched for m in metrics] == info.partitions_touched.tolist()
    eng = FleetEngine(port, sentinel_rate=0.1)       # the sentinel is ported
    assert port.sentinel is eng.sentinel and eng.sentinel.sample_rate == 0.1
    port.sentinel = None                             # the fixture is shared
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.attach_mesh(["cpu", "cpu"])
