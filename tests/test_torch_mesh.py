"""The port's device mesh: sharded refine, sharded Dss, the D-slot fleet
placement, sharded ``scan_exact`` and the sharded serving engine.

The port drives a mesh from one process as a list of torch devices
(``repro_torch.launch.DeviceMesh``); repeated devices are allowed, so
``["cpu"] * D`` runs the same code as D cards.  Inside the port every mesh
answer equals the one-device answer bit for bit.  Against the JAX package,
the port's sharded refine is held to the reference's single-device
``refine`` on the store of ``tests/test_query_engine.py``'s sharded-refine
test: gids exact, distances within 1e-5·(‖q‖² + ‖x‖²) (ROADMAP queue 3;
the reference's own mesh runs fail under jax 0.9.0).  JAX is imported in a
fixture, so the ``cuda``-marked tests also run on a machine without it:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.baselines.dss import exact_knn, exact_knn_sharded  # noqa: E402
from repro_torch.core.index import PartitionStore, build_index  # noqa: E402
from repro_torch.core.refine import (PAD_DIST, dispatch_refine, refine,  # noqa: E402
                                     refine_sharded)
from repro_torch.distributed.store import shard_store  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetEngine, IndexFleet  # noqa: E402
from repro_torch.launch import DeviceMesh, make_mesh  # noqa: E402
from repro_torch.serve import ClimberEngine  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

K = 10
CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=K,
           candidate_groups=4, adaptive_factor=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's store, refine and layout helpers (CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.index import PartitionStore as JStore
    from repro.core.refine import refine as j_refine
    from repro.distributed import store as j_store
    return jnp, JStore, j_refine, j_store


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cpu_mesh(d):
    return make_mesh(d, ["cpu"] * d)


def random_walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=-1)
    return ((x - x.mean(-1, keepdims=True))
            / (x.std(-1, keepdims=True) + 1e-8)).astype(np.float32)


def synthetic_store(p, seed=0):
    """The ragged store and random plan of the reference's sharded-refine
    test (``tests/test_query_engine.py``: cap 12, n 32, Q 5, MP 9, k 7)."""
    rng = np.random.default_rng(seed)
    cap, n, qn, mp = 12, 32, 5, 9
    data = rng.normal(size=(p, cap, n)).astype(np.float32)
    gid = np.arange(p * cap, dtype=np.int32).reshape(p, cap)
    gid[rng.random((p, cap)) < 0.25] = -1
    dfs = rng.integers(0, 50, size=(p, cap)).astype(np.int32)
    arrays = dict(data=data, norms=(data ** 2).sum(-1), rec_dfs=dfs,
                  rec_gid=gid, count=(gid >= 0).sum(1).astype(np.int32))
    q = rng.normal(size=(qn, n)).astype(np.float32)
    sp = rng.integers(-1, p, size=(qn, mp)).astype(np.int32)
    lo = rng.integers(0, 40, size=(qn, mp)).astype(np.int32)
    hi = (lo + rng.integers(0, 30, size=(qn, mp))).astype(np.int32)
    return arrays, q, sp, lo, hi


def t_store(arrays):
    return PartitionStore(*(torch.as_tensor(arrays[f])
                            for f in PartitionStore._fields))


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# ---------------------------------------------------------------------------
# mesh construction and store layout
# ---------------------------------------------------------------------------
def test_make_mesh_raises_without_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(2)
    mesh = make_mesh(3, ["cpu"] * 3)
    assert mesh.shape == {"data": 3} and mesh.lead == torch.device("cpu")
    assert DeviceMesh(["cuda"]).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError):
        make_mesh(2, ["cpu"])


@pytest.mark.parametrize("d", [2, 3, 4])
def test_shard_store_views_and_inert_slots(d):
    arrays, *_ = synthetic_store(7)
    store = t_store(arrays)
    slots = shard_store(store, cpu_mesh(d))
    per = -(-7 // d)
    for i, st in enumerate(slots):
        lo, hi = min(i * per, 7), min((i + 1) * per, 7)
        if hi == lo:                     # no real partition: inert
            assert bool((st.rec_gid < 0).all()) and int(st.count.sum()) == 0
            continue
        assert st.num_partitions == hi - lo
        # a slot on the store's own device holds views, not copies
        assert st.data.data_ptr() == store.data[lo].data_ptr()
        assert torch.equal(st.rec_gid, store.rec_gid[lo:hi])


# ---------------------------------------------------------------------------
# sharded refine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("use_kernel", [False, None])
def test_refine_sharded_equals_refine(d, use_kernel):
    arrays, q, sp, lo, hi = synthetic_store(7)
    store = t_store(arrays)
    args = (torch.as_tensor(q), torch.as_tensor(sp), torch.as_tensor(lo),
            torch.as_tensor(hi), 7)
    one = refine(store, *args, use_kernel=use_kernel)
    assert_same(refine_sharded(store, *args, mesh=cpu_mesh(d),
                               use_kernel=use_kernel), one)
    assert_same(dispatch_refine(store, *args, mesh=cpu_mesh(d)), one)
    slots = shard_store(store, cpu_mesh(d))     # laid out once, reused
    assert_same(refine_sharded(store, *args, mesh=cpu_mesh(d), slots=slots), one)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_one_ulp_pair_across_slots(d):
    """Two records whose d² differ by one ulp and share one square root,
    the larger in the earlier slot: the sharded merge keeps the one-device
    order (d² first), where a merge of square roots would order by slot."""
    a = np.float32(2.0)
    while np.sqrt(a) != np.sqrt(np.nextafter(a, np.float32(4))):
        a = np.nextafter(a, np.float32(4))
    b = np.nextafter(a, np.float32(4))
    p, cap, n = 6, 2, 4
    norms = np.full((p, cap), 50.0, np.float32)
    norms[0, 0] = b                       # slot 0: the larger d²
    norms[p - 1, 0] = a                   # the last slot: the smaller d²
    store = PartitionStore(
        data=torch.zeros((p, cap, n)), norms=torch.as_tensor(norms),
        rec_dfs=torch.zeros((p, cap), dtype=torch.int32),
        rec_gid=torch.arange(p * cap, dtype=torch.int32).reshape(p, cap),
        count=torch.full((p,), cap, dtype=torch.int32))
    q = torch.zeros((1, n))               # d² = the stored norm
    sp = torch.arange(p, dtype=torch.int32)[None]
    lo, hi = torch.zeros_like(sp), torch.ones_like(sp)
    one = refine(store, q, sp, lo, hi, 2)
    assert one[1].tolist() == [[(p - 1) * cap, 0]]
    assert float(one[0][0, 0]) == float(one[0][0, 1])     # one square root
    assert_same(refine_sharded(store, q, sp, lo, hi, 2, mesh=cpu_mesh(d)), one)


@pytest.mark.parametrize("d,p", [(2, 7), (4, 7), (4, 8)])
def test_refine_sharded_against_reference(jref, d, p):
    jnp, JStore, j_refine, _ = jref
    arrays, q, sp, lo, hi = synthetic_store(p)
    ref = JStore(*(jnp.asarray(arrays[f]) for f in JStore._fields))
    dj, gj = j_refine(ref, jnp.asarray(q), jnp.asarray(sp), jnp.asarray(lo),
                      jnp.asarray(hi), 7)
    dt, gt = refine_sharded(t_store(arrays), torch.as_tensor(q),
                            torch.as_tensor(sp), torch.as_tensor(lo),
                            torch.as_tensor(hi), 7, mesh=cpu_mesh(d))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    dj = np.asarray(dj)
    real = np.asarray(gj) >= 0
    tol = 1e-5 * ((q ** 2).sum(-1)[:, None] + (arrays["data"] ** 2).sum(-1).max())
    np.testing.assert_array_less(np.abs(dt.numpy() ** 2 - dj ** 2)[real],
                                 np.broadcast_to(tol, dj.shape)[real] + 1e-30)
    assert np.all(dt.numpy()[~real] == np.float32(PAD_DIST))


# ---------------------------------------------------------------------------
# sharded Dss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 4])
def test_exact_knn_sharded_equals_exact_knn(d):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(random_walks(4, 1003, 32))
    q = x[rng.choice(1003, 6, replace=False)] + 0.05
    assert_same(exact_knn_sharded(q, x, 20, mesh=cpu_mesh(d)), exact_knn(q, x, 20))
    # slots of fewer rows than k, k capped at N.  The plain pairwise_l2 is
    # a BLAS matmul whose bits at these tiny shapes depend on the block's
    # row count (the CUDA kernel's depend on n alone), so here d² is held
    # within 1e-5·(‖q‖² + ‖x‖²) and the ids exactly
    ds, gs = exact_knn_sharded(q, x[:9], 20, mesh=cpu_mesh(d))
    de, ge = exact_knn(q, x[:9], 20)
    assert torch.equal(gs, ge)
    tol = 1e-5 * ((q ** 2).sum(-1, keepdim=True) + (x[:9] ** 2).sum(-1).max())
    assert bool((torch.abs(ds ** 2 - de ** 2) <= tol).all())


# ---------------------------------------------------------------------------
# the fleet on a mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet():
    """Three sealed shards (S = 3, padded to 4 slots on D = 2 and 4) and a
    live delta."""
    data = random_walks(0, 2700, CFG["series_len"])
    f = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), fanout=2,
                               delta_capacity=4096, auto_compact=False),
                   device="cpu")
    for i in range(3):
        f.add_shard(f"tenant{i}", data[i * 800:(i + 1) * 800])
    f.insert(data[2400:])
    rng = np.random.default_rng(2)
    queries = data[rng.choice(len(data), 7, replace=False)]
    queries[3:] += 0.3 * rng.standard_normal(queries[3:].shape).astype(np.float32)
    return f, queries


def reference_num_slots(jref, stores, d):
    """The reference placement's slot count: its ``pad_store`` of the
    stacked stores over a data axis of size d."""
    jnp, JStore, _, j_store = jref
    jst = [JStore(*(jnp.asarray(x.numpy()) for x in st)) for st in stores]
    return int(j_store.pad_store(j_store.stack_stores(jst), d).data.shape[0])


@pytest.mark.parametrize("d", [2, 4])
def test_fleet_mesh_equals_host(jref, fleet, d):
    f, queries = fleet
    cases = [("signature", "adaptive"), ("exhaustive", "adaptive"),
             ("exhaustive", "exhaustive")]
    host = {c: f.query(queries, K, routing=c[0], variant=c[1], placement="host")
            for c in cases}
    epoch = f._placement_epoch
    f.attach_mesh(cpu_mesh(d))
    assert f._placement_epoch == epoch + 1          # no stale plan replays
    try:
        for c in cases:
            for _ in range(2):                      # cold, then plan-cache hits
                dm, gm, im = f.query(queries, K, routing=c[0], variant=c[1])
                dh, gh, ih = host[c]
                np.testing.assert_array_equal(gm, gh)
                np.testing.assert_array_equal(dm, dh)
                np.testing.assert_array_equal(im.partitions_touched,
                                              ih.partitions_touched)
                np.testing.assert_array_equal(im.candidates_scanned,
                                              ih.candidates_scanned)
        pl = f._placement
        assert pl.num_slots == 4 == reference_num_slots(
            jref, [s.index.store for s in f.shards], d)
        assert [len(s.shards) for s in pl._slots] == \
            ([2, 1] if d == 2 else [1, 1, 1, 0])
    finally:
        f.attach_mesh(None)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_scan_exact_sharded(fleet, d):
    f, queries = fleet
    one = f.scan_exact(queries, K)
    for a, b in zip(f.scan_exact(queries, K, mesh=cpu_mesh(d)), one):
        np.testing.assert_array_equal(a, b)


def test_fleet_engine_on_a_mesh(fleet):
    f, queries = fleet
    dh, gh, _ = f.query(queries, K, placement="host")
    try:
        eng = FleetEngine(f, batch_size=4, k=K, mesh=["cpu"] * 3)
        assert eng.fleet.mesh.size == 3
        dist, gid, _ = eng.run(queries)
        np.testing.assert_array_equal(gid, gh)
        np.testing.assert_array_equal(dist, dh)
    finally:
        f.attach_mesh(None)


# ---------------------------------------------------------------------------
# the serving engine on a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 4])
def test_engine_mesh_equals_engine(d):
    data = random_walks(5, 2000, CFG["series_len"])
    index = build_index(torch.as_tensor(data), ClimberConfig(**CFG),
                        device="cpu", generator=torch.Generator().manual_seed(0))
    queries = data[::250] + 0.1
    for variant in ("adaptive", "od_smallest"):
        one = ClimberEngine(index, batch_size=4, variant=variant, k=K).run(queries)
        eng = ClimberEngine(index, batch_size=4, variant=variant, k=K,
                            mesh=cpu_mesh(d))
        assert len(eng._slots) == d
        many = eng.run(queries)
        np.testing.assert_array_equal(many[1], one[1])
        np.testing.assert_array_equal(many[0], one[0])
        assert [m.partitions_touched for m in many[2]] == \
            [m.partitions_touched for m in one[2]]


# ---------------------------------------------------------------------------
# on the card: the slots of one card, through the kernels
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4])
def test_refine_sharded_on_the_card(cuda, d):
    arrays, q, sp, lo, hi = synthetic_store(7)
    store = PartitionStore(*(x.to(cuda) for x in t_store(arrays)))
    args = tuple(torch.as_tensor(x, device=cuda) for x in (q, sp, lo, hi)) + (7,)
    mesh = make_mesh(d, [cuda] * d)
    assert_same(refine_sharded(store, *args, mesh=mesh), refine(store, *args))
    assert_same(refine_sharded(store, *args, mesh=mesh, use_kernel=False),
                refine(store, *args, use_kernel=False))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4])
def test_exact_knn_sharded_on_the_card(cuda, d):
    x = torch.as_tensor(random_walks(4, 5003, 64), device=cuda)
    q = x[::500].contiguous() + 0.05
    # pairwise_l2's bits depend on n alone, so every split gives one answer
    assert_same(exact_knn_sharded(q, x, 50, mesh=make_mesh(d, [cuda] * d)),
                exact_knn(q, x, 50))
