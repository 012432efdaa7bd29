"""Eval parity: metrics, hardness split, the four generators' deterministic
bodies, tenant corpora and perturbed queries (fed the JAX package's own
``jax.random`` draws), the recall calibration, and the recall-target
planner — the port against the JAX package.

Integer results (metrics on shared arrays, splits, plans) are exact.
Generated series agree to atol = 2e-5: both sides are z-normalised float32
built from the same draws, with sums (convolutions, sinusoid bands) taken
in other orders and ``sin``/``pow`` from other libraries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import series as jseries  # noqa: E402
from repro.eval import datasets as jdatasets  # noqa: E402
from repro.eval import metrics as jmetrics  # noqa: E402
from repro.eval.target import RecallCalibration as JCalibration  # noqa: E402
from repro_torch.data import series as tseries  # noqa: E402
from repro_torch.eval import datasets as tdatasets  # noqa: E402
from repro_torch.eval import metrics as tmetrics  # noqa: E402
from repro_torch.eval.ground_truth import GroundTruthCache  # noqa: E402
from repro_torch.eval.target import RecallCalibration as TCalibration  # noqa: E402

GEN_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    t = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(t)


def t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# metrics and the hardness split, on shared arrays
# ---------------------------------------------------------------------------
def answer_arrays(seed, q=12, k=8):
    """Exact and approximate answers with pads, misses and boundary ties."""
    rng = np.random.default_rng(seed)
    exact_d = np.sort(rng.random((q, k)).astype(np.float32), axis=1)
    exact_i = np.stack([rng.permutation(100)[:k] for _ in range(q)])
    approx_i = exact_i.copy()
    approx_d = exact_d.copy()
    miss = rng.random((q, k)) < 0.3
    approx_i[miss] = 100 + rng.integers(0, 50, int(miss.sum()))
    # some replacements sit exactly at (or just past) the k-th exact distance
    approx_d[:, -1] = exact_d[:, -1] + np.where(rng.random(q) < 0.5, 0.0, 1e-3)
    approx_i[:2, -3:] = -1
    exact_i[3, -2:] = -1
    exact_i[4] = -1                               # no truth: skipped
    order = rng.permutation(k)
    return approx_i[:, order], approx_d[:, order], exact_i, exact_d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    ai, ad, ei, ed = answer_arrays(seed)
    for k in (None, 5):
        assert tmetrics.recall_at_k(ai, ei, k) == jmetrics.recall_at_k(ai, ei, k)
        assert tmetrics.recall_at_k(ai, ei, k, approx_dist=ad, exact_dist=ed) \
            == jmetrics.recall_at_k(ai, ei, k, approx_dist=ad, exact_dist=ed)
        assert tmetrics.mean_average_precision(ai, ei, k) \
            == jmetrics.mean_average_precision(ai, ei, k)
    # tensors are accepted as well as arrays
    assert tmetrics.recall_at_k(t(ai), t(ei), approx_dist=t(ad), exact_dist=t(ed)) \
        == jmetrics.recall_at_k(ai, ei, approx_dist=ad, exact_dist=ed)
    ties = tmetrics.recall_at_k(ai, ei, approx_dist=ad, exact_dist=ed)
    assert ties >= tmetrics.recall_at_k(ai, ei)


def test_frontier_auc_and_calibration_equal():
    pts = [(0.3, 0.7), (0.1, 0.4), (0.3, 0.6), (0.05, 0.2), (1.2, 0.99)]
    for p in ([], pts[:1], pts, [(0.0, 0.5), (0.0, 0.8)]):
        assert tmetrics.frontier_auc(p) == jmetrics.frontier_auc(p)
    cells = [{"mean_partitions_touched": c * 10, "recall": r} for c, r in pts]
    cells.append({"recall": 1.0})
    tc, jc = TCalibration.from_cells(cells), JCalibration.from_cells(cells)
    assert (tc.partitions, tc.recalls) == (jc.partitions, jc.recalls)
    for x in (0.0, 1.0, 2.5, 7.0, 50.0):
        assert tc.predict(x) == jc.predict(x)
    for r in (0.1, 0.65, 0.995):
        assert tc.partitions_for(r) == jc.partitions_for(r)
    with pytest.raises(ValueError):
        TCalibration.from_cells([{"recall": 1.0}])


def test_hardness_split_equal():
    rng = np.random.default_rng(3)
    d = np.sort(rng.random((21, 10)).astype(np.float32), axis=1)
    d[5] = d[6]                                   # tied contrast: by index
    d[7, :] = 0.0                                 # zero k-th distance
    for k in (3, 5):
        hard_t, easy_t = tdatasets.hardness_split(t(d), k)
        hard_j, easy_j = jdatasets.hardness_split(d, k)
        np.testing.assert_array_equal(hard_t, hard_j)
        np.testing.assert_array_equal(easy_t, easy_j)
    with pytest.raises(ValueError):
        tdatasets.hardness_split(d, 6)


# ---------------------------------------------------------------------------
# generators: the port's bodies on the reference's draws
# ---------------------------------------------------------------------------
NUM, LEN = 40, 64


def test_sift_body_matches():
    key = jax.random.PRNGKey(11)
    kc, ka, kn = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (64, LEN), dtype=jnp.float32)
    assign = jax.random.randint(ka, (NUM,), 0, 64)
    noise = jax.random.normal(kn, (NUM, LEN), dtype=jnp.float32)
    got = tseries.sift_body(t(centers), t(assign), t(noise), 0.15)
    np.testing.assert_allclose(got.numpy(), np.asarray(jseries.sift_like(key, NUM, LEN)),
                               atol=GEN_ATOL)


def test_dna_body_matches():
    key = jax.random.PRNGKey(12)
    k1, = jax.random.split(key, 1)
    letters = jax.random.randint(k1, (NUM, LEN), 0, 4)
    got = tseries.dna_body(t(letters), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jseries.dna_like(key, NUM, LEN)),
                               atol=GEN_ATOL)


def test_eeg_body_matches():
    key = jax.random.PRNGKey(13)
    kf, kp, ka, kn = jax.random.split(key, 4)
    freqs = jax.random.uniform(kf, (NUM, 5), minval=0.5, maxval=40.0)
    phases = jax.random.uniform(kp, (NUM, 5), maxval=2 * jnp.pi)
    amps = jax.random.uniform(ka, (NUM, 5), minval=0.2, maxval=1.0)
    noise = jax.random.normal(kn, (NUM, LEN))
    got = tseries.eeg_body(t(freqs), t(phases), t(amps), t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(jseries.eeg_like(key, NUM, LEN)),
                               atol=GEN_ATOL)


def test_seismic_body_matches():
    key = jax.random.PRNGKey(14)
    kn, kt, kf, ka = jax.random.split(key, 4)
    white = jax.random.normal(kn, (NUM, LEN), dtype=jnp.float32)
    onset = jax.random.uniform(kt, (NUM, 3), maxval=0.8 * LEN)
    freq = jax.random.uniform(kf, (NUM, 3), minval=0.05, maxval=0.3)
    amp = jax.random.uniform(ka, (NUM, 3), minval=2.0, maxval=6.0)
    got = tseries.seismic_body(t(white), t(onset), t(freq), t(amp), 0.97)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jseries.seismic_like(key, NUM, LEN)),
                               atol=GEN_ATOL)


@pytest.mark.parametrize("m", [8, 32, 5, 1])
def test_convolve_same_is_numpy_convolve(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    v = rng.random(m).astype(np.float32)
    want = np.stack([np.convolve(r, v, mode="same") for r in x])
    np.testing.assert_allclose(tseries.convolve_same(t(x), t(v)).numpy(), want,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(tseries.GENERATORS))
def test_generators_shape_and_determinism(name):
    make = lambda s: tseries.make_dataset(name, 30, LEN, generator=torch.Generator()
                                          .manual_seed(s))
    a, b, c = make(0), make(0), make(1)
    assert a.shape == (30, LEN) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())
    np.testing.assert_allclose(a.mean(-1).numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(a.std(-1, correction=0).numpy(), 1.0, atol=1e-3)


def test_generators_chunk_boundary(monkeypatch):
    """Chunked generation covers every row once (chunks of 7 rows here)."""
    monkeypatch.setattr(tseries, "GENERATE_CHUNK", 7)
    x = tseries.seismic_like(30, LEN, generator=torch.Generator().manual_seed(2))
    assert x.shape == (30, LEN) and bool(torch.isfinite(x).all())
    assert len(set(map(tuple, x[:, :4].tolist()))) == 30


# ---------------------------------------------------------------------------
# tenant corpora and perturbed queries, on the reference's draws
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpora():
    kw = dict(num_shards=3, shard_size=50, series_len=LEN, seed=5, affinity=0.6)
    ref = jdatasets.tenant_corpus("seismic", **kw)
    root = jax.random.PRNGKey(5)
    bases, steps = [], []
    for i in range(3):
        kd, km = jax.random.split(jax.random.fold_in(root, i))
        bases.append(np.array(jseries.GENERATORS["seismic"](kd, 50, LEN)))
        steps.append(np.array(jax.random.normal(km, (LEN,))))
    port = tdatasets.tenant_corpus("seismic", device="cpu", bases=bases,
                                   motif_steps=steps, **kw)
    return ref, port


def test_tenant_corpus_matches(corpora):
    ref, port = corpora
    assert port.meta() == ref.meta()
    assert GroundTruthCache.key_for(port.meta()) == GroundTruthCache.key_for(ref.meta())
    for s_t, s_j in zip(port.shards, ref.shards):
        np.testing.assert_allclose(s_t.numpy(), s_j, atol=GEN_ATOL)
    np.testing.assert_allclose(port.union.numpy(), ref.union, atol=GEN_ATOL)


def test_tenant_corpus_draws_its_own(corpora):
    _, port = corpora
    kw = dict(num_shards=2, shard_size=20, series_len=LEN, seed=1, affinity=0.8,
              device="cpu")
    a = tdatasets.tenant_corpus("dna", **kw)
    b = tdatasets.tenant_corpus("dna", **kw)
    assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))
    assert a.union.shape == (40, LEN)
    with pytest.raises(KeyError):
        tdatasets.tenant_corpus("nope", **kw)


def test_perturbed_queries_match(corpora):
    ref, port = corpora
    want = jdatasets.perturbed_queries(ref, 7, noise=0.1, seed=2)
    ki, kn = jax.random.split(jax.random.PRNGKey(2 ^ 0x5EED))
    idx = np.asarray(jax.random.choice(ki, 150, shape=(7,), replace=False))
    jitter = np.array(jax.random.normal(kn, (7, LEN)))
    got = tdatasets.perturbed_queries(port, 7, noise=0.1, seed=2, idx=idx,
                                      jitter=jitter)
    np.testing.assert_allclose(got.numpy(), want, atol=GEN_ATOL)
    own = tdatasets.perturbed_queries(port, 7, noise=0.1, seed=2)
    assert own.shape == (7, LEN)
    assert torch.equal(own, tdatasets.perturbed_queries(port, 7, noise=0.1, seed=2))


# ---------------------------------------------------------------------------
# the recall-target planner
# ---------------------------------------------------------------------------
CFG = dict(series_len=32, paa_segments=8, num_pivots=16, prefix_len=4,
           capacity=40, sample_frac=0.5, max_centroids=8, k=10,
           candidate_groups=3, adaptive_factor=2)


@pytest.fixture(scope="module")
def small_indexes():
    from repro.core import build_index as j_build_index
    from repro.distributed.store import store_to_arrays
    from repro.fleet.lifecycle.snapshot import _FOREST_ARRAYS
    from repro.utils.config import ClimberConfig as JConfig
    from repro_torch.core.index import index_from_arrays
    from repro_torch.utils.config import ClimberConfig as TConfig
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((800, 32)), -1)
    x = ((x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)).astype(np.float32)
    ref = j_build_index(jax.random.PRNGKey(0), jnp.asarray(x), JConfig(**CFG))
    arrays = store_to_arrays(ref.store)
    arrays["pivots"] = np.asarray(ref.pivots)
    arrays["centroid_onehot"] = np.asarray(ref.centroid_onehot)
    for name in _FOREST_ARRAYS:
        arrays["forest_" + name] = np.asarray(getattr(ref.forest, name))
    port = index_from_arrays(arrays, TConfig(**CFG), device="cpu")
    queries = x[rng.choice(800, 9, replace=False)]
    return ref, port, queries


def test_recall_target_spend_one_is_adaptive(small_indexes):
    from repro_torch.core import query as tq
    _, port, queries = small_indexes
    p4r_t, _ = port.featurize(t(queries))
    one = tq.make_recall_target_planner(1.0)(port, p4r_t)
    base = tq.plan_adaptive(port, p4r_t)
    for a, b in zip(one, base):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tq.make_recall_target_planner(0.5)


@pytest.mark.parametrize("spend", [1.0, 2.0])
def test_recall_target_matches_reference(small_indexes, spend):
    """The spend-1 case also compiles the reference planner's operations,
    which the spend-2 case (same shapes) then reuses."""
    from repro.core.query import make_recall_target_planner as j_make
    from repro_torch.core import query as tq
    ref, port, queries = small_indexes
    p4r_t, _ = port.featurize(t(queries))
    name = f"recall_target_parity_{spend:g}"
    planner = tq.register_recall_target(spend, name=name)
    assert planner.spend_factor == spend and name in tq.planner_names()
    qp_t = tq.plan(port, p4r_t, variant=name)
    qp_j = j_make(spend)(ref, jnp.asarray(p4r_t.numpy()))
    for field in ("sel_part", "sel_lo", "sel_hi", "node", "pathlen"):
        np.testing.assert_array_equal(getattr(qp_t, field).numpy(),
                                      np.asarray(getattr(qp_j, field)), err_msg=field)
    base = tq.plan_adaptive(port, p4r_t)
    assert (qp_t.partitions_touched() >= base.partitions_touched()).all()
