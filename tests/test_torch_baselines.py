"""Baseline parity: Dss (``exact_knn``), the ground-truth cache, SAX/iSAX,
DPiSAX and TARDIS of the port against the JAX package, fed the same numpy
inputs (and, for TARDIS, the reference's sample draw).

Gids are exact; squared distances agree to 1e-5·(‖q‖² + ‖x‖²), the
cancellation bound of ``‖q‖² − 2q·x + ‖x‖²`` under another summation order.
On integer-valued data every distance is exact, so the planted duplicate
rows pin the tie order (the lower record id first).  Each reference index
is built once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import baselines as jb  # noqa: E402
from repro.distributed.store import store_to_arrays  # noqa: E402
from repro.eval.ground_truth import GroundTruthCache as JCache  # noqa: E402
from repro.fleet.lifecycle.snapshot import _FOREST_ARRAYS  # noqa: E402
from repro_torch import baselines as tb  # noqa: E402
from repro_torch.core.index import FOREST_ARRAYS  # noqa: E402
from repro_torch.eval.ground_truth import GroundTruthCache as TCache  # noqa: E402

N, n, SEG, CARD, CAP, K = 1500, 32, 8, 8, 60, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    t = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(t)


def random_walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=-1)
    return ((x - x.mean(-1, keepdims=True))
            / (x.std(-1, keepdims=True) + 1e-8)).astype(np.float32)


@pytest.fixture(scope="module")
def walks():
    data = random_walks(0, N, n)
    rng = np.random.default_rng(1)
    queries = data[rng.choice(N, 9, replace=False)].copy()
    queries[5:] += 0.3 * rng.standard_normal(queries[5:].shape).astype(np.float32)
    return data, queries


def tdev(a):
    return torch.as_tensor(np.asarray(a))


def assert_same_answers(d_t, g_t, d_j, g_j, queries, data):
    np.testing.assert_array_equal(np.asarray(g_t), np.asarray(g_j))
    q2 = (queries.astype(np.float64) ** 2).sum(-1, keepdims=True)
    tol = 1e-5 * (q2 + (data.astype(np.float64) ** 2).sum(-1).max())
    diff = np.abs(np.asarray(d_t, np.float64) ** 2 - np.asarray(d_j, np.float64) ** 2)
    assert (diff <= tol).all()


# ---------------------------------------------------------------------------
# Dss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 128])
def test_exact_knn_matches_reference(walks, chunk):
    data, queries = walks
    d_j, i_j = jb.exact_knn(jnp.asarray(queries), jnp.asarray(data), K, chunk=chunk)
    d_t, i_t = tb.exact_knn(tdev(queries), tdev(data), K, chunk=chunk)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    assert_same_answers(d_t.numpy(), i_t.numpy(), d_j, i_j, queries, data)
    assert (np.diff(d_t.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("chunk", [0, 128, 37])
def test_exact_knn_ties_go_to_the_lower_id(chunk):
    """Integer data (every distance exact) with duplicate rows planted at
    higher ids: both packages return the same ids and distances, and equal
    distances come in ascending id order."""
    rng = np.random.default_rng(4)
    data = rng.integers(-2, 3, size=(400, 16)).astype(np.float32)
    data[300:340] = data[:40]                  # exact duplicates, later ids
    data[350:360] = data[5]
    queries = np.concatenate([data[[0, 5, 17]], data[[3]] + 1.0])
    d_j, i_j = jb.exact_knn(jnp.asarray(queries), jnp.asarray(data), 12, chunk=chunk)
    d_t, i_t = tb.exact_knn(tdev(queries), tdev(data), 12, chunk=chunk)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    d, i = d_t.numpy(), i_t.numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()
    assert i[1, 0] == 5 and set(range(350, 360)) <= set(i[1].tolist())


def test_exact_knn_k_above_n_and_recall(walks):
    data, queries = walks
    d_t, i_t = tb.exact_knn(tdev(queries), tdev(data[:20]), 50, chunk=8)
    assert i_t.shape == (len(queries), 20)
    assert sorted(i_t[0].tolist()) == list(range(20))
    _, exact = tb.exact_knn(tdev(queries), tdev(data), K)
    approx = exact.numpy().copy()
    approx[:, ::2] = -1
    assert tb.recall(approx, exact) == jb.recall(approx, np.asarray(exact)) == 0.5
    assert tb.recall(exact, exact) == 1.0


# ---------------------------------------------------------------------------
# ground-truth cache: one key, one file layout
# ---------------------------------------------------------------------------
def test_ground_truth_cache_is_shared(walks, tmp_path):
    data, queries = walks
    metas = [{"name": "randomwalk", "seed": 0, "n": n},
             {"shard_sizes": [3, 4], "affinity": 0.6, "name": "seismic"}]
    for m in metas:
        assert TCache.key_for(m) == JCache.key_for(m)
    port, ref = TCache(tmp_path), JCache(tmp_path)
    # the port writes, the reference reads
    d_t, i_t = port.exact(metas[0], queries, data, K, chunk=256, device="cpu")
    assert port.misses == 1 and isinstance(d_t, np.ndarray)
    got = ref.get(dict(metas[0], k=K))
    assert got is not None and ref.hits == 1
    np.testing.assert_array_equal(got[0], d_t)
    np.testing.assert_array_equal(got[1], i_t)
    # the reference writes, the port reads (and does not recompute)
    d_j, i_j = ref.exact(metas[1], queries[:3], data, 5)
    d_p, i_p = port.exact(metas[1], queries[:3], data, 5)
    assert port.misses == 1 and port.hits == 1
    np.testing.assert_array_equal(d_p, d_j)
    np.testing.assert_array_equal(i_p, i_j)


# ---------------------------------------------------------------------------
# SAX / iSAX
# ---------------------------------------------------------------------------
def test_sax_word_and_bits_equal(walks):
    data, _ = walks
    np.testing.assert_allclose(tb.sax_breakpoints(CARD).numpy(),
                               np.asarray(jb.sax_breakpoints(CARD)), atol=1e-6)
    w_t = tb.sax_word(tdev(data), SEG, CARD)
    w_j = jb.sax_word(jnp.asarray(data), SEG, CARD)
    assert w_t.dtype == torch.int32
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    from repro.baselines.isax import isax_bits as j_isax_bits
    for bits in (1, 2, 3):
        np.testing.assert_array_equal(tb.isax_bits(w_t, bits, CARD).numpy(),
                                      np.asarray(j_isax_bits(w_j, bits, CARD)))


# ---------------------------------------------------------------------------
# DPiSAX and TARDIS (reference indexes built once)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dpisax(walks):
    data, queries = walks
    ref = jb.build_dpisax(jnp.asarray(data), segments=SEG, cardinality=CARD,
                          capacity=CAP)
    port = tb.build_dpisax(tdev(data), segments=SEG, cardinality=CARD,
                           capacity=CAP, device="cpu")
    ans = jb.dpisax_knn(ref, jnp.asarray(queries), K)
    return ref, port, ans


@pytest.fixture(scope="module")
def tardis(walks):
    data, queries = walks
    key = jax.random.PRNGKey(7)
    ref = jb.build_tardis(key, jnp.asarray(data), segments=SEG, cardinality=CARD,
                          capacity=CAP, sample_frac=0.3)
    # the reference's own draw (baselines/tardis.py), handed to the port
    size = tb.tardis.tardis_sample_size(N, 0.3)
    idx = np.asarray(jax.random.choice(key, N, shape=(size,), replace=False))
    port = tb.build_tardis(tdev(data), segments=SEG, cardinality=CARD,
                           capacity=CAP, sample_frac=0.3, sample_idx=idx,
                           device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def tardis_answers(walks, tardis):
    """The reference's answers (a separate fixture: its first query compiles)."""
    return jb.tardis_knn(tardis[0], jnp.asarray(walks[1]), K)


def assert_store_equal(port_store, ref_store):
    for name, arr in store_to_arrays(ref_store).items():
        np.testing.assert_array_equal(
            getattr(port_store, name[len("store_"):]).numpy(), arr, err_msg=name)


def test_dpisax_table_and_store_equal(dpisax):
    ref, port, _ = dpisax
    assert port.table == ref.table
    assert port.num_partitions == ref.num_partitions > 1
    assert_store_equal(port.store, ref.store)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_dpisax_knn_equal(walks, dpisax, use_kernel):
    data, queries = walks
    _, port, (d_j, g_j) = dpisax
    d_t, g_t = tb.dpisax_knn(port, tdev(queries), K, use_kernel=use_kernel)
    assert_same_answers(d_t.numpy(), g_t.numpy(), d_j, g_j, queries, data)


def test_dpisax_from_arrays(walks, dpisax):
    data, queries = walks
    ref, _, (d_j, g_j) = dpisax
    port = tb.dpisax_from_arrays(ref.table, store_to_arrays(ref.store),
                                 segments=SEG, cardinality=CARD, device="cpu")
    d_t, g_t = tb.dpisax_knn(port, tdev(queries), K)
    assert_same_answers(d_t.numpy(), g_t.numpy(), d_j, g_j, queries, data)


def test_tardis_forest_and_store_equal(tardis):
    ref, port = tardis
    assert tuple(FOREST_ARRAYS) == tuple(_FOREST_ARRAYS)
    for name in FOREST_ARRAYS:
        np.testing.assert_array_equal(getattr(port.forest, name),
                                      np.asarray(getattr(ref.forest, name)),
                                      err_msg=name)
    assert port.forest.num_partitions == ref.forest.num_partitions > 1
    assert_store_equal(port.store, ref.store)


def test_tardis_knn_equal(walks, tardis, tardis_answers):
    data, queries = walks
    port = tardis[1]
    d_j, g_j = tardis_answers
    d_t, g_t = tb.tardis_knn(port, tdev(queries), K)
    assert_same_answers(d_t.numpy(), g_t.numpy(), d_j, g_j, queries, data)


def test_tardis_from_arrays(walks, tardis, tardis_answers):
    data, queries = walks
    ref = tardis[0]
    d_j, g_j = tardis_answers
    arrays = store_to_arrays(ref.store)
    for name in _FOREST_ARRAYS:
        arrays["forest_" + name] = np.asarray(getattr(ref.forest, name))
    port = tb.tardis_from_arrays(arrays, segments=SEG, cardinality=CARD,
                                 device="cpu")
    d_t, g_t = tb.tardis_knn(port, tdev(queries), K)
    assert_same_answers(d_t.numpy(), g_t.numpy(), d_j, g_j, queries, data)


def test_tardis_draws_its_own_sample(walks):
    data, _ = walks
    gen = torch.Generator().manual_seed(0)
    idx = tb.build_tardis(tdev(data[:600]), segments=SEG, cardinality=CARD,
                          capacity=CAP, generator=gen, device="cpu")
    assert int(idx.store.count.sum()) == 600
    assert sorted(idx.store.rec_gid[idx.store.rec_gid >= 0].tolist()) == list(range(600))
    with pytest.raises(ValueError):
        tb.build_tardis(tdev(data[:600]), sample_idx=np.arange(5), device="cpu")
