"""Index parity: the port's build, given the JAX package's random draws,
reproduces the reference index array for array; and a reference index
carried across with ``index_from_arrays`` answers as the reference does.

Sizes follow ``small_index`` in ``tests/test_query_engine.py``; the data is
numpy random walks from a seed, handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import knn_query as j_knn_query  # noqa: E402
from repro.core.index import build_store as j_build_store  # noqa: E402
from repro.core.traversal import route_records as j_route_records  # noqa: E402
from repro.distributed.store import store_to_arrays  # noqa: E402
from repro.fleet.lifecycle.snapshot import _FOREST_ARRAYS  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import index as t_index  # noqa: E402
from repro_torch.core.query import knn_query as t_knn_query  # noqa: E402
from repro_torch.core.traversal import TrieDevice, descend, route_records  # noqa: E402
from repro_torch.utils.config import ClimberConfig as TConfig  # noqa: E402

CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=10,
           candidate_groups=4, adaptive_factor=4)
NUM = 3000


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


def reference_draws(key, n_rec, cfg):
    """Replay ``repro.core.index.build_index``'s two random draws."""
    k_sample, k_pivot, _ = jax.random.split(key, 3)
    s = t_index.sample_size(n_rec, cfg)
    sample_idx = jax.random.choice(k_sample, n_rec, shape=(s,), replace=False)
    pivot_idx = jax.random.choice(k_pivot, s, shape=(cfg.num_pivots,), replace=False)
    return np.array(sample_idx), np.array(pivot_idx)


def index_arrays(idx):
    """A JAX index laid out as ``fleet/lifecycle/snapshot.save_shard`` writes it."""
    arrays = store_to_arrays(idx.store)
    arrays["pivots"] = np.asarray(idx.pivots)
    arrays["centroid_onehot"] = np.asarray(idx.centroid_onehot)
    for name in _FOREST_ARRAYS:
        arrays["forest_" + name] = np.asarray(getattr(idx.forest, name))
    return arrays


@pytest.fixture(scope="module")
def built():
    data = random_walks(0, NUM, CFG["series_len"])
    key = jax.random.PRNGKey(1)
    ref = j_build_index(key, jnp.asarray(data), JConfig(**CFG))
    sample_idx, pivot_idx = reference_draws(key, NUM, TConfig(**CFG))
    port = t_index.build_index(torch.as_tensor(data), TConfig(**CFG), device="cpu",
                               sample_idx=sample_idx, pivot_idx=pivot_idx)
    return data, ref, port


def test_pivots_and_centroids_equal(built):
    _, ref, port = built
    np.testing.assert_array_equal(port.pivots.numpy(), np.asarray(ref.pivots))
    np.testing.assert_array_equal(port.centroid_onehot.numpy(),
                                  np.asarray(ref.centroid_onehot))
    assert port.num_groups == ref.num_groups > 2


@pytest.mark.parametrize("name", _FOREST_ARRAYS)
def test_forest_tables_equal(built, name):
    _, ref, port = built
    a, b = getattr(port.forest, name), getattr(ref.forest, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_forest_scalars_equal(built):
    _, ref, port = built
    for name in ("num_partitions", "num_pivots", "max_parts_per_node"):
        assert getattr(port.forest, name) == getattr(ref.forest, name)
    assert port.forest.num_partitions > 8


@pytest.mark.parametrize("field", ["data", "norms", "rec_dfs", "rec_gid", "count"])
def test_store_arrays_equal(built, field):
    _, ref, port = built
    a, b = getattr(port.store, field).numpy(), np.asarray(getattr(ref.store, field))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", [f for f in TrieDevice._fields
                                   if f not in ("num_pivots", "num_partitions")])
def test_trie_device_equal(built, field):
    _, ref, port = built
    np.testing.assert_array_equal(getattr(port.trie, field).numpy(),
                                  np.asarray(getattr(ref.trie, field)))


def test_featurize_and_routing_equal(built):
    data, ref, port = built
    x = data[:700]
    p4r_t, z_t = port.featurize(torch.as_tensor(x))
    p4r_j, z_j = ref.featurize(jnp.asarray(x))
    np.testing.assert_array_equal(p4r_t.numpy(), np.asarray(p4r_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-6)
    grp = np.random.default_rng(4).integers(0, ref.num_groups, size=len(x))
    part_t, dfs_t = route_records(port.trie, p4r_t, torch.as_tensor(grp))
    part_j, dfs_j = j_route_records(ref.trie, p4r_j, jnp.asarray(grp))
    np.testing.assert_array_equal(part_t.numpy(), np.asarray(part_j))
    np.testing.assert_array_equal(dfs_t.numpy(), np.asarray(dfs_j))
    node, pathlen, parent = descend(port.trie, p4r_t, torch.as_tensor(grp))
    assert (pathlen >= 0).all() and (parent >= 0).all() and (node >= 0).all()


def test_route_in_chunks_equals_one_pass(built):
    data, _, port = built
    x = torch.as_tensor(data)
    args = (x, port.pivots, port.centroid_onehot, port.trie, port.cfg)
    one = t_index._route_full_dataset(*args, chunk=len(data))
    many = t_index._route_full_dataset(*args, chunk=257)
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])


@pytest.mark.parametrize("pad", [None, 400])
def test_build_store_equal(pad):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((500, 16)).astype(np.float32)
    part = rng.integers(0, 9, size=500).astype(np.int32)
    dfs = rng.integers(0, 30, size=500).astype(np.int32)
    ref = j_build_store(jnp.asarray(data), part, dfs, 10, pad=pad)
    got = t_index.build_store(torch.as_tensor(data), torch.as_tensor(part),
                              torch.as_tensor(dfs), 10, pad=pad, chunk=64)
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))


def test_index_from_arrays_round_trip(built):
    data, ref, _ = built
    carried = t_index.index_from_arrays(index_arrays(ref), TConfig(**CFG), device="cpu")
    for field in ref.store._fields:
        np.testing.assert_array_equal(getattr(carried.store, field).numpy(),
                                      np.asarray(getattr(ref.store, field)))
    assert carried.forest.max_parts_per_node == ref.forest.max_parts_per_node
    assert carried.forest.num_partitions == ref.forest.num_partitions
    q = data[np.random.default_rng(3).choice(NUM, 9, replace=False)]
    d_t, g_t, _ = t_knn_query(carried, torch.as_tensor(q), 10, variant="adaptive")
    d_j, g_j, _ = j_knn_query(ref, jnp.asarray(q), 10, variant="adaptive")
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    tol = 1e-5 * 2 * CFG["series_len"]          # ‖q‖² = ‖x‖² = n, z-normalised
    assert np.all(np.abs(d_t.numpy() ** 2 - np.asarray(d_j) ** 2) <= tol)


def test_index_from_arrays_rejects_wrong_pivots(built):
    _, ref, _ = built
    with pytest.raises(ValueError):
        t_index.index_from_arrays(index_arrays(ref),
                                  TConfig(**{**CFG, "num_pivots": 16}), device="cpu")


def test_build_with_generator_is_deterministic(built):
    data = torch.as_tensor(built[0][:1500])
    cfg = TConfig(**CFG)
    a = t_index.build_index(data, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(9))
    b = t_index.build_index(data, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(9))
    assert torch.equal(a.store.rec_gid, b.store.rec_gid)
    assert torch.equal(a.pivots, b.pivots)
    live = a.store.rec_gid[a.store.rec_gid >= 0]
    assert sorted(live.tolist()) == list(range(1500))     # every record once
    assert set(a.build_seconds) >= {"sample", "centroids", "skeleton", "route",
                                    "store", "total"}


def test_build_validates_draws(built):
    data = torch.as_tensor(built[0])
    with pytest.raises(ValueError):
        t_index.build_index(data, TConfig(**CFG), device="cpu", sample_idx=[0, 1, 2])
