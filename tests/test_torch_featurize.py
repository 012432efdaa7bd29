"""Featurize parity: the PyTorch port against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` (JAX, CPU)
and ``repro_torch`` (CPU tensors, i.e. the plain paths).  Integer results
(signatures, groups) must be equal; floats agree to fp32 rounding.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import assignment as j_assign  # noqa: E402
from repro.core import distances as j_dist  # noqa: E402
from repro.core import signatures as j_sig  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import assignment as t_assign  # noqa: E402
from repro_torch.core import distances as t_dist  # noqa: E402
from repro_torch.core import signatures as t_sig  # noqa: E402
from repro_torch.data import make_dataset, make_queries  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.utils.config import ClimberConfig as TConfig  # noqa: E402

j_paa = importlib.import_module("repro.core.paa")
t_paa = importlib.import_module("repro_torch.core.paa")

R, W, M, N = 32, 8, 5, 2000


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
def feats():
    series = random_walks(0, N, 64)
    z = np.array(j_paa.paa(jnp.asarray(series), W))
    pivots = z[np.random.default_rng(1).choice(N, R, replace=False)]
    p4r = np.array(j_sig.rank_signature(jnp.asarray(z), jnp.asarray(pivots), M))
    # centroids: row 0 the all-zeros fall-back, then the sets of a few rows
    sets = np.sort(p4r[np.random.default_rng(2).choice(N, 9, replace=False)], -1)
    onehot = np.zeros((10, R), np.float32)
    for g, s in enumerate(sets, start=1):
        onehot[g, s] = 1.0
    return series, z, pivots, p4r, onehot


def test_config_matches_reference():
    j, t = JConfig(), TConfig()
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert TConfig.from_json(j.to_json()) == t
    assert t.max_partitions == j.max_partitions


@pytest.mark.parametrize("bad", [dict(prefix_len=300), dict(paa_segments=7),
                                 dict(decay="cubic"), dict(sample_frac=0.0)])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)


def test_paa_and_znormalize(feats):
    series = feats[0]
    np.testing.assert_allclose(
        t_paa.paa(torch.as_tensor(series), W).numpy(),
        np.asarray(j_paa.paa(jnp.asarray(series), W)), rtol=0, atol=1e-6)
    raw = np.random.default_rng(3).standard_normal((7, 64)).astype(np.float32) * 5 + 2
    np.testing.assert_allclose(
        t_paa.znormalize(torch.as_tensor(raw)).numpy(),
        np.asarray(j_paa.znormalize(jnp.asarray(raw))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        t_paa.paa(torch.zeros(2, 10), 3)


def test_pivot_distances(feats):
    _, z, pivots, _, _ = feats
    got = t_sig.pivot_distances(torch.as_tensor(z), torch.as_tensor(pivots)).numpy()
    ref = np.asarray(j_sig.pivot_distances(jnp.asarray(z), jnp.asarray(pivots)))
    scale = (z * z).sum(-1)[:, None] + (pivots * pivots).sum(-1)[None, :]
    assert np.all(np.abs(got - ref) <= 1e-5 * scale)


def test_rank_signature_exact(feats):
    _, z, pivots, p4r, _ = feats
    got = t_sig.rank_signature(torch.as_tensor(z), torch.as_tensor(pivots), M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), p4r)
    # the featurize path (kernel wrapper on a CPU tensor → plain version)
    np.testing.assert_array_equal(
        ops.pivot_rank(torch.as_tensor(z), torch.as_tensor(pivots), M).numpy(), p4r)


def test_rank_signature_ties_go_to_lower_id():
    z = torch.zeros(1, 4)
    pivots = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 2.0],
                           [0, 0, 1.0, 0]])
    assert t_sig.rank_signature(z, pivots, 3).tolist() == [[0, 1, 3]]
    ref = j_sig.rank_signature(jnp.zeros((1, 4)), jnp.asarray(pivots.numpy()), 3)
    assert np.asarray(ref).tolist() == [[0, 1, 3]]


def test_set_signature_and_onehots(feats):
    p4r = feats[3]
    np.testing.assert_array_equal(
        t_sig.set_signature(torch.as_tensor(p4r)).numpy(),
        np.asarray(j_sig.set_signature(jnp.asarray(p4r))))
    np.testing.assert_array_equal(
        t_sig.set_onehot(torch.as_tensor(p4r), R).numpy(),
        np.asarray(j_sig.set_onehot(jnp.asarray(p4r), R)))
    for kind in ("exp", "linear"):
        wj = j_sig.decay_weights(M, kind, 0.5)
        wt = t_sig.decay_weights(M, kind, 0.5)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(
            t_sig.weighted_onehot(torch.as_tensor(p4r), R, wt).numpy(),
            np.asarray(j_sig.weighted_onehot(jnp.asarray(p4r), R, wj)))


def test_distances(feats):
    series, _, _, p4r, onehot = feats
    x, y = series[:5], series[5:12]
    np.testing.assert_allclose(
        t_dist.euclidean(torch.as_tensor(x[:, None]), torch.as_tensor(y[None])).numpy(),
        np.asarray(j_dist.euclidean(jnp.asarray(x[:, None]), jnp.asarray(y[None]))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t_dist.squared_l2_pairwise(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(j_dist.squared_l2_pairwise(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-3)
    oh = np.array(j_sig.set_onehot(jnp.asarray(p4r[:50]), R))
    np.testing.assert_array_equal(
        t_dist.overlap_distance(torch.as_tensor(oh), torch.as_tensor(onehot), M).numpy(),
        np.asarray(j_dist.overlap_distance(jnp.asarray(oh), jnp.asarray(onehot), M)))


@pytest.mark.parametrize("decay", ["exp", "linear"])
def test_assign_groups_exact(feats, decay):
    p4r, onehot = feats[3], feats[4]
    ref = np.asarray(j_assign.assign_groups(jnp.asarray(p4r), jnp.asarray(onehot),
                                            R, decay=decay))
    got = t_assign.assign_groups(torch.as_tensor(p4r), torch.as_tensor(onehot), R,
                                 decay=decay)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 3          # the ladder was exercised


def test_assignment_distances_exact(feats):
    p4r, onehot = feats[3], feats[4]
    od_j, wd_j = j_assign.assignment_distances(jnp.asarray(p4r), jnp.asarray(onehot), R)
    od_t, wd_t = t_assign.assignment_distances(torch.as_tensor(p4r),
                                               torch.as_tensor(onehot), R)
    np.testing.assert_array_equal(od_t.numpy(), np.asarray(od_j))
    np.testing.assert_array_equal(wd_t.numpy(), np.asarray(wd_j))


def test_featurize_wrappers_use_plain_versions_on_cpu(feats):
    series, z, pivots = feats[0], feats[1], feats[2]
    before = ops.launch_counts()
    np.testing.assert_allclose(ops.paa(torch.as_tensor(series), W).numpy(), z,
                               rtol=0, atol=1e-6)
    ops.pivot_rank(torch.as_tensor(z), torch.as_tensor(pivots), M)
    assert ops.launch_counts() == before     # no kernel launched on the CPU


def test_random_walk_generator():
    g = torch.Generator().manual_seed(5)
    x = make_dataset("randomwalk", 300, 64, generator=g)
    assert x.shape == (300, 64) and x.dtype == torch.float32
    np.testing.assert_allclose(x.mean(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(x.std(-1, correction=0).numpy(), 1.0, atol=1e-4)
    again = make_dataset("randomwalk", 300, 64,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(x, again)
    q = make_queries(x, 20, generator=g)
    rows = {tuple(r) for r in x.numpy().round(6).tolist()}
    assert q.shape == (20, 64)
    assert all(tuple(r) in rows for r in q.numpy().round(6).tolist())
    with pytest.raises(KeyError):
        make_dataset("nope", 10, 64, generator=g)
