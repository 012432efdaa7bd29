"""The two build options of the reference, in the port: farthest-point
("max-min") pivots (``select_pivots_maxmin``, ``build_index(pivot_method=
"maxmin")``) and the paper's random second-tie break of the group
assignment (``assign_groups(tie_noise=)``).

The reference's draws are replayed: the max-min start row is
``jax.random.randint(key, (), 0, n)`` and the tie noise is
``jax.random.gumbel(tie_key, (N, G))``, handed over as numpy.  Pivot
indices, groups and the built index are compared exactly.  The max-min
argmax is over fp32 sums of ``w`` squares, which torch and XLA may add in
different orders; at these sizes no near-tie flips a choice (a flipped
near-tie would be documented here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import assignment as j_assignment  # noqa: E402
from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import pivots as j_pivots  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.core import assignment as t_assignment  # noqa: E402
from repro_torch.core import index as t_index  # noqa: E402
from repro_torch.core import pivots as t_pivots  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetDraws, IndexFleet  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.utils.config import ClimberConfig as TConfig  # noqa: E402

CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=10,
           candidate_groups=4, adaptive_factor=4)


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


def paa_rows(seed, num, w=8):
    x = random_walks(seed, num, 64)
    return x.reshape(num, w, -1).mean(-1)


# ---------------------------------------------------------------------------
# max-min pivots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxmin_pivots_equal_reference(seed):
    z = paa_rows(seed, 900)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(j_pivots.select_pivots(key, jnp.asarray(z), 24,
                                            method="maxmin"))
    first = np.asarray(jax.random.randint(key, (), 0, len(z)))
    zt = torch.as_tensor(z)
    idx = t_pivots.maxmin_indices(zt, 24, first)
    assert len(set(idx.tolist())) == 24                  # distinct rows
    np.testing.assert_array_equal(zt[idx].numpy(), ref)
    np.testing.assert_array_equal(
        t_pivots.select_pivots(zt, 24, idx=first, method="maxmin").numpy(), ref)
    # no start row: drawn from the generator, the rest deterministic
    g = lambda: torch.Generator().manual_seed(seed)
    a = t_pivots.select_pivots_maxmin(zt, 24, generator=g())
    assert torch.equal(a, t_pivots.select_pivots_maxmin(zt, 24, generator=g()))


def test_unknown_pivot_method_raises():
    with pytest.raises(ValueError, match="pivot selection"):
        t_pivots.select_pivots(torch.zeros((8, 2)), 2, method="kmeans")
    with pytest.raises(ValueError):
        t_pivots.select_pivots_maxmin(torch.zeros((3, 2)), 4, first=0)
    with pytest.raises(ValueError):
        FleetDraws(pivot_method="kmeans")


@pytest.fixture(scope="module")
def maxmin_built():
    data = random_walks(7, 2000, CFG["series_len"])
    key = jax.random.PRNGKey(3)
    ref = j_build_index(key, jnp.asarray(data), JConfig(**CFG),
                        pivot_method="maxmin")
    k_sample, k_pivot, _ = jax.random.split(key, 3)
    s = t_index.sample_size(len(data), TConfig(**CFG))
    sample_idx = np.array(jax.random.choice(k_sample, len(data), shape=(s,),
                                            replace=False))
    first = np.array(jax.random.randint(k_pivot, (), 0, s))
    port = t_index.build_index(torch.as_tensor(data), TConfig(**CFG),
                               device="cpu", sample_idx=sample_idx,
                               pivot_idx=first, pivot_method="maxmin")
    return data, ref, port


def test_maxmin_build_equals_reference(maxmin_built):
    _, ref, port = maxmin_built
    np.testing.assert_array_equal(port.pivots.numpy(), np.asarray(ref.pivots))
    np.testing.assert_array_equal(port.centroid_onehot.numpy(),
                                  np.asarray(ref.centroid_onehot))
    for name in ref.store._fields:
        np.testing.assert_array_equal(getattr(port.store, name).numpy(),
                                      np.asarray(getattr(ref.store, name)))


def test_maxmin_build_stores_every_record_once(maxmin_built):
    data, _, port = maxmin_built
    gids = port.store.rec_gid.numpy()
    live = np.sort(gids[gids >= 0])
    np.testing.assert_array_equal(live, np.arange(len(data)))
    rows = port.store.data.numpy()[gids >= 0]
    np.testing.assert_array_equal(rows, data[gids[gids >= 0]])


def test_maxmin_fleet_through_the_draw_hook():
    """``FleetDraws(pivot_method="maxmin")`` builds every shard and the
    router with max-min pivots; host and mesh placement still agree."""
    data = random_walks(8, 1600, CFG["series_len"])
    f = IndexFleet(FleetConfig(shard_cfg=TConfig(**CFG), auto_compact=False),
                   device="cpu", draws=FleetDraws(pivot_method="maxmin"))
    for i in range(2):
        f.add_shard(f"t{i}", data[i * 800:(i + 1) * 800])
    shard = f.shards[0]
    s = t_index.sample_size(800, f.cfg.shard_cfg)
    sample_idx, first = f.draws.build(f.cfg.seed, 17, 800, f.cfg.shard_cfg)
    assert first.shape == () and len(sample_idx) == s
    again = t_index.build_index(torch.as_tensor(data[:800]), f.cfg.shard_cfg,
                                device="cpu", sample_idx=sample_idx,
                                pivot_idx=first, pivot_method="maxmin")
    assert torch.equal(again.pivots, shard.index.pivots)
    queries = data[::200] + 0.1
    dh, gh, _ = f.query(queries, 10, placement="host")
    f.attach_mesh(make_mesh(2, ["cpu"] * 2))
    dm, gm, _ = f.query(queries, 10)
    np.testing.assert_array_equal(gm, gh)
    np.testing.assert_array_equal(dm, dh)


# ---------------------------------------------------------------------------
# random second-tie break
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_tie_broken_groups_equal_reference(seed):
    """Few pivots and centroids, so OD and WD tie often; the Gumbel noise of
    ``jax.random.gumbel(tie_key, (N, G))`` picks among the tied groups."""
    rng = np.random.default_rng(seed)
    r, m, n, g = 8, 3, 400, 6
    p4 = np.stack([rng.permutation(r)[:m] for _ in range(n)]).astype(np.int32)
    cent = np.zeros((g, r), np.float32)
    for row in range(1, g):
        cent[row, rng.choice(r, m, replace=False)] = 1.0
    tie_key = jax.random.PRNGKey(100 + seed)
    ref = np.asarray(j_assignment.assign_groups(
        jnp.asarray(p4), jnp.asarray(cent), r, decay="linear", tie_key=tie_key))
    noise = np.array(jax.random.gumbel(tie_key, (n, g)))
    got = t_assignment.assign_groups(torch.as_tensor(p4), torch.as_tensor(cent),
                                     r, decay="linear", tie_noise=noise)
    np.testing.assert_array_equal(got.numpy(), ref)
    lowest = t_assignment.assign_groups(torch.as_tensor(p4),
                                        torch.as_tensor(cent), r, decay="linear")
    assert (lowest.numpy() != ref).any()     # the random break was exercised
    with pytest.raises(ValueError):
        t_assignment.assign_groups(torch.as_tensor(p4), torch.as_tensor(cent),
                                   r, tie_noise=noise[:, :2])
    drawn = t_assignment.assign_groups(
        torch.as_tensor(p4), torch.as_tensor(cent), r, decay="linear",
        tie_noise=True, generator=torch.Generator().manual_seed(seed))
    assert drawn.shape == (n,) and int(drawn.max()) < g
