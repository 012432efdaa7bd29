"""Kernel parity: each kernel's plain PyTorch version against the JAX
package's Pallas kernel (``interpret=True``) and its ``kernels/ref.py``
oracle, plus the CUDA kernels against their plain versions on a card.

The JAX side is imported inside a fixture, so on a machine without JAX the
CUDA tests still collect.  Tests marked ``cuda`` skip themselves where no
card is present; run them on one with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import ctypes
import types

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels.paa_kernel import paa_plain, paa_sequential  # noqa: E402
from repro_torch.kernels.pivot_rank import pivot_distances_plain, pivot_rank_plain  # noqa: E402
from repro_torch.kernels import refine_topk as RT  # noqa: E402
from repro_torch.kernels.refine_topk import (PAD_D2, masked_distances, refine_topk,  # noqa: E402
                                             refine_topk_plain, refine_work)
from repro_torch.obs.registry import REGISTRY  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jk():
    """The JAX package's kernels and oracles (CPU, interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.paa_kernel import paa as jpaa
    from repro.kernels.pivot_rank import pivot_rank as jpivot_rank
    from repro.kernels.refine_topk import refine_topk as jrefine
    return jnp, jref, jpaa, jpivot_rank, jrefine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_store(seed, p=6, cap=37, n=16, ndfs=10):
    """A random partition store: partition i holds its first count[i] slots."""
    rng = np.random.default_rng(seed)
    count = rng.integers(cap // 2, cap + 1, size=p)
    data = rng.standard_normal((p, cap, n)).astype(np.float32)
    live = np.arange(cap)[None, :] < count[:, None]
    data[~live] = 0.0
    norms = np.sum(data.astype(np.float64) ** 2, -1).astype(np.float32)
    dfs = np.where(live, rng.integers(0, ndfs, size=(p, cap)), -1).astype(np.int32)
    gid = np.full((p, cap), -1, np.int32)
    gid[live] = rng.permutation(int(live.sum())).astype(np.int32)
    return data, norms, dfs, gid


def make_plan(seed, q, mp, p, ndfs=10, pad_frac=0.3, same_part=False):
    """A plan sorted by partition (pads first), with nested intervals on
    repeated partitions so the dedupe predicate has work."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, p, size=(q, mp))
    if same_part:
        part[:] = rng.integers(0, p)
    part = np.where(rng.random((q, mp)) < pad_frac, -1, part)
    lo = rng.integers(0, ndfs // 2, size=(q, mp))
    hi = lo + rng.integers(1, ndfs, size=(q, mp))
    order = np.argsort(part, axis=-1, kind="stable")
    take = lambda a: np.take_along_axis(a, order, -1).astype(np.int32)
    return take(part), take(lo), take(hi)


CASES = {
    # name: (store seed, plan kwargs, k)
    "mixed": (0, dict(q=4, mp=6), 20),
    "mostly_pads": (1, dict(q=3, mp=8, pad_frac=0.8), 15),
    "dedupe_one_partition": (2, dict(q=3, mp=5, same_part=True, pad_frac=0.0), 25),
    "pool_smaller_than_k": (3, dict(q=2, mp=2), 80),
}


def case_inputs(name):
    seed, kw, k = CASES[name]
    store = make_store(seed)
    sp, lo, hi = make_plan(seed + 10, p=store[0].shape[0], **kw)
    if name == "mostly_pads":
        sp[0] = -1                       # one all-masked plan row
    q = np.random.default_rng(seed + 20).standard_normal(
        (sp.shape[0], store[0].shape[2])).astype(np.float32)
    return store, q, (sp, lo, hi), k


def assert_topk_match(d_a, g_a, d_b, g_b, q, norms):
    """gids equal; squared distances within 1e-5·(‖q‖² + max ‖x‖²).

    The Pallas kernel leaves an arbitrary gid beside a +inf pad distance
    (``core/refine.py`` maps those to -1), so pads compare by distance."""
    g_b = np.where(d_b >= PAD_D2, -1, g_b)
    np.testing.assert_array_equal(g_a, g_b)
    pad = d_b >= PAD_D2
    np.testing.assert_array_equal(d_a >= PAD_D2, pad)
    tol = 1e-5 * ((q * q).sum(-1, keepdims=True) + norms.max())
    assert np.all(np.where(pad, 0.0, np.abs(d_a - d_b)) <= tol)


# ---------------------------------------------------------------------------
# plain versions ≡ the JAX package (CPU)
# ---------------------------------------------------------------------------
def test_paa_plain_matches_pallas_and_ref(jk):
    jnp, jref, jpaa, _, _ = jk
    x = np.random.default_rng(0).standard_normal((37, 64)).astype(np.float32)
    got = paa_plain(torch.as_tensor(x), 8).numpy()
    np.testing.assert_allclose(got, np.asarray(jpaa(jnp.asarray(x), 8,
                                                    interpret=True)), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jref.paa_ref(jnp.asarray(x), 8)),
                               atol=1e-6)
    np.testing.assert_array_equal(ref.paa_ref(torch.as_tensor(x), 8).numpy(), got)


@pytest.mark.parametrize("n,w", [(256, 16), (2048, 16), (120, 12), (36, 4)])
def test_paa_sequential_matches_plain_and_reference(jk, n, w):
    """The kernel's order (one sample at a time) against the plain mean and
    the reference, within 1e-6·max|x|: they sum in other orders."""
    jnp, jref, jpaa, _, _ = jk
    x = np.random.default_rng(n + w).standard_normal((37, n)).astype(np.float32)
    got = paa_sequential(torch.as_tensor(x), w).numpy()
    atol = 1e-6 * float(np.abs(x).max())
    np.testing.assert_allclose(got, paa_plain(torch.as_tensor(x), w).numpy(),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jpaa(jnp.asarray(x), w, interpret=True)),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jref.paa_ref(jnp.asarray(x), w)),
                               rtol=0, atol=atol)


def tied_pivot_inputs(seed, rows, w, r=200, distinct=20):
    """Integer rows and pivots drawn from ``distinct`` rows, each repeated:
    every squared distance is exact in fp32, and ties are everywhere."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, size=(distinct, w)).astype(np.float32)
    piv = base[rng.integers(0, distinct, size=r)]
    z = rng.integers(-3, 4, size=(rows, w)).astype(np.float32)
    return z, piv


@pytest.mark.parametrize("w,m", [(16, 1), (16, 10), (16, 32), (8, 5)])
def test_pivot_rank_plain_ties_go_to_the_lower_id(jk, w, m):
    """The plain version, the card tests' oracle, breaks exact ties toward
    the lower pivot id as the Pallas kernel and ``lax.top_k`` do."""
    jnp, jref, _, jpivot_rank, _ = jk
    z, piv = tied_pivot_inputs(w * m, 96, w)
    got = pivot_rank_plain(torch.as_tensor(z), torch.as_tensor(piv), m).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpivot_rank(jnp.asarray(z), jnp.asarray(piv), m,
                                    interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jref.pivot_rank_ref(jnp.asarray(z), jnp.asarray(piv), m)))


def test_pivot_rank_plain_matches_pallas_and_ref(jk):
    jnp, jref, _, jpivot_rank, _ = jk
    rng = np.random.default_rng(1)
    z = rng.standard_normal((300, 16)).astype(np.float32)
    piv = rng.standard_normal((40, 16)).astype(np.float32)
    got = pivot_rank_plain(torch.as_tensor(z), torch.as_tensor(piv), 10).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpivot_rank(jnp.asarray(z), jnp.asarray(piv), 10,
                                    interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jref.pivot_rank_ref(jnp.asarray(z), jnp.asarray(piv), 10)))
    assert torch.equal(ref.pivot_rank_ref(torch.as_tensor(z), torch.as_tensor(piv), 10),
                       torch.as_tensor(got))


@pytest.mark.parametrize("name", sorted(CASES))
def test_refine_plain_matches_pallas_kernel(jk, name):
    jnp, jref, _, _, jrefine = jk
    store, q, plan, k = case_inputs(name)
    d_t, g_t = refine_topk_plain(*map(torch.as_tensor, store), torch.as_tensor(q),
                                 *map(torch.as_tensor, plan), k)
    # block 16 leaves a ragged tail: cap = 37 is no multiple of it
    d_j, g_j = jrefine(*map(jnp.asarray, store), jnp.asarray(q),
                       *map(jnp.asarray, plan), k, block_c=16, interpret=True)
    assert_topk_match(d_t.numpy(), g_t.numpy(), np.asarray(d_j), np.asarray(g_j),
                      q, store[1])
    d_r, g_r = jref.refine_topk_ref(*map(jnp.asarray, store), jnp.asarray(q),
                                    *map(jnp.asarray, plan), k)
    assert_topk_match(d_t.numpy(), g_t.numpy(), np.asarray(d_r), np.asarray(g_r),
                      q, store[1])
    if name == "mostly_pads":
        assert (g_t[0] == -1).all() and (d_t[0] >= PAD_D2).all()
    if name == "pool_smaller_than_k":
        assert (g_t[:, -1] == -1).all()


def test_device_plan_wrapper_sorts_the_plan():
    store, q, (sp, lo, hi), k = case_inputs("mixed")
    perm = np.random.default_rng(5).permutation(sp.shape[1])
    args = [torch.as_tensor(a) for a in store]
    sorted_out = ops.fused_refine_topk(*args, torch.as_tensor(q), *map(
        torch.as_tensor, (sp, lo, hi)), k)
    shuffled_out = ops.fused_refine_topk_device_plan(
        *args, torch.as_tensor(q), *(torch.as_tensor(a[:, perm]) for a in (sp, lo, hi)), k)
    # same entries, other order: the same record set and distances
    assert torch.equal(sorted_out[0], shuffled_out[0])
    assert set(sorted_out[1].flatten().tolist()) == set(shuffled_out[1].flatten().tolist())


# ---------------------------------------------------------------------------
# dispatch rules (no card needed)
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = ops.launch_counts()
    store, q, plan, k = case_inputs("mixed")
    d, g = refine_topk(*map(torch.as_tensor, store), torch.as_tensor(q),
                       *map(torch.as_tensor, plan), k)
    d_p, g_p = refine_topk_plain(*map(torch.as_tensor, store), torch.as_tensor(q),
                                 *map(torch.as_tensor, plan), k)
    assert torch.equal(d, d_p) and torch.equal(g, g_p)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["paa", "pivot_rank"])
def test_other_devices_raise(wrapper):
    """A device with neither a kernel nor a plain path, or tensors on two
    devices, raise (``meta`` is the card's route in a dry-run)."""
    meta = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        if wrapper == "paa":
            ops.paa(types.SimpleNamespace(device=torch.device("xpu")), 4)
        else:
            ops.pivot_rank(meta, torch.empty((8, 16)), 3)


def test_kernel_library_sources_and_hash():
    names = sorted(p.name for p in _lib.sources())
    assert names == ["l2.cu", "paa.cu", "pivot_rank.cu", "refine_topk.cu"]
    h = _lib.source_hash()
    assert len(h) == 16 and h == _lib.source_hash()
    assert all(f in " ".join(_lib.NVCC_FLAGS) for f in ("sm_90a", "-O3"))


# ---------------------------------------------------------------------------
# CUDA kernels ≡ plain versions (run on a card)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_paa_matches_plain(cuda):
    x = torch.randn((1000, 256), generator=torch.Generator().manual_seed(0)).to(cuda)
    n0 = ops.launch_counts()["paa"]
    got = ops.paa(x, 16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paa"] == n0 + 1
    assert float((got - paa_plain(x, 16)).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,w,offset", [
    (1000, 256, 16, 0), (64, 256, 16, 0), (4099, 2048, 16, 0), (3, 2048, 16, 0),
    (777, 120, 12, 0),      # seg 10: the 4-byte path
    (1000, 256, 16, 1),     # base 4 B past a 16-byte boundary: the 4-byte path
])
def test_cuda_paa_bit_equal_to_sequential(cuda, b, n, w, offset):
    """The kernel sums in :func:`paa_sequential`'s order: the same bits,
    ragged last tiles, both chunk widths and a misaligned view included."""
    flat = torch.randn(b * n + offset, generator=torch.Generator().manual_seed(b + n))
    x = flat.to(cuda)[offset:].view(b, n)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 4 * offset)
    n0 = ops.launch_counts()["paa"]
    got = ops.paa(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paa"] == n0 + 1
    assert torch.equal(got.cpu(), paa_sequential(flat[offset:].view(b, n), w))


@pytest.mark.cuda
def test_cuda_paa_refuses_segments_beyond_shared_memory(cuda):
    with pytest.raises(RuntimeError, match="paa"):
        ops.paa(torch.zeros((1, 32768), device=cuda), 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,m", [(16, 10), (8, 5)])
def test_cuda_pivot_rank_matches_plain(cuda, w, m):
    g = torch.Generator().manual_seed(1)
    z = torch.randn((5000, w), generator=g).to(cuda)
    piv = torch.randn((200, w), generator=g).to(cuda)
    got = ops.pivot_rank(z, piv, m)
    want = pivot_rank_plain(z, piv, m)
    bad = (got != want).any(1)
    if bad.any():      # only near-ties may differ
        d = pivot_distances_plain(z[bad], piv).double()
        gap = (torch.gather(d, 1, got[bad].long()) - torch.gather(d, 1, want[bad].long()))
        assert float(gap.abs().max()) <= 1e-4
    assert float(bad.float().mean()) < 0.01


def pivot_rank_lanes(z, piv, m, lanes):
    """The kernel with ``lanes`` lanes per row forced through its C entry
    (the wrapper passes 0: picked from the batch)."""
    out = torch.empty((z.shape[0], m), dtype=torch.int32, device=z.device)
    _lib.check(_lib.library().climber_pivot_rank(
        z.data_ptr(), piv.data_ptr(), out.data_ptr(), z.shape[0], z.shape[1],
        piv.shape[0], m, lanes, _lib.stream(z.device)), "pivot_rank")
    return out


def assert_near_ties_only(got, want, z, piv, tol=1e-4):
    """Rows of two P4→ signatures may differ only where the distances they
    pick differ by at most ``tol`` (a near-tie under another rounding)."""
    bad = (got != want).any(1)
    if bad.any():
        d = pivot_distances_plain(z[bad], piv).double()
        gap = (torch.gather(d, 1, got[bad].long()) - torch.gather(d, 1, want[bad].long()))
        assert float(gap.abs().max()) <= tol
    assert float(bad.float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64, 2 ** 18 + 7])
def test_cuda_pivot_rank_any_batch_any_lane_group(cuda, b):
    """One lane per row (the build's chunks), a warp per row (a query batch)
    and the width picked from B give the same answer bit for bit."""
    g = torch.Generator().manual_seed(b)
    z = torch.randn((b, 16), generator=g).to(cuda)
    piv = torch.randn((200, 16), generator=g).to(cuda)
    got = {lanes: pivot_rank_lanes(z, piv, 10, lanes) for lanes in (0, 1, 32)}
    assert torch.equal(got[0], ops.pivot_rank(z, piv, 10))
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[32])
    assert_near_ties_only(got[0], pivot_rank_plain(z, piv, 10), z, piv)


@pytest.mark.cuda
@pytest.mark.parametrize("w,m,r", [(16, 10, 200), (4, 1, 3), (8, 5, 40),
                                   (32, 16, 97), (64, 20, 200), (16, 32, 33)])
def test_cuda_pivot_rank_list_lengths_and_widths(cuda, w, m, r):
    """The exact m = 10 list and the 16- and 32-long lists with a runtime m,
    at every lane-group width."""
    g = torch.Generator().manual_seed(w * m + r)
    z = torch.randn((3000, w), generator=g).to(cuda)
    piv = torch.randn((r, w), generator=g).to(cuda)
    want = pivot_rank_plain(z, piv, m)
    first = None
    for lanes in (1, 2, 4, 8, 16, 32):
        got = pivot_rank_lanes(z, piv, m, lanes)
        first = got if first is None else first
        assert torch.equal(got, first)
    assert_near_ties_only(first, want, z, piv)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_cuda_pivot_rank_ties_go_to_the_lower_id(cuda, lanes):
    """Duplicated pivot rows, integer data: every distance is exact in fp32,
    so the kernel must give the plain version's (distance, id) order."""
    z, piv = (torch.as_tensor(a).to(cuda) for a in tied_pivot_inputs(7, 4099, 16))
    got = pivot_rank_lanes(z, piv, 10, lanes)
    torch.cuda.synchronize()
    assert torch.equal(got, pivot_rank_plain(z, piv, 10))


@pytest.mark.cuda
def test_cuda_pivot_rank_refuses_pivots_beyond_shared_memory(cuda):
    z, piv = torch.zeros((4, 64), device=cuda), torch.zeros((4000, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.pivot_rank(z, piv, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_refine_matches_plain(cuda, name):
    store, q, plan, k = case_inputs(name)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, *plan)]
    d_k, g_k = refine_topk(*args, k)
    d_1, g_1 = refine_topk(*args, k, splits=1)
    d_g, g_g = RT._partition_major(*args, k, group=1, lists=1)
    torch.cuda.synchronize()
    # the answer does not depend on the design or how its work was divided:
    # one block a query; one query a block and one list a query (every
    # partition's k best merged into it under its lock)
    assert torch.equal(d_k, d_1) and torch.equal(g_k, g_1)
    assert torch.equal(d_k, d_g) and torch.equal(g_k, g_g)
    d_p, g_p = refine_topk_plain(*args, k)
    assert_topk_match(d_k.cpu().numpy(), g_k.cpu().numpy(), d_p.cpu().numpy(),
                      g_p.cpu().numpy(), q, store[1])


# ---------------------------------------------------------------------------
# the refine's work count (CPU) and the redesigned kernel at size (card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_refine_work_counts_the_plain_versions_kept_slots(name):
    """``refine_work`` (the smoke's bound and the variants tool's counts)
    counts exactly the (query, record) pairs the plain refine keeps, and
    the distinct records behind them."""
    store, q, plan, k = case_inputs(name)
    t = [torch.as_tensor(a) for a in (*store, q, *plan)]
    work = refine_work(t[2], t[3], *t[5:])
    d2, _ = masked_distances(*t)
    kept = (d2 < PAD_D2).reshape(q.shape[0], plan[0].shape[1], -1).numpy()
    cap = store[1].shape[1]
    slots = {(int(max(plan[0][i, s], 0)) * cap + c)
             for i, s, c in zip(*np.nonzero(kept))}
    assert work["kept_pairs"] == int(kept.sum())
    assert work["unique_kept_records"] == len(slots)
    assert work["live_slots"] == int((plan[0] >= 0).sum()) * cap


def assert_refine_rule(d_k, g_k, d_p, g_p, q, norms):
    """The smoke's refine rule: |Δd²| ≤ 1e-5·(‖q‖² + max ‖x‖²) position by
    position, and answer sets that differ only at the k-th distance."""
    tol = 1e-5 * ((q.double() ** 2).sum(-1, keepdim=True) + float(norms.max()))
    assert bool(((d_k.double() - d_p.double()).abs() <= tol).all())
    for i in (g_k != g_p).any(1).nonzero()[:, 0].tolist():
        extra = ~torch.isin(g_k[i], g_p[i])
        assert bool(((d_k[i][extra].double() - d_p[i, -1].double()).abs() <= tol[i]).all())


def big_refine_inputs(seed, q=64, p=12, cap=4100, n=256, mp=8, ndfs=4, pad_frac=0.2):
    """A store with cap > 4,000 and a batch whose plans share partitions."""
    store = make_store(seed, p=p, cap=cap, n=n, ndfs=ndfs)
    sp, lo, hi = make_plan(seed + 1, q=q, mp=mp, p=p, ndfs=ndfs, pad_frac=pad_frac)
    qs = np.random.default_rng(seed + 2).standard_normal((q, n)).astype(np.float32)
    return store, qs, (sp, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 30, 384])
def test_cuda_refine_k500_shared_partitions_any_split(cuda, n):
    """k = 500 over cap 4,100, 64 queries sharing 12 partitions, one all-pad
    row, rows of 256 floats (the configuration's width), 30 (scalar loads)
    and 384 (float4 loads in runtime loops): the kernel keeps the rule
    against the plain version, and either design, with any number of blocks
    a query, of queries a block or of lists a query, gives the same bits."""
    store, q, (sp, lo, hi) = big_refine_inputs(3, n=n)
    sp[5] = -1                                          # an all-pad row
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    lib = _lib.library()
    most = next(s for s in range(64, 0, -1)
                if lib.climber_refine_merge_smem(s, 500) <= _lib.SMEM_LIMIT)
    n0 = ops.launch_counts()
    qm, pm = RT._query_major, RT._partition_major
    divisions = {"default": (refine_topk, {}), "one block": (refine_topk, dict(splits=1)),
                 "most blocks": (qm, dict(splits=RT.pick_splits(500))),
                 "one query": (pm, dict(group=1)), "odd": (pm, dict(group=5, lists=3)),
                 "most lists": (pm, dict(group=16, lists=most))}
    got = {name: fn(*args, 500, **kw) for name, (fn, kw) in divisions.items()}
    torch.cuda.synchronize()
    # every call counts as a refine_topk launch; those of the partition-major
    # design (the three here, and the default where the rule takes it) also
    # count as that design's
    n1 = ops.launch_counts()
    assert n1["refine_topk"] == n0["refine_topk"] + len(divisions)
    default_pm = 64 * sp.shape[1] >= RT.PARTITION_MAJOR_MIN * store[1].shape[0]
    assert n1["refine_topk.partition_major"] == \
        n0["refine_topk.partition_major"] + 3 + default_pm
    for name in divisions:
        assert torch.equal(got["default"][0], got[name][0])
        assert torch.equal(got["default"][1], got[name][1])
    d_k, g_k = got["default"]
    assert bool((g_k[5] == -1).all()) and bool((d_k[5] >= PAD_D2).all())
    d_p, g_p = refine_topk_plain(*args, 500)
    assert_refine_rule(d_k, g_k, d_p, g_p, args[4], args[1])


@pytest.mark.cuda
def test_cuda_refine_pool_beyond_every_block_scratch(cuda):
    """Three queries over 10 fully kept entries of cap 4,100: 41,000 kept
    rows each, past a block's list of kept slots and its key buffer (merged
    or cut many times), in both designs; with one list a query every
    partition's k best is merged into it."""
    store = make_store(4, p=10, cap=4100, n=64, ndfs=1)
    q = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    sp = np.tile(np.arange(10, dtype=np.int32), (3, 1))
    lo, hi = np.zeros_like(sp), np.ones_like(sp)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    d1, g1 = refine_topk(*args, 500, splits=1)
    d_all, g_all = refine_topk(*args, 500)
    d_pm, g_pm = RT._partition_major(*args, 500, group=2, lists=1)
    torch.cuda.synchronize()
    assert torch.equal(d1, d_all) and torch.equal(g1, g_all)
    assert torch.equal(d1, d_pm) and torch.equal(g1, g_pm)
    assert bool((g1 >= 0).all())
    d_p, g_p = refine_topk_plain(*args, 500)
    assert_refine_rule(d1, g1, d_p, g_p, args[4], args[1])


@pytest.mark.cuda
def test_cuda_refine_query_alone_equals_its_row_in_a_shared_batch(cuda):
    """A query's answer does not depend on the batch it rides in, nor on the
    other queries that share its partitions, in either design: bit-equal
    alone and in 64."""
    store, q, (sp, lo, hi) = big_refine_inputs(6, pad_frac=0.0)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    d64, g64 = refine_topk(*args, 500)
    d64_pm, g64_pm = RT._partition_major(*args, 500, group=16)
    assert torch.equal(d64, d64_pm) and torch.equal(g64, g64_pm)
    for i in (0, 17, 63):
        one = [a[i:i + 1].contiguous() for a in args[4:]]
        d1, g1 = refine_topk(*args[:4], *one, 500)
        assert torch.equal(d1[0], d64[i]) and torch.equal(g1[0], g64[i])


def tied_refine_inputs(seed, q=1024, p=16, cap=512, n=256, mp=6, ndfs=6):
    """Integer rows and queries (every dot, norm and d² exact in fp32, so
    the kernel's d² is the plain version's bit for bit), each row repeated
    in several slots (d² ties everywhere), and a batch of ``q`` queries over
    ``p`` partitions, each naming partitions in overlapping intervals."""
    rng = np.random.default_rng(seed)
    store = list(make_store(seed, p=p, cap=cap, n=n, ndfs=ndfs))
    base = rng.integers(-3, 4, size=(cap // 4, n)).astype(np.float32)
    live = store[3] >= 0
    data = base[rng.integers(0, base.shape[0], size=(p, cap))]
    data[~live] = 0.0
    store[0] = data
    store[1] = np.sum(data.astype(np.float64) ** 2, -1).astype(np.float32)
    sp, lo, hi = make_plan(seed + 1, q=q, mp=mp, p=p, ndfs=ndfs, pad_frac=0.1)
    qs = rng.integers(-3, 4, size=(q, n)).astype(np.float32)
    return store, qs, (sp, lo, hi)


@pytest.mark.cuda
def test_cuda_refine_heavily_shared_batch_ties_to_the_lowest_flat_index(cuda):
    """1,024 queries over 16 partitions (about 300 queries a partition,
    overlapping intervals, repeated partitions), rows repeated so d² ties
    everywhere, all arithmetic exact: the kernel's answer (the partition-
    major design's, at this sharing) is the plain version's bit for bit,
    ties going to the lowest flat index; and a query alone (the query-major
    design's) is bit-equal to its row in the batch."""
    store, q, plan = tied_refine_inputs(11)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, *plan)]
    assert 1024 * plan[0].shape[1] >= RT.PARTITION_MAJOR_MIN * 16
    d_k, g_k = refine_topk(*args, 500)
    d_p, g_p = refine_topk_plain(*args, 500)
    torch.cuda.synchronize()
    assert_refine_rule(d_k, g_k, d_p, g_p, args[4], args[1])
    assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)
    for i in (0, 511, 1023):
        one = [a[i:i + 1].contiguous() for a in args[4:]]
        d1, g1 = refine_topk(*args[:4], *one, 500)
        assert torch.equal(d1[0], d_k[i]) and torch.equal(g1[0], g_k[i])


@pytest.mark.cuda
def test_cuda_refine_repeated_partition_attributes_to_the_first_entry(cuda):
    """One query names partition 3 in two entries whose intervals overlap:
    a record both cover is kept once, at the first entry, so with equal d²
    it ranks before a record only the second entry keeps; the answer is the
    plain version's bit for bit (exact integer arithmetic)."""
    store, _, _ = tied_refine_inputs(12, q=1, p=8, cap=256, n=64)
    q = np.random.default_rng(13).integers(-3, 4, size=(1, 64)).astype(np.float32)
    sp = np.array([[-1, 1, 3, 3, 6]], np.int32)
    lo = np.array([[0, 0, 1, 0, 2]], np.int32)
    hi = np.array([[0, 6, 4, 6, 5]], np.int32)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    d_k, g_k = refine_topk(*args, 300)
    d_pm, g_pm = RT._partition_major(*args, 300, group=1)
    d_p, g_p = refine_topk_plain(*args, 300)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)
    assert torch.equal(d_pm, d_p) and torch.equal(g_pm, g_p)
    kept = g_k[g_k >= 0]
    assert kept.numel() == torch.unique(kept).numel()        # each record once


@pytest.mark.cuda
def test_cuda_refine_lm_width_k16(cuda):
    """The kNN-LM's shapes: rows of 2,048 floats, K = 16, 64 queries sharing
    partitions: the rule against the plain version, and the same bits with
    the partition-major design with one list and one query a block."""
    store, q, (sp, lo, hi) = big_refine_inputs(21, q=64, p=24, cap=300, n=2048, mp=12)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    d_k, g_k = refine_topk(*args, 16)
    d_1, g_1 = RT._partition_major(*args, 16, group=1, lists=1)
    d_p, g_p = refine_topk_plain(*args, 16)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_1) and torch.equal(g_k, g_1)
    assert_refine_rule(d_k, g_k, d_p, g_p, args[4], args[1])


# ---------------------------------------------------------------------------
# refine.queries_per_partition (CPU)
# ---------------------------------------------------------------------------
def test_plan_sharing_counts_query_partition_pairs():
    """A hand-made plan: query 0 names partitions 2, 5, 5 (one pair twice),
    query 1 names 5 and 7, query 2 only pads: 4 live (query, partition)
    pairs over 3 distinct partitions."""
    sp = torch.tensor([[-1, 2, 5, 5], [-1, -1, 5, 7], [-1, -1, -1, -1]], dtype=torch.int32)
    assert RT.plan_sharing(sp) == (4, 3)
    assert RT.plan_sharing(torch.full((2, 3), -1, dtype=torch.int32)) == (0, 0)


def test_cpu_refine_observes_sharing_once_per_call():
    """Each refine call on the plain path records one observation: live
    (query, partition) pairs over distinct partitions, from its plan."""
    store, q, (sp, lo, hi), k = case_inputs("mixed")
    t = [torch.as_tensor(a) for a in (*store, q, sp, lo, hi)]
    pairs, parts = RT.plan_sharing(t[5])
    h = REGISTRY.histogram(RT.SHARING)
    n0, s0 = h.count, h.sum
    for i in range(3):
        refine_topk(*t, k)
        assert h.count == n0 + i + 1
    assert h.sum - s0 == pytest.approx(3 * pairs / parts)


class _Landed:
    """A stand-in for a CUDA event: landed or not."""

    def __init__(self, landed):
        self.landed = landed
        self.waited = False

    def query(self):
        return self.landed

    def synchronize(self):
        self.waited = True


def test_sharing_readback_observes_landed_counts_in_call_order():
    """The card's counts are observed once each, in call order, when their
    copy has landed; a count still in flight (and every later one) waits
    for a later call or for a flush."""
    rb = RT._SharingReadback()
    h = REGISTRY.histogram(RT.SHARING)
    n0, s0 = h.count, h.sum
    late = _Landed(False)
    rb._pending = [(_Landed(True), torch.tensor([10, 5])), (late, torch.tensor([9, 3])),
                   (_Landed(True), torch.tensor([8, 8]))]
    rb.drain()
    assert h.count == n0 + 1 and h.sum - s0 == pytest.approx(2.0)
    rb.drain()
    assert h.count == n0 + 1
    rb.drain(wait=True)
    assert late.waited and h.count == n0 + 3
    assert h.sum - s0 == pytest.approx(2.0 + 3.0 + 1.0)
    rb.drain(wait=True)
    assert h.count == n0 + 3


@pytest.mark.parametrize("qn, design", [(31, "query_major"), (32, "partition_major")])
def test_refine_design_follows_plan_entries_per_partition(monkeypatch, qn, design):
    """On the card a call takes the partition-major design from
    ``PARTITION_MAJOR_MIN`` plan entries a partition (``Q · MP / P``, pads
    included) and the query-major one below; ``splits`` takes the
    query-major design at any sharing.  (CPU tensors, the card's route
    forced, the designs stubbed.)"""
    calls = []
    monkeypatch.setattr(RT._lib, "on_card", lambda *t: True)
    for name in ("_partition_major", "_query_major"):
        monkeypatch.setattr(RT, name, lambda *a, _n=name[1:], **kw: calls.append((_n, kw)))
    p, cap, n = 2, 4, 8
    mp = RT.PARTITION_MAJOR_MIN * p // 32              # 32 queries meet the rule
    store = (torch.zeros((p, cap, n)), torch.zeros((p, cap)),
             torch.zeros((p, cap), dtype=torch.int32), torch.zeros((p, cap), dtype=torch.int32))
    plan = [torch.zeros((qn, mp), dtype=torch.int32) for _ in range(3)]
    RT.refine_topk(*store, torch.zeros((qn, n)), *plan, 5)
    RT.refine_topk(*store, torch.zeros((qn, n)), *plan, 5, splits=3)
    first = {"ragged": None} if design == "partition_major" else {"splits": None,
                                                                   "ragged": None}
    assert calls == [(design, first), ("query_major", {"splits": 3, "ragged": None})]


def test_c_signatures_match_the_kernel_sources():
    """Every C entry the package binds is declared in ``csrc/`` with as many
    arguments, each a pointer where the binding passes one and an integer
    where it passes one."""
    import re
    decl = {}
    for src in _lib.sources():
        text = src.read_text()
        for m in re.finditer(r"CLIMBER_API\s+[\w\s*]+?\b(climber_\w+)\s*\(([^)]*)\)", text):
            args = [a.strip() for a in m.group(2).split(",") if a.strip()]
            decl[m.group(1)] = ["p" if "*" in a else "i" for a in args]
    for name, (_, argtypes) in _lib._SIGNATURES.items():
        assert name in decl, name
        kinds = ["p" if a is ctypes.c_void_p else "i" for a in argtypes]
        assert kinds == decl[name], name


@pytest.mark.cuda
def test_cuda_refine_observes_sharing_once_per_call_in_either_design(cuda):
    """On the card each call, of either design, records one observation of
    ``refine.queries_per_partition``, the plan's own pairs over partitions,
    once its counts have landed."""
    store, q, (sp, lo, hi) = big_refine_inputs(31)
    args = [torch.as_tensor(a).to(cuda) for a in (*store, q, sp, lo, hi)]
    pairs, parts = RT.plan_sharing(args[5].cpu())
    h = REGISTRY.histogram(RT.SHARING)
    RT.flush_sharing()
    n0, s0 = h.count, h.sum
    RT._query_major(*args, 500)
    RT._partition_major(*args, 500)
    refine_topk(*args, 500)
    RT.flush_sharing()
    assert h.count == n0 + 3
    assert h.sum - s0 == pytest.approx(3 * pairs / parts)
