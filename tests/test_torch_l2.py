"""Kernel parity for ``pairwise_l2`` and ``qdots``: the plain PyTorch
versions against the JAX package's Pallas kernels (``interpret=True``) and
``kernels/ref.py`` oracles, the dense refine's dots against the expression
they replace, and the CUDA kernels against their plain versions on a card.

Values agree to rtol = atol = 1e-5 (fp32, other summation orders); on the
card a squared distance agrees to 1e-5·(‖q‖² + ‖x‖²), the cancellation
bound of ``‖q‖² − 2q·x + ‖x‖²``.  Tests marked ``cuda`` skip themselves
where no card is present; run them on one with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_l2.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.l2 import (pairwise_l2, pairwise_l2_plain, qdots,  # noqa: E402
                                    qdots_plain)
from repro_torch.kernels.refine_topk import masked_distances  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
L2_SHAPES = [(1, 1, 8), (7, 13, 32), (64, 200, 128), (33, 511, 256),
             (31, 64, 16), (32, 64, 16), (33, 64, 16)]
QDOT_SHAPES = [(1, 4, 8), (5, 37, 64), (16, 256, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jl2():
    """The JAX package's l2 kernels, oracles and ops (CPU, interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import l2 as jl2_mod
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jl2_mod, jref, jops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions ≡ the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,c,n", L2_SHAPES)
def test_pairwise_l2_plain_matches_pallas_and_ref(jl2, q, c, n):
    jnp, jl2_mod, jref, _ = jl2
    a, b = rand(q * 1000 + c, q, n), rand(c * 7 + n, c, n)
    got = pairwise_l2_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    # blocks of 32 × 64 leave ragged tails on both axes
    want = jl2_mod.pairwise_l2(jnp.asarray(a), jnp.asarray(b), block_q=32,
                               block_c=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.pairwise_l2_ref(
        jnp.asarray(a), jnp.asarray(b))), **TOL)
    assert torch.equal(ref.pairwise_l2_ref(torch.as_tensor(a), torch.as_tensor(b)),
                       torch.as_tensor(got))
    assert (got >= 0).all()


@pytest.mark.parametrize("q,c,n", QDOT_SHAPES)
def test_qdots_plain_matches_pallas_and_ref(jl2, q, c, n):
    jnp, jl2_mod, jref, _ = jl2
    a, rows = rand(c, q, n), rand(c + 1, q, c, n)
    got = qdots_plain(torch.as_tensor(a), torch.as_tensor(rows)).numpy()
    want = jl2_mod.qdots(jnp.asarray(a), jnp.asarray(rows), block_c=32,
                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.qdots_ref(
        jnp.asarray(a), jnp.asarray(rows))), **TOL)
    assert torch.equal(ref.qdots_ref(torch.as_tensor(a), torch.as_tensor(rows)),
                       torch.as_tensor(got))


def test_batched_query_dots_matches_reference(jl2):
    jnp, _, _, jops = jl2
    q, rows = rand(2, 4, 32), rand(3, 4, 3, 17, 32)
    got = ops.batched_query_dots(torch.as_tensor(q), torch.as_tensor(rows))
    assert got.shape == (4, 3, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.batched_query_dots(
        jnp.asarray(q), jnp.asarray(rows))), **TOL)
    np.testing.assert_allclose(got.numpy(), np.einsum("qn,qmcn->qmc", q, rows),
                               **TOL)


@pytest.mark.parametrize("shape", [(3, 5, 37, 16), (11, 4, 128, 64), (2, 1, 1, 7)])
def test_dense_refine_dots_are_unchanged_on_cpu(shape):
    """Through ``batched_query_dots`` the dense refine's dots are the
    expression it had before, bit for bit."""
    qn, mp, cap, n = shape
    rows, q = torch.as_tensor(rand(0, *shape)), torch.as_tensor(rand(1, qn, n))
    assert torch.equal(ops.batched_query_dots(q, rows),
                       (rows * q[:, None, None, :]).sum(dim=-1))
    # and the masked distances with the kernel's dot function equal the plain ones
    p = 6
    data = torch.as_tensor(rand(2, p, cap, n))
    norms = (data.double() ** 2).sum(-1).float()
    gen = np.random.default_rng(3)
    dfs = torch.as_tensor(gen.integers(0, 4, (p, cap)).astype(np.int32))
    gid = torch.arange(p * cap, dtype=torch.int32).reshape(p, cap)
    sp = torch.as_tensor(np.sort(gen.integers(-1, p, (qn, mp)), -1).astype(np.int32))
    lo = torch.zeros((qn, mp), dtype=torch.int32)
    hi = torch.full((qn, mp), 3, dtype=torch.int32)
    args = (data, norms, dfs, gid, q, sp, lo, hi)
    for a, b in zip(masked_distances(*args),
                    masked_distances(*args, dot_fn=ops.batched_query_dots)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# dispatch rules (no card needed)
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = ops.launch_counts()
    a, b, rows = (torch.as_tensor(rand(0, 5, 16)), torch.as_tensor(rand(1, 9, 16)),
                  torch.as_tensor(rand(2, 5, 9, 16)))
    assert torch.equal(pairwise_l2(a, b), pairwise_l2_plain(a, b))
    assert torch.equal(qdots(a, rows), qdots_plain(a, rows))
    assert ops.launch_counts() == before
    assert {"pairwise_l2", "qdots"} <= set(before)


@pytest.mark.parametrize("wrapper", ["pairwise_l2", "qdots"])
def test_other_devices_raise(wrapper):
    q = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        if wrapper == "pairwise_l2":
            ops.pairwise_l2(q, torch.empty((8, 16)))
        else:
            ops.qdots(q, torch.empty((4, 8, 16)))


# ---------------------------------------------------------------------------
# CUDA kernels ≡ plain versions (run on a card)
# ---------------------------------------------------------------------------
def within_cancellation_bound(got, want, q, x2):
    tol = 1e-5 * ((q.double() ** 2).sum(-1, keepdim=True) + x2)
    return bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n", L2_SHAPES + [(64, 4099, 256), (5, 1027, 30),
                                               (130, 300, 256)])
def test_cuda_pairwise_l2_matches_plain(cuda, q, c, n):
    a = torch.as_tensor(rand(q, q, n)).to(cuda)
    b = torch.as_tensor(rand(c, c, n)).to(cuda)
    n0 = ops.launch_counts()["pairwise_l2"]
    got = ops.pairwise_l2(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_l2"] == n0 + 1
    want = pairwise_l2_plain(a, b)
    assert got.shape == (q, c) and bool((got >= 0).all())
    assert within_cancellation_bound(got, want, a, (b.double() ** 2).sum(-1)[None, :])


@pytest.mark.cuda
def test_cuda_pairwise_l2_on_a_row_slice(cuda):
    """A chunk of a larger dataset (a view at a row offset), as Dss scans it."""
    x = torch.as_tensor(rand(9, 3000, 64)).to(cuda)
    a = x[:7].contiguous()
    got = ops.pairwise_l2(a, x[1001:2500])
    want = pairwise_l2_plain(a, x[1001:2500])
    assert within_cancellation_bound(got, want, a,
                                     (x[1001:2500].double() ** 2).sum(-1)[None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n", QDOT_SHAPES + [(64, 3001, 256), (3, 50, 30)])
def test_cuda_qdots_matches_plain(cuda, q, c, n):
    a = torch.as_tensor(rand(c, q, n)).to(cuda)
    rows = torch.as_tensor(rand(c + 1, q, c, n)).to(cuda)
    n0 = ops.launch_counts()["qdots"]
    got = ops.qdots(a, rows)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qdots"] == n0 + 1
    want = qdots_plain(a, rows)
    assert within_cancellation_bound(got, want, a, (rows.double() ** 2).sum(-1))
    # one summation order per row: the same row gives the same dot in any batch
    assert torch.equal(ops.qdots(a[:1], rows[:1, : c // 2 + 1]),
                       got[:1, : c // 2 + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n", [(7, 4099, 256), (5, 1, 256), (6, 333, 37),
                                   (4, 250, 255), (3, 301, 516), (2, 77, 1024)])
def test_cuda_qdots_tiles_and_widths(cuda, q, c, n):
    """C not a multiple of the 4-row tile; n not a multiple of 4 and n above
    the register path's 512 (both take the scalar-load kernel)."""
    a = torch.as_tensor(rand(n, q, n)).to(cuda)
    rows = torch.as_tensor(rand(n + 1, q, c, n)).to(cuda)
    got = ops.qdots(a, rows)
    torch.cuda.synchronize()
    assert within_cancellation_bound(got, qdots_plain(a, rows), a,
                                     (rows.double() ** 2).sum(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 256, 384, 512])
def test_cuda_qdots_unaligned_rows_sum_in_the_same_order(cuda, n):
    """Rows 4 bytes off a 16-byte boundary take the scalar-load kernel; it
    sums each row in the register kernel's order, so the dots are equal."""
    q, c = 3, 129
    a = torch.as_tensor(rand(1, q, n)).to(cuda)
    flat = torch.as_tensor(rand(2, q * c * n + 1)).to(cuda)
    off = flat[1:].view(q, c, n)
    assert off.data_ptr() % 16 == 4
    got = ops.qdots(a, off)
    assert torch.equal(got, ops.qdots(a, off.clone()))
    assert within_cancellation_bound(got, qdots_plain(a, off), a,
                                     (off.double() ** 2).sum(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n", [(1, 1000, 256), (63, 257, 256), (65, 4099, 30),
                                   (130, 700, 384), (64, 100, 384), (130, 255, 30),
                                   (2, 3, 256)])
def test_cuda_pairwise_l2_query_tiles_candidate_tiles_and_widths(cuda, q, c, n):
    """Q around the 64-query tile (1, 63, 65, 130), C not a multiple of the
    256-row tile and below one tile, n = 30 (no float4 rows), 256, and 384
    (two resident 256-deep query chunks)."""
    a = torch.as_tensor(rand(q + n, q, n)).to(cuda)
    b = torch.as_tensor(rand(c + n, c, n)).to(cuda)
    got = ops.pairwise_l2(a, b)
    torch.cuda.synchronize()
    assert got.shape == (q, c) and bool((got >= 0).all())
    assert within_cancellation_bound(got, pairwise_l2_plain(a, b), a,
                                     (b.double() ** 2).sum(-1)[None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 30])
def test_cuda_pairwise_l2_bits_depend_on_n_alone(cuda, n):
    """out[i, j] is summed in one order whatever the batch: one query's row
    alone equals its row in a batch of 64, a chunk at an odd row offset (and,
    at n = 256, a copy 4 bytes off a 16-byte boundary, which takes 4-byte
    copies) equals those columns of the whole scan."""
    x = torch.as_tensor(rand(11, 3001, n)).to(cuda)
    qs = torch.as_tensor(rand(12, 64, n)).to(cuda)
    whole = ops.pairwise_l2(qs, x)
    for i in (0, 31, 63):
        assert torch.equal(ops.pairwise_l2(qs[i:i + 1].contiguous(), x)[0], whole[i])
    assert torch.equal(ops.pairwise_l2(qs, x[777:2901]), whole[:, 777:2901])
    flat = torch.empty(x.numel() + 1, device=cuda)
    off = flat[1:].view_as(x)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    assert torch.equal(ops.pairwise_l2(qs, off), whole)
    assert within_cancellation_bound(whole, pairwise_l2_plain(qs, x), qs,
                                     (x.double() ** 2).sum(-1)[None, :])
