"""The ragged store (``ClimberConfig.partition_pad = 0``): each partition
holds exactly its records, and the index answers as the dense store does.

On the CPU: a SIFT-shaped build whose fullest partition is over 10x the
mean holds the dense build's records partition by partition, serves the
same answers bit for bit, passes the benchmark's check against its plain
reference (and fails it when refine reads one row past a partition), and
every path that takes only dense stores refuses it.  Marked ``cuda``: both
designs of the refine kernel on a ragged store against its dense view,
including a partition cut into several slot ranges, and the item tail
observed once a partition-major call.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.index import (PartitionStore, RaggedStore, build_index,  # noqa: E402
                                    live_bytes, sample_size, store_bytes)
from repro_torch.data.series import sift_like  # noqa: E402
from repro_torch.kernels import refine_topk as RT  # noqa: E402
from repro_torch.obs.registry import REGISTRY  # noqa: E402
from repro_torch.serve.knn_engine import ClimberEngine  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROWS, HOT = 6000, 600
# the benchmark's sift cell, cut to a size the CPU holds
CLIMBER = dict(series_len=128, paa_segments=16, num_pivots=32, prefix_len=5,
               capacity=40, sample_frac=0.3, max_centroids=12, k=16)
CELL = "sift128-25m.adaptive-b4096"


def skewed_collection():
    """SIFT-shaped rows (64 clusters, spread 0.15) and one tight cluster of
    ``HOT`` near-copies, whose signatures the trie cannot split."""
    g = torch.Generator().manual_seed(3)
    return torch.cat([sift_like(ROWS - HOT, 128, generator=g),
                      sift_like(HOT, 128, generator=g, num_clusters=1, spread=0.002)])


@pytest.fixture(scope="module")
def built():
    data = skewed_collection()
    s = sample_size(ROWS, ClimberConfig(**CLIMBER))
    g = torch.Generator().manual_seed(1)
    sample_idx = torch.randperm(ROWS, generator=g)[:s]
    pivot_idx = torch.randperm(s, generator=g)[:CLIMBER["num_pivots"]]
    index = {pad: build_index(data, ClimberConfig(**CLIMBER, partition_pad=pad),
                              device="cpu", sample_idx=sample_idx, pivot_idx=pivot_idx)
             for pad in (None, 0)}
    return data, sample_idx, pivot_idx, index


def test_ragged_build_holds_the_dense_records(built):
    _, _, _, index = built
    dense, ragged = index[None].store, index[0].store
    assert isinstance(dense, PartitionStore) and isinstance(ragged, RaggedStore)
    count = dense.count.long()
    assert count.max() >= 10 * count.float().mean()
    assert torch.equal(ragged.count, dense.count) and ragged.capacity == dense.capacity
    assert ragged.start.dtype == torch.int64 and ragged.data.shape == (ROWS, 128)
    assert torch.equal(ragged.start, torch.cumsum(count, 0) - count)
    for p in range(dense.num_partitions):
        rows = slice(int(ragged.start[p]), int(ragged.start[p] + count[p]))
        for name in ("data", "norms", "rec_dfs", "rec_gid"):
            assert torch.equal(getattr(ragged, name)[rows],
                               getattr(dense, name)[p, :int(count[p])]), (p, name)
    assert live_bytes(ragged) == live_bytes(dense) == ROWS * (4 * 128 + 12)
    assert store_bytes(ragged) == live_bytes(ragged) + 12 * ragged.num_partitions
    assert store_bytes(dense) > 5 * store_bytes(ragged)
    # the build's gauges hold the last build's store (the ragged one)
    snap = REGISTRY.snapshot()["gauges"]
    assert snap["index.store_bytes"] == store_bytes(ragged)
    assert snap["index.store_live_bytes"] == live_bytes(ragged)


@pytest.mark.parametrize("pad", [None, 700])
def test_dense_pads_build_dense_stores(built, pad):
    data, sample_idx, pivot_idx, index = built
    if pad is None:
        store = index[None].store
    else:
        store = build_index(data, ClimberConfig(**CLIMBER, partition_pad=pad), device="cpu",
                            sample_idx=sample_idx, pivot_idx=pivot_idx).store
    assert isinstance(store, PartitionStore) and store.ragged is None
    assert store.capacity == max(pad or 0, int(store.count.max()))


@pytest.mark.parametrize("variant", ["adaptive", "knn"])
def test_engine_answers_bit_identical(built, variant):
    data, _, _, index = built
    queries = data[torch.randperm(ROWS, generator=torch.Generator().manual_seed(7))[:96]]
    queries = torch.cat([queries, data[ROWS - HOT:ROWS - HOT + 32]])    # the hot cluster
    out = {pad: ClimberEngine(index[pad], batch_size=64, variant=variant, k=16)
           .run(queries.numpy()) for pad in (None, 0)}
    for a, b in zip(out[None][:2], out[0][:2]):
        assert np.array_equal(a, b)


def test_plain_refine_ragged_equals_its_dense_view(built):
    """The plain version on the ragged store and on the dense store: the
    same (d², gid) and the same work counts."""
    data, _, _, index = built
    dense, ragged = index[None].store, index[0].store
    p = dense.num_partitions
    rng = np.random.default_rng(5)
    sp = torch.as_tensor(np.sort(rng.integers(-1, p, size=(9, 6)), axis=-1), dtype=torch.int32)
    lo = torch.zeros_like(sp)
    hi = torch.full_like(sp, 1 << 30)
    hi[:, 1::2] = 3                        # partial intervals too
    q = data[:9].contiguous()
    want = RT.refine_topk_plain(dense.data, dense.norms, dense.rec_dfs, dense.rec_gid,
                                q, sp, lo, hi, 40)
    got = RT.refine_topk_plain(ragged.data, ragged.norms, ragged.rec_dfs, ragged.rec_gid,
                               q, sp, lo, hi, 40, ragged=ragged.ragged)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    # the same pairs and records; the tags a design tests are each live
    # entry's cap slots on the dense store, its partition's records here
    w_d = RT.refine_work(dense.rec_dfs, dense.rec_gid, sp, lo, hi)
    w_r = RT.refine_work(ragged.rec_dfs, ragged.rec_gid, sp, lo, hi, ragged=ragged.ragged)
    live = sp >= 0
    assert w_d["live_slots"] == int(live.sum()) * dense.capacity
    assert w_r["live_slots"] == int(ragged.count[sp[live].long()].sum())
    assert w_d["kept_pairs"] == w_r["kept_pairs"] > 0
    assert w_d["unique_kept_records"] == w_r["unique_kept_records"]


def _check_numbers(built, queries):
    """The benchmark's check of the ragged engine's answers against the plain
    reference's plans and exact pools (``climbench/check.py``)."""
    from climbench import check
    from climbench.reference import index as ref_index
    from climbench.reference import plan as ref_plan
    from climbench.reference import refine as ref_refine
    data, sample_idx, pivot_idx, index = built
    spec = json.loads((ROOT / "climbench" / "checks" / f"{CELL}.json").read_text())
    dist, gid, _ = ClimberEngine(index[0], batch_size=64, variant="adaptive",
                                 k=16).run(queries.numpy())
    ref = ref_index.build(data, dict(CLIMBER, decay="exp", decay_lambda=0.5,
                                     centroid_min_od=2, adaptive_factor=4,
                                     candidate_groups=4, base_partitions=1),
                          sample_idx, pivot_idx)
    sp, lo, hi = ref_plan.plan(ref, ref_index.featurize(ref, queries), "adaptive")
    pools = ref_refine.pools(ref.store, data, queries, sp, lo, hi)
    numbers = check.judge(dist, gid, queries, pools, data, 16, spec["tie_rel"])
    return numbers, check.verdict(numbers, spec["limits"])


def _queries(data):
    rows = torch.randperm(ROWS, generator=torch.Generator().manual_seed(11))[:40]
    return torch.cat([data[rows], data[ROWS - HOT:ROWS - HOT + 24]])


def test_check_against_the_reference_is_correct(built):
    numbers, correct = _check_numbers(built, _queries(built[0]))
    assert correct and numbers["miss_share"] == 0


def test_check_fails_one_row_past_each_extent(built, monkeypatch):
    """Refine reads one row past every partition's extent (the last one's
    kept): the check comes out not correct."""
    def past(self):
        last = torch.arange(self.num_partitions) == self.num_partitions - 1
        return RT.Ragged(self.start, torch.where(last, self.count, self.count + 1),
                         self.cap + 1)
    monkeypatch.setattr(RaggedStore, "ragged", property(past))
    numbers, correct = _check_numbers(built, _queries(built[0]))
    assert not correct and numbers["miss_share"] > 0


def _refusals(store):
    from repro_torch.distributed import store as dstore
    from repro_torch.fleet.lifecycle import merge, snapshot
    handle = type("Handle", (), {"index": type("I", (), {"store": store})(),
                                 "num_records": ROWS, "global_ids": np.arange(ROWS)})()
    return {
        "shard_store": lambda: dstore.shard_store(store, ["cpu", "cpu"]),
        "store_to_arrays": lambda: dstore.store_to_arrays(store),
        "pad_store": lambda: dstore.pad_store(store, 8),
        "concat_stores": lambda: dstore.concat_stores([store, store]),
        "stack_stores": lambda: dstore.stack_stores([store]),
        "snapshot": lambda: snapshot.save_shard(Path("/nonexistent/never-written"), handle),
        "merge": lambda: merge.shard_records(handle),
    }


@pytest.mark.parametrize("path", sorted(_refusals(None)))
def test_dense_only_paths_refuse_a_ragged_store(built, path):
    store = built[3][0].store
    with pytest.raises(ValueError, match="ragged layout"):
        _refusals(store)[path]()


def test_delta_shard_refuses_the_ragged_layout():
    from repro_torch.fleet.fleet import DeltaShard
    with pytest.raises(ValueError, match="ragged layout"):
        DeltaShard(ClimberConfig(**CLIMBER), device=torch.device("cpu"), draws=None, pad=0)


def test_a_one_slot_mesh_takes_the_ragged_store(built):
    from repro_torch.distributed.store import shard_store
    store = built[3][0].store
    assert shard_store(store, ["cpu"])[0] is store


class _Landed:
    def query(self):
        return True

    def synchronize(self):
        pass


def test_item_tail_is_observed_from_five_counts():
    """A partition-major call's five counts: the sharing, and the largest
    item's work times the blocks over the total; a query-major call's two
    observe the sharing alone."""
    rb = RT._SharingReadback()
    tail, share = REGISTRY.histogram(RT.ITEM_TAIL), REGISTRY.histogram(RT.SHARING)
    n0, s0, m0 = tail.count, tail.sum, share.count
    rb._pending = [(_Landed(), torch.tensor([12, 4, 300, 1200, 132])),
                   (_Landed(), torch.tensor([6, 3])),
                   (_Landed(), torch.tensor([0, 0, 0, 0, 132]))]
    rb.drain()
    assert share.count == m0 + 3
    assert tail.count == n0 + 2 and tail.sum - s0 == pytest.approx(300 * 132 / 1200)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def skewed_dense(seed, p=12, cap=6000, n=128, ndfs=4):
    """A dense store whose partition 0 is full and the rest hold 200-600."""
    rng = np.random.default_rng(seed)
    count = np.concatenate([[cap], rng.integers(200, 601, size=p - 1)])
    live = np.arange(cap)[None, :] < count[:, None]
    data = np.where(live[..., None], rng.standard_normal((p, cap, n)), 0).astype(np.float32)
    norms = np.sum(data.astype(np.float64) ** 2, -1).astype(np.float32)
    dfs = np.where(live, rng.integers(0, ndfs, size=(p, cap)), -1).astype(np.int32)
    gid = np.full((p, cap), -1, np.int32)
    gid[live] = rng.permutation(int(live.sum())).astype(np.int32)
    return data, norms, dfs, gid, count


@pytest.mark.cuda
@pytest.mark.parametrize("group", [None, 1, 3])
def test_cuda_ragged_store_equals_its_dense_view(cuda, group):
    """Both designs on a ragged store give the dense store's bits, with the
    full partition's queries in items of at most ``group`` (None: as many
    as a block holds), and each partition-major call observes
    ``refine.item_tail`` once: the full partition's item against the rest."""
    data, norms, dfs, gid, count = skewed_dense(8)
    live = gid >= 0
    start = np.cumsum(count) - count
    dense = [torch.as_tensor(a).to(cuda) for a in (data, norms, dfs, gid)]
    flat = [torch.as_tensor(np.ascontiguousarray(a[live])).to(cuda)
            for a in (data, norms, dfs, gid)]
    lay = RT.Ragged(torch.as_tensor(start, dtype=torch.int64, device=cuda),
                    torch.as_tensor(count, dtype=torch.int32, device=cuda), int(count.max()))
    rng = np.random.default_rng(9)
    sp = np.sort(np.where(rng.random((64, 8)) < 0.2, -1,
                          np.where(rng.random((64, 8)) < 0.4, 0, rng.integers(0, 12, (64, 8)))),
                 axis=-1).astype(np.int32)
    lo = rng.integers(0, 2, size=sp.shape).astype(np.int32)
    hi = (lo + rng.integers(1, 4, size=sp.shape)).astype(np.int32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    plan = [torch.as_tensor(a).to(cuda) for a in (q, sp, lo, hi)]
    want = RT._query_major(*dense, *plan, 500)
    tail = REGISTRY.histogram(RT.ITEM_TAIL)
    RT.flush_sharing()
    n0, s0 = tail.count, tail.sum
    got = {"qm": RT._query_major(*flat, *plan, 500, ragged=lay),
           "pm": RT._partition_major(*flat, *plan, 500, group=group, ragged=lay),
           "pm one list": RT._partition_major(*flat, *plan, 500, group=group, lists=1,
                                              ragged=lay),
           "default": RT.refine_topk(*flat, *plan, 500, ragged=lay)}
    RT.flush_sharing()
    pm_calls = 2 + (64 * 8 >= RT.PARTITION_MAJOR_MIN * 12)
    assert tail.count == n0 + pm_calls and tail.sum > s0
    for name, (d2, g) in got.items():
        assert torch.equal(d2, want[0]) and torch.equal(g, want[1]), name
    d_p, g_p = RT.refine_topk_plain(*[t.cpu() for t in flat], *[t.cpu() for t in plan], 500,
                                    ragged=RT.Ragged(lay.start.cpu(), lay.extent.cpu(), lay.cap))
    tol = 1e-5 * ((plan[0].double().cpu() ** 2).sum(-1, keepdim=True) + float(norms.max()))
    assert bool(((want[0].cpu().double() - d_p.double()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_engine_on_a_ragged_store_equals_the_dense_one(cuda, built):
    """The small skewed build on the card: the engine's answers on the
    ragged store are the dense store's, through either refine design."""
    data, sample_idx, pivot_idx, _ = built
    index = {pad: build_index(data, ClimberConfig(**CLIMBER, partition_pad=pad), device=cuda,
                              sample_idx=sample_idx, pivot_idx=pivot_idx)
             for pad in (None, 0)}
    queries = torch.cat([data[:1000], data[ROWS - HOT:]]).numpy()
    for batch in (64, 1600):
        out = {pad: ClimberEngine(index[pad], batch_size=batch, variant="adaptive", k=16)
               .run(queries) for pad in (None, 0)}
        for a, b in zip(out[None][:2], out[0][:2]):
            assert np.array_equal(a, b), batch
