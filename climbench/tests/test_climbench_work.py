"""The frozen refine work count on a hand-made store and plan: which
(query, record) pairs a refine must score, which records and tags it must
read, and the bound's bytes and operations."""
import pytest
import torch

from climbench import work

# three partitions of four slots; -1 marks an empty slot
GID = torch.tensor([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8]], dtype=torch.int32)
DFS = torch.tensor([[10, 11, 12, -1], [20, 21, -1, -1], [30, 30, 31, 32]],
                   dtype=torch.int32)
# query 0: a node [10, 12) of partition 0 and its sibling-overlapping entry
# [11, 13), so slot 1 is covered twice and counted once; query 1: one slot
# of partition 0 and all four of partition 2 in two entries; pads first
PART = torch.tensor([[-1, 0, 0], [0, 2, 2]], dtype=torch.int32)
LO = torch.tensor([[0, 10, 11], [12, 30, 31]], dtype=torch.int32)
HI = torch.tensor([[0, 12, 13], [13, 31, 33]], dtype=torch.int32)


def test_refine_work_by_hand():
    w = work.refine_work(DFS, GID, PART, LO, HI)
    # tags: the live records of partitions 0 and 2, each once
    assert w == {"kept_pairs": 3 + 5, "unique_kept_records": 7,
                 "tag_records": 3 + 4}


def test_refine_topk_work_by_hand():
    n, k = 16, 5
    w = work.refine_topk_work(8, 7, 7, nq=2, mp=3, n=n, k=k)
    assert w.flops == 8 * (2 * n + 3)
    assert w.nbytes == 7 * (4 * n + 4) + 7 * 8 + 2 * n * 4 + 3 * 2 * 3 * 4 + 2 * k * 8


@pytest.mark.parametrize("block", [1, 2])
def test_tick_work_sorts_and_blocks(block):
    # the same plan with its entries shuffled: the tick count sorts it first
    perm = torch.tensor([2, 0, 1])
    w = work.tick_work(DFS, GID, PART[:, perm], LO[:, perm], HI[:, perm],
                       n=16, k=5, block=block)
    assert w == work.refine_topk_work(8, 7, 7, nq=2, mp=3, n=16, k=5)


def _padded(t, cap):
    return torch.cat([t, torch.full((t.shape[0], cap - t.shape[1]), -1, dtype=t.dtype)], 1)


@pytest.mark.parametrize("cap", [4, 5, 64])
def test_tick_work_does_not_charge_pad_slots(cap):
    # a wider store of the same records (more pad slots a partition) reads
    # the same rows and tags
    w = work.tick_work(_padded(DFS, cap), _padded(GID, cap), PART, LO, HI, n=16, k=5)
    assert w == work.refine_topk_work(8, 7, 7, nq=2, mp=3, n=16, k=5)


@pytest.mark.parametrize("queries", [1, 4, 9])
def test_a_skewed_partition_charges_its_live_records_once_a_tick(queries):
    # partition 1 holds 10 live records of a 12-slot store, the others 2
    # and 1; every query plans all of partition 1, query 0 also partition 0
    gid = torch.full((3, 12), -1, dtype=torch.int32)
    gid[0, :2] = torch.tensor([0, 1])
    gid[1, :10] = torch.arange(2, 12)
    gid[2, 0] = 12
    dfs = torch.where(gid >= 0, torch.arange(12, dtype=torch.int32), -1)
    part = torch.full((queries, 2), -1, dtype=torch.int32)
    lo, hi = torch.zeros_like(part), torch.zeros_like(part)
    part[:, 1], hi[:, 1] = 1, 10
    part[0, 0], hi[0, 0] = 0, 2
    w = work.tick_work(dfs, gid, part, lo, hi, n=16, k=5)
    assert work.tag_records(gid, part) == 10 + 2
    assert w == work.refine_topk_work(10 * queries + 2, 12, 10 + 2, nq=queries,
                                      mp=2, n=16, k=5)


def test_bound_takes_the_slower_of_bytes_and_operations():
    kind = "NVIDIA H100 80GB HBM3"
    assert work.bound_s(work.Work(flops=67e12, nbytes=1.0), kind) == pytest.approx(1.0)
    assert work.bound_s(work.Work(flops=1.0, nbytes=3.35e12), kind) == pytest.approx(1.0)
