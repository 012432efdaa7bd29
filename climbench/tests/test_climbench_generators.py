"""The benchmark's frozen generators give the program's own rows: the same
seeded CPU generator through ``climbench.data`` and through
``repro_torch.data.series`` yields the same collection and queries."""
import pytest
import torch

from climbench import data as cdata
from repro_torch.data import series


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name, kwargs", [
    ("randomwalk", {}), ("sift", {"num_clusters": 64, "spread": 0.15}),
    ("seismic", {})])
@pytest.mark.parametrize("length", [64, 128])
def test_frozen_generators_match_the_program(name, kwargs, length):
    ours = cdata.GENERATORS[name](300, length, generator=_gen(7), **kwargs)
    theirs = series.GENERATORS[name](300, length, generator=_gen(7), **kwargs)
    assert torch.equal(ours, theirs)


def test_frozen_queries_match_the_program():
    rows = cdata.random_walk(500, 64, generator=_gen(3))
    ours = cdata.make_queries(rows, 40, generator=_gen(11))
    theirs = series.make_queries(rows, 40, generator=_gen(11))
    assert torch.equal(ours, theirs)
    assert torch.unique(ours, dim=0).shape[0] == 40


def test_collection_follows_the_seed():
    spec = {"generator": "randomwalk", "rows": 200, "series_len": 32}
    seed = 3 * 2**40 + 5          # seeds may exceed 32 bits
    a = cdata.collection(spec, seed, "cpu")
    assert torch.equal(a, cdata.collection(spec, seed, "cpu"))
    assert not torch.equal(a, cdata.collection(spec, seed + 1, "cpu"))
