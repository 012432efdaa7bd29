"""On the card: the reference's featurize gives the program's kernels'
signatures bit for bit, and its index is the program's, slot for slot."""
import pytest
import torch

from climbench import data as cdata
from climbench.reference import featurize as F
from climbench.reference import index as ref_index

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("length", [128, 256])
def test_paa_and_rank_are_the_kernels(card, length):
    from repro_torch.kernels import ops
    x = cdata.random_walk(1 << 18, length, generator=cdata.generator(1, "t", card))
    z = ops.paa(x, 16)
    assert torch.equal(F.paa(x, 16), z)
    pivots = z[torch.randperm(z.shape[0], generator=cdata.generator(2, "t", card),
                              device=card)[:200]]
    assert torch.equal(F.rank_signature(z, pivots, 10), ops.pivot_rank(z, pivots, 10))


def test_reference_index_is_the_programs(card):
    from repro_torch.core.index import build_index
    from repro_torch.utils.config import ClimberConfig
    cfg = {"generator": "randomwalk", "rows": 1 << 20, "series_len": 256}
    data = cdata.collection(cfg, 5, card)
    ccfg = ClimberConfig()
    g = cdata.generator(5, "build", card)
    climber = {f: getattr(ccfg, f) for f in ccfg.__dataclass_fields__}
    s = ref_index.sample_size(data.shape[0], climber)
    sample_idx = torch.randperm(data.shape[0], generator=g, device=card)[:s]
    pivot_idx = torch.randperm(s, generator=g, device=card)[:200]
    prog = build_index(data, ccfg, device=card, sample_idx=sample_idx,
                       pivot_idx=pivot_idx)
    ref = ref_index.build(data, climber, sample_idx, pivot_idx)
    assert torch.equal(ref.store.rec_gid, prog.store.rec_gid)
    assert torch.equal(ref.store.rec_dfs, prog.store.rec_dfs)
    assert torch.equal(ref.store.norms, prog.store.norms)
