"""Recall-frontier parity: ``repro_torch.eval.frontier`` and
``install_recall_target`` against ``repro.eval``.

Both packages sweep the same specs — ``test_eval_harness.SMOKE`` and the
same 2-shard corpus with two fan-outs and two spend factors — the port with
a :class:`FrontierDraws` subclass that replays the reference's
``jax.random`` draws (the corpus's base series and motif steps, the
queries' rows and jitter, and the fleet's shard and router draws through
``test_torch_fleet.JaxDraws``), on the CPU.

Tolerances: every cell's identity keys, ``mean_candidates_scanned``,
``mean_partitions_touched``, ``mean_fanout`` and the learned threshold are
exact; recall, MAP, the frontier AUCs and ``routed_gap`` agree within 1e-6.
``install_recall_target`` picks the same spend on the same traffic.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import query as j_query  # noqa: E402
from repro.data import series as jseries  # noqa: E402
from repro.eval import RecallCalibration as JCalibration  # noqa: E402
from repro.eval import datasets as jdatasets  # noqa: E402
from repro.eval import install_recall_target as j_install  # noqa: E402
from repro.eval import run_frontier as j_run_frontier  # noqa: E402
from repro.eval.frontier import build_eval_fleet as j_build_eval_fleet  # noqa: E402
from repro_torch.core import query as t_query  # noqa: E402
from repro_torch.eval import (FrontierDraws, FrontierSpec,  # noqa: E402
                              RecallCalibration, build_eval_fleet,
                              install_recall_target, run_frontier,
                              tenant_corpus)
from repro_torch.eval.frontier import _interp_recall, _set_slot_budget  # noqa: E402
from test_eval_harness import SMOKE  # noqa: E402
from test_torch_fleet import JaxDraws  # noqa: E402

TOL = 1e-6
SPECS = {"smoke": SMOKE,
         "fanouts_spends": dataclasses.replace(SMOKE, fanouts=(1, 2),
                                               spend_factors=(1.0, 2.0))}
EXACT = ("mean_candidates_scanned", "mean_partitions_touched", "mean_fanout")
CLOSE = ("recall", "map", "recall_frontier_auc")


class JaxFrontierDraws(JaxDraws, FrontierDraws):
    """The reference's draws: ``tenant_corpus``'s per-shard
    ``split(fold_in(PRNGKey(seed), i))`` and ``perturbed_queries``'
    ``split(PRNGKey(seed ^ 0x5EED))``, plus the fleet's (``JaxDraws``)."""

    def corpus(self, name, num_shards, shard_size, series_len, seed):
        root = jax.random.PRNGKey(seed)
        bases, steps = [], []
        for i in range(num_shards):
            kd, km = jax.random.split(jax.random.fold_in(root, i))
            bases.append(np.array(jseries.GENERATORS[name](kd, shard_size,
                                                            series_len)))
            steps.append(np.array(jax.random.normal(km, (series_len,))))
        return bases, steps

    def queries(self, num_rows, num_queries, series_len, seed):
        ki, kn = jax.random.split(jax.random.PRNGKey(seed ^ 0x5EED))
        return (np.array(jax.random.choice(ki, num_rows, shape=(num_queries,),
                                           replace=False)),
                np.array(jax.random.normal(kn, (num_queries, series_len))))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_spec(spec):
    return FrontierSpec(**dataclasses.asdict(spec))


@pytest.fixture(scope="module")
def docs():
    out = {}
    for name, spec in SPECS.items():
        out[name] = (j_run_frontier(spec),
                     run_frontier(port_spec(spec), device="cpu",
                                  draws=JaxFrontierDraws()))
    return out


def assert_rows_match(ref_rows, port_rows):
    assert len(port_rows) == len(ref_rows)
    for r, p in zip(ref_rows, port_rows):
        assert set(p) == set(r)
        for key, want in r.items():
            if key in CLOSE or key in ("frac_scanned", "adaptive_recall",
                                       "fixed_recall_at_cost", "improvement"):
                assert abs(p[key] - want) <= TOL, (key, r, p)
            else:                                  # identity keys, costs
                assert p[key] == want, (key, r, p)


@pytest.mark.parametrize("name", list(SPECS))
def test_frontier_matches_reference(docs, name):
    ref, port = docs[name]
    assert port["spec"] == ref["spec"]
    assert_rows_match(ref["cells"], port["cells"])
    assert_rows_match(ref["routed_gap"], port["routed_gap"])
    assert len(port["frontiers"]) == len(ref["frontiers"])
    for r, p in zip(ref["frontiers"], port["frontiers"]):
        assert (p["dataset"], p["shards"], p["split"]) == \
            (r["dataset"], r["shards"], r["split"])
        for curve in ("fixed", "adaptive"):
            assert [c for c, _ in p[curve]] == [c for c, _ in r[curve]]
            np.testing.assert_allclose([v for _, v in p[curve]],
                                       [v for _, v in r[curve]], atol=TOL)
            assert abs(p[f"{curve}_auc"] - r[f"{curve}_auc"]) <= TOL
    learned = [c["param"] for c in port["cells"]
               if c.get("param", "").startswith("learned=")]
    assert learned and learned == [c["param"] for c in ref["cells"]
                                   if c.get("param", "").startswith("learned=")]


def test_frontier_covers_the_sweep(docs):
    """The document's structure, as ``test_eval_harness`` asks of the
    reference's, and the cost orderings every sweep must show."""
    _, doc = docs["fanouts_spends"]
    cells = doc["cells"]
    assert {c["routing"] for c in cells if "routing" in c} == \
        {"exhaustive", "signature", "adaptive"}
    assert {c["split"] for c in cells} == {"all", "hard", "easy"}
    assert {c["param"] for c in cells if c.get("variant") == "recall_target"} \
        == {"spend=1", "spend=2"}
    assert {c["slot_budget"] for c in cells if "slot_budget" in c} == {0, 1}
    for split in ("all", "hard", "easy"):
        routed = [c for c in cells if c.get("split") == split
                  and c.get("slot_budget") == 0 and c.get("variant") == "adaptive"]
        exh = next(c for c in routed if c["routing"] == "exhaustive")
        assert all(exh["mean_candidates_scanned"] >= c["mean_candidates_scanned"]
                   for c in routed)
        budget = next(c for c in cells if c.get("split") == split
                      and c.get("slot_budget") == 1)
        assert budget["mean_partitions_touched"] <= 1 * 2
    for row in doc["routed_gap"]:
        assert row["improvement"] == pytest.approx(
            row["adaptive_recall"] - row["fixed_recall_at_cost"])


def test_interp_recall_clamps():
    pts = [(0.1, 0.2), (0.5, 0.6)]
    assert _interp_recall([], 0.3) == 0.0
    assert _interp_recall(pts, 0.0) == 0.2 and _interp_recall(pts, 1.0) == 0.6
    assert _interp_recall(pts, 0.3) == pytest.approx(0.4)


def test_frontier_with_its_own_draws_and_a_cache(tmp_path):
    """Without a draw hook the port draws from the seed (deterministic);
    with ``cache_dir`` the ground truth is computed once and then read."""
    spec = dataclasses.replace(port_spec(SMOKE), thresholds=(), fanouts=(),
                               spend_factors=(2.0,), slot_budgets=())
    a = run_frontier(spec, device="cpu", cache_dir=tmp_path)
    b = run_frontier(spec, device="cpu", cache_dir=tmp_path)
    assert a["cells"] == b["cells"]
    assert a["ground_truth_cache"] == {"hits": 0, "misses": 1}
    assert b["ground_truth_cache"] == {"hits": 1, "misses": 0}
    assert len(list(tmp_path.glob("gt_*.npz"))) == 1


@pytest.fixture(scope="module")
def eval_fleets():
    """The SMOKE corpus's evaluation fleet in both packages, served the
    same perturbed queries."""
    spec = SMOKE
    kw = dict(num_shards=2, shard_size=spec.shard_size,
              series_len=spec.series_len, seed=spec.seed, affinity=spec.affinity)
    ref_corpus = jdatasets.tenant_corpus(spec.datasets[0], **kw)
    draws = JaxFrontierDraws()
    bases, steps = draws.corpus(spec.datasets[0], 2, spec.shard_size,
                                spec.series_len, spec.seed)
    port_corpus = tenant_corpus(spec.datasets[0], device="cpu", bases=bases,
                                motif_steps=steps, **kw)
    ref = j_build_eval_fleet(ref_corpus, spec)
    port = build_eval_fleet(port_corpus, port_spec(spec), device="cpu", draws=draws)
    queries = jdatasets.perturbed_queries(ref_corpus, 12, noise=spec.noise, seed=4)
    return ref, port, queries


def test_install_recall_target_matches_reference(eval_fleets):
    ref, port, queries = eval_fleets
    cells = [{"mean_partitions_touched": p, "recall": r}
             for p, r in ((1.0, 0.3), (2.0, 0.55), (4.0, 0.8), (9.0, 0.97))]
    jc, tc = JCalibration.from_cells(cells), RecallCalibration.from_cells(cells)
    for target in (0.5, 0.9, 0.99):
        # an empty touch histogram: the curve's smallest budget stands in
        ref.reset_metrics()
        port.reset_metrics()
        assert install_recall_target(port, target, tc) == \
            j_install(ref, target, jc)
        for fleet in (ref, port):
            fleet.query(queries, SMOKE.k, routing="exhaustive")
        assert port.touched_hist.quantile(0.5) == ref.touched_hist.quantile(0.5)
        epoch = port._placement_epoch
        want = j_install(ref, target, jc, max_spend=3.0)
        got = install_recall_target(port, target, tc, max_spend=3.0)
        assert got == want and 1.0 <= got <= 3.0
        assert port._placement_epoch == epoch + 1
        assert t_query.get_planner("recall_target").spend_factor == \
            j_query.get_planner("recall_target").spend_factor == got
    d_ref, g_ref, _ = ref.query(queries, SMOKE.k, routing="exhaustive",
                                variant="recall_target")
    d_port, g_port, _ = port.query(queries, SMOKE.k, routing="exhaustive",
                                   variant="recall_target")
    np.testing.assert_array_equal(g_port, g_ref)


def test_slot_budget_caps_partitions(eval_fleets):
    _, port, queries = eval_fleets
    for budget in (1, 2):
        _set_slot_budget(port, budget)
        _, _, info = port.query(queries, SMOKE.k, routing="exhaustive")
        assert int(info.partitions_touched.max()) <= budget * len(port.shards)
    epoch = port._placement_epoch
    _set_slot_budget(port, None)
    assert port._placement_epoch == epoch + 1
    assert all(h.index.cfg.query_max_slots is None for h in port.shards)
