"""The check, driven through a whole run at a size the CPU holds (the look
for a card skipped): a sound run comes out correct, and so does not the
control (the reference one precision lower) nor a run whose timed path is
broken underneath, for each fault a query cell can have."""
import time

import numpy as np
import pytest
import torch

from climbench import cell, control
from climbench.tests.conftest import shrink
from repro_torch.serve.knn_engine import ClimberEngine

CELLS = ["rand256.adaptive-b4096", "rand256.spend4-b4096"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(workload, traced=False, seed=2**33 + 17):
    return cell.run(workload, seed, 0.3, traced, t_start=time.perf_counter(),
                    dev=torch.device("cpu"), adjust=shrink)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct_and_well_formed(workload, traced):
    res = run(workload, traced)
    assert res["correct"] is True
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert set(res) == set(KEYS) | {"setup", "check"} | ({"breakdown"} if traced else set())
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, entry in res["check"].items():
        assert entry["value"] <= entry["limit"], name
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms",
                                       "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_is_not_correct(workload, seed):
    c = cell.load(workload)
    shrink(c)
    out = control.control_numbers(c, seed, 12, torch.device("cpu"))
    assert out["correct"] is False


def _half_left_out(dist, gid):
    h = dist.shape[0] // 2
    dist[h:2 * h], gid[h:2 * h] = dist[:h], gid[:h]
    return dist, gid


def _answer_altered(dist, gid):
    gid[:, 0] = (gid[:, 0] + 1) % 6000
    return dist, gid


FAULTS = {"half_the_batch_left_out": _half_left_out,
          "an_answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["state_unchanged"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    original = ClimberEngine.run
    previous = {}

    def broken(self, queries, k=0):
        dist, gid, metrics = original(self, queries, k)
        if fault == "state_unchanged":
            # each call answers with the first call's answers
            dist, gid = previous.setdefault("answers", (dist, gid))
            return dist.copy(), gid.copy(), metrics
        return (*FAULTS[fault](np.array(dist), np.array(gid)), metrics)

    monkeypatch.setattr(ClimberEngine, "run", broken)
    assert run(CELLS[0])["correct"] is False
