"""A configuration, a traffic mix, a per-layer metric and a cell are added
as new files and new entries in a copy of the benchmark, and a run finds
them by name, with no file that was there edited."""
import json
import shutil
import time

import torch

from climbench import cell, spec


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(spec.ROOT / "climbench", tmp_path / "climbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "climbench").rglob("*") if p.is_file()}

    base = spec.config(bench, "rand256-12m")
    tiny = dict(base, name="tiny-walks", rows=4000, series_len=64,
                climber=dict(base["climber"], series_len=64, paa_segments=8,
                             num_pivots=32, prefix_len=5, capacity=128,
                             sample_frac=0.3, max_centroids=12, k=16))
    (tmp_path / "climbench/configs/tiny-walks.json").write_text(json.dumps(tiny))
    mix = dict(spec.traffic("adaptive-b4096"), set_size=16,
               serving={"batch_size": 16, "variant": "knn",
                        "plan_cache_size": 0, "k": 16})
    (tmp_path / "climbench/traffic/knn-b16.json").write_text(json.dumps(mix))
    (tmp_path / "climbench/metrics/sets_per_s.py").write_text(
        "def read(record):\n    return record['n_sets'] / record['window_s']\n")
    (tmp_path / "climbench/checks/tiny.knn-b16.json").write_text(json.dumps(
        {"sample": 8, "tie_rel": 1e-5,
         "limits": {"miss_share": 0.001, "d2_err": 1e-5}}))
    bench["configs"].append({"name": "tiny-walks", "source": base["source"],
                             "file": "climbench/configs/tiny-walks.json",
                             "reduced": ["rows"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.knn-b16", "config": "tiny-walks",
                               "traffic": "knn-b16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "sets_per_s", "unit": "sets/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve loop", "moves": "queries_per_s",
                               "workloads": ["tiny.knn-b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = cell.run("tiny.knn-b16", 99, 0.2, True, t_start=time.perf_counter(),
                   dev=torch.device("cpu"), root=tmp_path)
    assert res["correct"] is True
    assert res["metrics"]["sets_per_s"]["value"] > 0
    assert res["metrics"]["sets_per_s"]["unit"] == "sets/s"
    for rel, body in before.items():
        assert (tmp_path / rel).read_bytes() == body, rel
