"""Configurations, a traffic mix, per-layer metrics and cells are added as
new files and new entries in a copy of the benchmark, its tests with it: a
run finds them by name, the copy's own contract and metric tests pass over
them, and no file that was there is edited."""
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from climbench import cell, spec

CPU = torch.device("cpu")
SMALL = dict(paa_segments=8, num_pivots=32, prefix_len=5, capacity=128,
             sample_frac=0.3, max_centroids=12, k=16)


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(spec.ROOT / "climbench", tmp_path / "climbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the program beside the benchmark, as in a checkout
    (tmp_path / "src").symlink_to(spec.ROOT / "src")
    bench = spec.load_benchmark()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "climbench").rglob("*") if p.is_file()}
    new = tmp_path / "climbench"

    base = spec.config(bench, "rand256-12m")
    tiny = dict(base, name="tiny-walks", rows=4000, series_len=64,
                climber=dict(base["climber"], series_len=64, **SMALL))
    (new / "configs/tiny-walks.json").write_text(json.dumps(tiny))
    # clustered descriptors: skewed partitions
    sift = json.loads((spec.HERE / "configs/sift128-12m.json").read_text())
    sift = dict(sift, name="tiny-sift", rows=4000, series_len=32,
                generator_args={"num_clusters": 8, "spread": 0.15},
                climber=dict(sift["climber"], series_len=32, **SMALL))
    (new / "configs/tiny-sift.json").write_text(json.dumps(sift))
    mix = dict(spec.traffic("adaptive-b4096"), set_size=16,
               serving={"batch_size": 16, "variant": "knn",
                        "plan_cache_size": 0, "k": 16})
    (new / "traffic/knn-b16.json").write_text(json.dumps(mix))
    (new / "metrics/sets_per_s.py").write_text(
        "def read(record):\n    return record['n_sets'] / record['window_s']\n\n\n"
        "CASE = {'record': {'n_sets': 40, 'window_s': 8.0}, 'value': 5.0,\n"
        "        'needs_trace': False}\n")
    (new / "metrics/serve_tick_ms.py").write_text(
        "from climbench.registry import mean\n\n\n"
        "def read(record):\n    return mean(record, 'span.serve.tick')\n\n\n"
        "CASE = {'record': {'registry': {'histograms': {'span.serve.tick':\n"
        "        {'count': 4, 'sum': 10.0}}, 'gauges': {}, 'counters': {}}},\n"
        "        'value': 2.5, 'needs_trace': False,\n"
        "        'silent': [{'registry': {'histograms': {}, 'gauges': {},\n"
        "                                 'counters': {}}}]}\n")
    for wl in ("tiny.knn-b16", "tiny-sift.knn-b16"):
        (new / f"checks/{wl}.json").write_text(json.dumps(
            {"sample": 8, "tie_rel": 1e-5,
             "limits": {"miss_share": 0.001, "d2_err": 1e-5}}))
    bench["configs"] += [
        {"name": "tiny-walks", "source": base["source"],
         "file": "climbench/configs/tiny-walks.json", "reduced": ["rows"],
         "why": "a test"},
        {"name": "tiny-sift", "source": sift["source"],
         "file": "climbench/configs/tiny-sift.json", "reduced": ["rows"],
         "why": "a test"}]
    bench["workloads"] += [
        {"name": "tiny.knn-b16", "config": "tiny-walks", "traffic": "knn-b16",
         "chips": 1, "why": "a test"},
        {"name": "tiny-sift.knn-b16", "config": "tiny-sift", "traffic": "knn-b16",
         "chips": 1, "why": "a test"}]
    bench["per_layer"] += [
        {"name": "sets_per_s", "unit": "sets/s", "better": "higher",
         "source": "host_clock", "layer": "serve loop", "moves": "queries_per_s",
         "workloads": ["tiny.knn-b16"]},
        {"name": "serve_tick_ms", "unit": "ms", "better": "lower",
         "source": "program_counter", "layer": "serve loop",
         "moves": "queries_per_s", "workloads": ["tiny-sift.knn-b16"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    for wl, metric, unit in (("tiny.knn-b16", "sets_per_s", "sets/s"),
                             ("tiny-sift.knn-b16", "serve_tick_ms", "ms")):
        res = cell.run(wl, 99, 0.2, True, t_start=time.perf_counter(), dev=CPU,
                       root=tmp_path)
        assert res["correct"] is True, wl
        assert res["metrics"][metric]["value"] > 0, wl
        assert res["metrics"][metric]["unit"] == unit, wl

    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "climbench/tests/test_climbench_contract.py",
         "climbench/tests/test_climbench_metrics.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": f"{tmp_path}:{tmp_path / 'src'}"})
    assert tests.returncode == 0, tests.stdout[-4000:] + tests.stderr[-2000:]
    for test in ("test_reader[serve_tick_ms] PASSED", "test_reader[sets_per_s] PASSED",
                 "test_each_cell_is_whole[tiny-sift.knn-b16] PASSED",
                 "test_config_file[tiny-sift] PASSED"):
        assert test in tests.stdout, test
    for rel, body in before.items():
        assert (tmp_path / rel).read_bytes() == body, rel
