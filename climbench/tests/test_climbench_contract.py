"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: allowed names and units, every per-layer metric moving one
end-to-end metric that its cells report, a reader for every per-layer
metric, and no module of JAX or the JAX package (nor, for the reference,
of the program) loaded by the harness."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from climbench import spec

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH_FILES = sorted((ROOT / "climbench").rglob("*.py"))
REFERENCE_FILES = sorted((ROOT / "climbench" / "reference").glob("*.py"))


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"][1:] == ["climbench/run.py"]
    assert BENCH["paths"] == ["climbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for wl in BENCH["workloads"]:
        yield wl["config"]
        yield wl["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]
        yield from spec.config(BENCH, c["name"])["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_fit(name):
    assert spec.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert spec.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_each_name_once():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_one_reported_metric(metric):
    assert (ROOT / "climbench" / "metrics" / f"{metric['name']}.py").is_file()
    for wl in metric.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        reported = {m["name"] for m in spec.end_to_end(BENCH, wl)}
        assert metric["moves"] in reported, (metric["name"], wl)


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_whole(wl):
    e2e = {m["name"] for m in spec.end_to_end(BENCH, wl["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, wl["name"])
    assert wl["chips"] in (1, 4)
    assert len(wl["why"]) <= 200
    cfg = spec.config(BENCH, wl["config"])
    mix = spec.traffic(wl["traffic"])
    checks = spec.checks(wl["name"])
    assert cfg["climber"]["series_len"] == cfg["series_len"]
    assert mix["serving"]["batch_size"] >= 1
    assert set(checks["limits"]) == {"miss_share", "d2_err"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("climbench/")
    body = json.loads(path.read_text())
    assert body["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert set(body["reduced"]) == set(cfg["reduced"])
    assert set(body["reduced"]) <= set(body)


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not set(imported_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported_roots(path))


def _loaded_roots(code: str):
    env_path = f"{ROOT}:{ROOT / 'src'}"
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": env_path},
                         timeout=120)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    """What a run imports, the program with it, loads nothing forbidden."""
    roots = _loaded_roots(
        "import climbench.cell, climbench.control\n"
        "import repro_torch.core.index, repro_torch.core.query\n"
        "import repro_torch.serve.knn_engine, repro_torch.utils.config\n"
        "import repro_torch.obs, repro_torch.kernels._lib")
    assert not roots & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    roots = _loaded_roots(
        "import climbench.reference.index, climbench.reference.plan\n"
        "import climbench.reference.refine, climbench.check, climbench.work\n"
        "import climbench.data")
    assert not roots & (FORBIDDEN | {"repro_torch"})
