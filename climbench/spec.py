"""What a cell is made of, found by name: ``BENCHMARK.json`` at the checkout's
root names the cells, configurations and metrics; each configuration is a
file of sizes, each traffic mix ``traffic/<mix>.json`` and each per-layer
metric a reader ``metrics/<metric>.py`` beside this file.  Nothing here knows
a particular cell, so a cell, a configuration, a mix or a metric is added as
a file and an entry, without an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json; have "
                   f"{[e['name'] for e in entries]}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as it is run."""
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "climbench" / "traffic" / f"{name}.json")
                      .read_text())


def _applies(metric: dict, workload_name: str) -> bool:
    return workload_name in metric.get("workloads", [workload_name])


def end_to_end(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, workload_name)]


def per_layer(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if _applies(m, workload_name)]


def reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``: the metric from a run's
    record, or None where the record holds nothing to read it from."""
    path = Path(root) / "climbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"climbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], record: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something for, with its unit."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks(workload_name: str, root: Path = ROOT) -> dict:
    """The cell's check: its sample size, tie rule and limits
    (``checks/<workload>.json``)."""
    return json.loads((Path(root) / "climbench" / "checks" / f"{workload_name}.json")
                      .read_text())
