"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or ``ml_dtypes`` (the port
reads and writes bf16 without it), and the entry points run on the card
unless the caller names another device — with no card they raise instead
of dropping to the CPU.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import index as t_index  # noqa: E402
from repro_torch.utils import device as t_device  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_every_module():
    assert len(PORT_FILES) >= 25
    assert {"refine_topk.py", "knn_engine.py", "chip_smoke.py"} <= {p.name for p in PORT_FILES}


def test_no_library_kernel_stands_in():
    """The kernel modules launch their own CUDA kernels: no call in the
    port goes to torch.topk, torch.compile, torch.cdist, avg_pool1d or (on
    the LM path, whose attention is the reference's chunked softmax)
    scaled_dot_product_attention."""
    banned = {"topk", "compile", "cdist", "avg_pool1d", "scaled_dot_product_attention"}
    for path in PORT_FILES[:-1]:          # chip_smoke.py may time yardsticks
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                assert node.func.attr not in banned, \
                    f"{path.name}:{node.lineno} calls .{node.func.attr}"
    csrc = REPO / "src" / "repro_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {"l2.cu", "paa.cu", "pivot_rank.cu",
                                                   "refine_topk.cu"}


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert t_device.resolve_device(None).type == "cuda"
    assert t_device.resolve_device("cpu").type == "cpu"


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        t_index.build_index(torch.zeros((300, 64)),
                            ClimberConfig(series_len=64, paa_segments=8,
                                          num_pivots=16, prefix_len=4))
    with pytest.raises(RuntimeError):
        t_index.index_from_arrays({}, ClimberConfig())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the smoke would run for real")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_scan_sees_the_fleet_packages():
    rel = {str(p.relative_to(REPO / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    for pkg, modules in (("obs", {"registry", "tracer", "profile"}),
                         ("distributed", {"store", "compression"}),
                         ("fleet", {"fleet", "router", "device_plan", "placement",
                                    "engine"}),
                         ("fleet/lifecycle", {"wal", "snapshot", "compactor", "merge"}),
                         ("models", {"params", "layers", "moe", "ssm", "model",
                                     "decoding"}),
                         ("configs", {"internlm2_1_8b", "mamba2_780m"}),
                         ("serve", {"engine"}),
                         ("data", {"tokens"}),
                         ("train", {"optimizer", "train_step", "checkpoint",
                                    "fault_tolerance"}),
                         ("launch", {"mesh", "train"})):
        assert {f"{pkg}/{m}.py" for m in modules | {"__init__"}} <= rel


def test_fleet_without_a_card_raises(monkeypatch, tmp_path):
    from repro_torch.fleet import FleetConfig, IndexFleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FleetConfig(shard_cfg=ClimberConfig(series_len=64, paa_segments=8,
                                              num_pivots=16, prefix_len=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexFleet(cfg)
    IndexFleet(cfg, device="cpu").save(tmp_path / "f")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexFleet.open(tmp_path / "f")


def test_lm_plane_without_a_card_raises(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model, init_cache
    from repro_torch.serve import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(cfg, 2, 8).batch_at(0)
    params = Model(cfg).init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(Model(cfg), params)
    Engine(Model(cfg), params, device="cpu").step()


def test_distributed_modules_import_first():
    """Each of these imports as a fresh interpreter's first import (an
    import cycle through ``core`` once broke all three)."""
    mods = ["repro_torch.distributed", "repro_torch.distributed.store",
            "repro_torch.distributed.compression"]
    code = ("import subprocess, sys\n"
            f"for m in {mods!r}:\n"
            "    r = subprocess.run([sys.executable, '-c', 'import ' + m],\n"
            "                       capture_output=True, text=True)\n"
            "    print(m, r.returncode, r.stderr.strip().splitlines()[-1:])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 3 and all(line.split()[1] == "0" for line in lines), lines
