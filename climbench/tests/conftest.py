"""Shared pieces of the benchmark's CPU tests: the ``cuda`` marker, a
fixture that gives the card or skips, and a tiny stand-in of a cell that a
run on the CPU can hold."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; the test skips itself where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The first CUDA device, or a skip (decided here, never at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def shrink(cell: dict) -> None:
    """A cell at a size the CPU holds: 6,000 series of length 64 and the
    small configuration of the program's own tests, sets of 32."""
    cfg = cell["config"]
    cfg["rows"] = 6000
    cfg["series_len"] = 64
    cfg["climber"].update(series_len=64, paa_segments=8, num_pivots=32,
                          prefix_len=5, capacity=128, sample_frac=0.3,
                          max_centroids=12, k=16)
    cell["traffic"]["set_size"] = 32
    cell["traffic"]["serving"].update(batch_size=32, k=16)
    cell["checks"]["sample"] = 24
