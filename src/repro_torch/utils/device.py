"""Device selection for the port's entry points.

Every entry point (``build_index``, ``knn_query`` through its index,
``ClimberEngine``, the data generators) runs on the card unless the caller
names another device.  With no card and no explicit device they raise: the
port never drops to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raising if there is no card); else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card before a host clock is read (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
