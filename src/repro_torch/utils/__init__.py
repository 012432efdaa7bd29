"""Configuration and device helpers of the PyTorch port."""
from repro_torch.utils.config import ClimberConfig
from repro_torch.utils.device import resolve_device

__all__ = ["ClimberConfig", "resolve_device"]
