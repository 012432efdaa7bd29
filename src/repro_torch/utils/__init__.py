"""Configuration and device helpers of the PyTorch port."""
from repro_torch.utils.config import (SHAPES, ClimberConfig, ModelConfig,
                                      ShapeConfig, get_shape)
from repro_torch.utils.device import resolve_device

__all__ = ["ClimberConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "get_shape", "resolve_device"]
