"""Architecture registry: importing this package registers the ported configs."""

from .base import ModelConfig, ShapeConfig, get_config, reduced
from .shapes import SHAPES, get_shape, input_shapes

from . import llama32_1b  # noqa: F401

__all__ = ["ModelConfig", "ShapeConfig", "get_config", "reduced",
           "SHAPES", "get_shape", "input_shapes"]
