"""Architecture registry: importing this package registers every config."""

from .base import (LayerSpec, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, get_config,
                   list_archs, reduced)
from .shapes import FRONTEND_DIM, SHAPES, get_shape, input_shapes, input_specs, shape_applicable

# Register every assigned architecture (order = the JAX package's assignment table).
from . import granite_moe_3b_a800m  # noqa: F401
from . import stablelm_3b           # noqa: F401
from . import nemotron_4_15b        # noqa: F401
from . import musicgen_large        # noqa: F401
from . import granite_8b            # noqa: F401
from . import phi35_moe_42b_a66b    # noqa: F401
from . import mamba2_130m           # noqa: F401
from . import jamba_v01_52b         # noqa: F401
from . import internvl2_2b          # noqa: F401
from . import llama32_1b            # noqa: F401

ASSIGNED_ARCHS = (
    "granite-moe-3b-a800m",
    "stablelm-3b",
    "nemotron-4-15b",
    "musicgen-large",
    "granite-8b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-130m",
    "jamba-v0.1-52b",
    "internvl2-2b",
    "llama3.2-1b",
)

__all__ = ["LayerSpec", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "get_config",
           "list_archs", "reduced", "FRONTEND_DIM", "SHAPES", "get_shape", "input_shapes",
           "input_specs", "shape_applicable",
           "ASSIGNED_ARCHS"]
