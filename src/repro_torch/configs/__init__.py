"""Model configurations the port runs, by the JAX package's ids, and
the assigned input shapes."""

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPES, SMOKE_SHAPES, ShapeSpec,
                                        input_specs, is_subquadratic,
                                        shape_applies)

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "SMOKE_SHAPES", "ShapeSpec",
           "input_specs", "is_subquadratic", "shape_applies"]
