"""Model configurations of the port (counterpart of ``repro.configs``)."""
from repro_torch.configs.base import (EncoderSpec, MLASpec, ModelConfig,
                                      MoESpec, SSMSpec, get_config,
                                      list_archs, reduced_config, register)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, input_specs,
                                        shape_applicable)

__all__ = ["EncoderSpec", "MLASpec", "ModelConfig", "MoESpec", "SSMSpec",
           "get_config", "list_archs", "reduced_config", "register",
           "SHAPES", "ShapeSpec", "input_specs", "shape_applicable"]
