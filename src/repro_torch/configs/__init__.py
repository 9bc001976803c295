"""Model configurations of the port (counterpart of ``repro.configs``)."""
from repro_torch.configs.base import (EncoderSpec, MLASpec, ModelConfig,
                                      MoESpec, SSMSpec, get_config,
                                      list_archs, reduced_config, register)

__all__ = ["EncoderSpec", "MLASpec", "ModelConfig", "MoESpec", "SSMSpec",
           "get_config", "list_archs", "reduced_config", "register"]
