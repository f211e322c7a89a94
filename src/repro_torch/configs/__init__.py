"""Architecture configs (one module per arch) + config dataclasses."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
