from repro_torch.configs.base import (InputShape, ModelConfig, get_config,
                                      reduced, register)

__all__ = ["InputShape", "ModelConfig", "get_config", "reduced", "register"]
