from repro_torch.configs.base import (SHAPES, SMOKE_SHAPE,  # noqa: F401
                                      ModelConfig, ShapeConfig)
