from repro_torch.configs.base import ModelConfig  # noqa: F401
