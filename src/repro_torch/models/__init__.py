"""Model zoo of the port (the dense decoder of its main path)."""
from repro_torch.models.transformer import (forward,  # noqa: F401
                                            from_jax_params, init_caches,
                                            init_model)
