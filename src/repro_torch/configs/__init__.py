"""Model configuration (copied from the JAX package's ``configs``)."""
from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401
