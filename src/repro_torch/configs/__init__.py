"""Model configurations the port runs, by the JAX package's ids."""

from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
