from .registry import ARCH_IDS, get_config, get_tiny  # noqa: F401
