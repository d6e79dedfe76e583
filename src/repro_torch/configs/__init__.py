from .registry import ARCH_IDS, PORTED, all_configs, get_config  # noqa: F401
