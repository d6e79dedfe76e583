from .registry import ARCH_IDS, PORTED, get_config  # noqa: F401
