from .registry import ARCH_IDS, PORTED, all_configs, get_config  # noqa: F401
from .shapes import SHAPES, ShapeSpec, batch_specs, decode_specs, supports_shape  # noqa: F401
