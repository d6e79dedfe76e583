from .model import (ModelConfig, Transformer, forward, init_cache,  # noqa: F401
                    init_params)
from .steps import make_decode_step  # noqa: F401
