from .model import (ModelConfig, Transformer, forward, init_cache,  # noqa: F401
                    init_params)
from .steps import (cross_entropy, loss_fn, make_decode_step,  # noqa: F401
                    make_train_step)
