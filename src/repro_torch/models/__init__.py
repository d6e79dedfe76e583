from .model import (ModelConfig, Transformer, forward, init_cache,  # noqa: F401
                    init_params)
from .steps import (cross_entropy, greedy_generate, loss_fn,  # noqa: F401
                    make_decode_step, make_eval_step, make_prefill,
                    make_train_step)
