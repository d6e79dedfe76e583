from .optimizer import (AdamW, AdamWConfig, MomentumSGD,  # noqa: F401
                        MomentumSGDConfig, clip_by_global_norm, cosine_lr,
                        global_norm)
