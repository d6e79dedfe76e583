from .optimizer import MomentumSGD, MomentumSGDConfig, global_norm  # noqa: F401
