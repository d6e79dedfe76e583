"""Momentum SGD, the paper's predictor optimizer, as `repro/optim/optimizer.py`
defines it (AdamW waits for the `--share` train slice).

Parameters are any iterable of tensors in a fixed order; the state holds one
fp32 momentum per parameter.  The update is done in fp32 and cast back to the
parameter's type, in place (`repro` built new arrays).  This is not
`torch.optim.SGD`, which keeps a bf16 parameter's momentum in bf16.
"""
from __future__ import annotations

import dataclasses

import torch


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@dataclasses.dataclass(frozen=True)
class MomentumSGDConfig:
    """The paper trains the speed-predictor MLPs 'with momentum SGD optimizer
    in PyTorch'."""
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False


class MomentumSGD:
    def __init__(self, cfg: MomentumSGDConfig):
        self.cfg = cfg

    def init(self, params) -> dict:
        return {"mu": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
                "step": 0}

    @torch.no_grad()
    def update(self, params, grads, state) -> tuple[list, dict, torch.Tensor]:
        """Writes the new values into `params` (and the momenta into
        `state`); returns (params, state, global norm of the grads)."""
        cfg = self.cfg
        params, grads = list(params), list(grads)
        for p, g, mu in zip(params, grads, state["mu"]):
            gf = g.float() + cfg.weight_decay * p.float()
            mu.mul_(cfg.momentum).add_(gf)
            d = gf + cfg.momentum * mu if cfg.nesterov else mu
            p.copy_((p.float() - cfg.lr * d).to(p.dtype))
        state["step"] += 1
        return params, state, global_norm(grads)
