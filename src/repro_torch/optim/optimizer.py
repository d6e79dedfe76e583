"""AdamW (the offline train step's optimizer) and momentum SGD (the paper's
predictor optimizer), as `repro/optim/optimizer.py` defines them.

Parameters are any iterable of tensors in a fixed order; the state holds the
fp32 moments per parameter.  Updates are done in fp32 and cast back to the
parameter's type, in place (`repro` built new arrays).  These are not
`torch.optim.AdamW` or `SGD`, which keep a bf16 parameter's moments in bf16.
AdamW's step count, bias corrections and learning rate are fp32 tensors on
the parameters' device, as JAX computes them: Python floats would carry
them in float64 and shift every early update.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm(tensors, max_norm: float):
    """(tensors scaled so that their global norm is at most max_norm, each
    cast back to its own type; the global norm before clipping)."""
    g = global_norm(tensors)
    limit = torch.tensor(max_norm, dtype=torch.float32, device=g.device)
    scale = torch.clamp(limit / torch.clamp(g, min=1e-9), max=1.0)
    return [(t.float() * scale).to(t.dtype) for t in tensors], g


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    master_weights: bool = False   # keep an fp32 master copy of bf16 params


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to cfg.lr, then a cosine down to min_lr_frac * lr at
    total_steps; fp32 throughout.  step: an int or an integer tensor."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg

    def init(self, params) -> dict:
        params = list(params)
        state = {
            "m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device),
        }
        if self.cfg.master_weights:
            state["master"] = [p.detach().float().clone() for p in params]
        return state

    @torch.no_grad()
    def update(self, params, grads, state) -> tuple[list, dict, torch.Tensor]:
        """Writes the new values into `params` (and the moments, the step and
        the master copy into `state`); returns (params, state, global norm
        of the grads before clipping)."""
        cfg = self.cfg
        params = list(params)
        grads, gnorm = clip_by_global_norm(list(grads), cfg.grad_clip)
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        masters = state.get("master", params)
        for p, ref, g, m, v in zip(params, masters, grads, state["m"],
                                   state["v"]):
            gf = g.float()
            m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(gf * (1 - cfg.b2) * gf)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            pf = ref.float()             # ref itself when it is fp32
            upd.add_(cfg.weight_decay * pf).mul_(lr)
            pf.sub_(upd)
            if pf is not p:
                p.copy_(pf)              # one rounding to the param's type
        state["step"] = step
        return params, state, gnorm


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
