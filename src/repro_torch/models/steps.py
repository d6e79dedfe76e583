"""Step functions: the decode step MuxFlow protects (the online workload) and
the train step it packs in beside it (the offline workload)."""
from __future__ import annotations

import torch

from .model import ModelConfig, forward


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,1), pos) -> (logits (B,Vpad),
    cache): one token for the whole batch against the standing cache, which
    is updated in place."""

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return forward(params, cfg, {"tokens": tokens}, mode="decode",
                       cache=cache, pos=pos)

    return decode_step


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int, mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits: (B,S,Vpad); targets: (B,S).
    Padded-vocab columns are excluded from the partition function."""
    Vpad = logits.shape[-1]
    lf = logits.float()
    if Vpad > vocab_size:
        cols = torch.arange(Vpad, device=lf.device)
        lf = lf + torch.where(cols < vocab_size, 0.0, -1e9)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Next-token LM loss.  Returns (loss, (ce, aux)); aux is the MoE
    auxiliary loss, zero for the ported patterns."""
    toks = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    targets = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    mask = torch.ones(toks.shape, dtype=torch.float32, device=toks.device)
    mask[:, -1] = 0.0
    logits, aux = forward(params, cfg, {"tokens": toks}, mode="train")
    ce = cross_entropy(logits, targets, cfg.vocab_size, mask)
    return ce, (ce, aux)


def make_train_step(cfg: ModelConfig, optimizer):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), one microbatch.  The gradient comes from torch autograd; the
    optimizer writes the new weights into `params` in place, and the
    returned params are the module passed in."""

    def train_step(params, opt_state, batch):
        weights = list(params.parameters())
        with torch.enable_grad():
            for w in weights:
                w.requires_grad_(True)
            loss, (ce, aux) = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, weights)
            for w in weights:
                w.requires_grad_(False)
        _, opt_state, gnorm = optimizer.update(weights, grads, opt_state)
        metrics = {"loss": loss.detach(), "ce": ce.detach(), "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step
