"""Step functions: the decode step MuxFlow protects (the online workload)."""
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
