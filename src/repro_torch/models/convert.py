"""Carry weights from `repro`'s parameter tree into the port's model.

The input is the JAX tree with every leaf turned into a numpy array
(`jax.tree.map(np.asarray, params)`), so this module needs no JAX.  Mapping:

  params["embed"]                     -> model.embed
  params["lm_head"]                   -> model.lm_head
  params["final_norm"]["scale"]       -> model.final_norm.scale
  params["blocks"][0][a][b][r]        -> model.blocks[r].a.b   (r < repeats)

`blocks[0]` is stacked over the leading `repeats` dimension (one pattern
position); it is unstacked into per-layer tensors.  Weights keep JAX's
(in, out) layout, so the port computes `x @ w` as `repro` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from .model import ModelConfig, Transformer


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's model holding `tree`'s weights, cast to cfg.dtype, on
    `device` (the CUDA card unless `device="cpu"` is passed)."""
    device = resolve_device(device)
    if len(tree["blocks"]) != len(cfg.pattern):
        raise ValueError("one stacked block tree per pattern position expected")
    flat = {"embed": tree["embed"], "lm_head": tree["lm_head"],
            "final_norm.scale": tree["final_norm"]["scale"]}
    for name, stacked in _flatten(tree["blocks"][0]):
        if stacked.shape[0] != cfg.repeats:
            raise ValueError(f"{name}: leading dim {stacked.shape[0]} != "
                             f"repeats {cfg.repeats}")
        for r in range(cfg.repeats):
            flat[f"blocks.{r}.{name}"] = stacked[r]
    model = Transformer(cfg, device)
    # via fp32: numpy has no bf16, and the cast to cfg.dtype is then exact
    state = {k: torch.from_numpy(np.array(v, np.float32)).to(cfg.dtype)
             for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model
