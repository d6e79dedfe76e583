"""Carry weights from `repro`'s parameter tree into the port's model.

The input is the JAX tree with every leaf turned into a numpy array
(`jax.tree.map(np.asarray, params)`), so this module needs no JAX.  Mapping:

  params["embed"]                     -> model.embed
  params["lm_head"]                   -> model.lm_head
  params["final_norm"]["scale"]       -> model.final_norm.scale
  params["blocks"][i][a][b][r]        -> model.blocks[r * P + i].a.b
  params["enc_blocks"][a][b][r]       -> model.enc_blocks[r].a.b (r < enc_layers)
  params["enc_final_norm"]["scale"]   -> model.enc_final_norm.scale

`blocks[i]` holds pattern position i (of P) stacked over the leading
`repeats` dimension, so its entry r is layer r * P + i, as `repro`'s layer
scan runs them; `enc_blocks` is stacked over `enc_layers`.  Each is
unstacked into per-layer tensors.  Weights keep JAX's (in, out) layout, so
the port computes `x @ w` as `repro` does.  Every ported block carries
across: the attention block (`norm1`, `attn` (GQA's, or MLA's `w_q`,
`w_dkv`, `w_kr`, `w_uk`, `w_uv`, `w_o`), `norm_cross` and `cross` with
cross-attention, `norm2`, and `ffn`, dense or the MoE's `router`,
`w_gate`, `w_up`, `w_down` and `shared`), the Mamba block (`norm1`,
`mixer`: `in_proj`, `conv_w`, `conv_b`, `x_proj`, `dt_proj`, `dt_bias`,
`A_log`, `D`, `out_proj`; `norm2`, `ffn`) and the mLSTM block (`norm1`,
`mixer`).

`mlp_from_jax` carries the speed predictor's MLP, a list of {"w", "b"}.
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
    flat = {"embed": tree["embed"], "lm_head": tree["lm_head"],
            "final_norm.scale": tree["final_norm"]["scale"]}
    # (prefix, stacked tree, repeats, pattern length P, position i): entry
    # r of the stack is layer r * P + i
    P = len(cfg.pattern)
    stacks = [("blocks", blocks, cfg.repeats, P, i)
              for i, blocks in enumerate(tree["blocks"])]
    if cfg.enc_layers:
        stacks.append(("enc_blocks", tree["enc_blocks"], cfg.enc_layers, 1,
                       0))
        flat["enc_final_norm.scale"] = tree["enc_final_norm"]["scale"]
    for prefix, blocks, n, P, i in stacks:
        for name, stacked in _flatten(blocks):
            if stacked.shape[0] != n:
                raise ValueError(f"{prefix}.{name}: leading dim "
                                 f"{stacked.shape[0]} != {n}")
            for r in range(n):
                flat[f"{prefix}.{r * P + i}.{name}"] = stacked[r]
    model = Transformer(cfg, device)
    # via fp32: numpy has no bf16, and the cast to each parameter's type
    # (cfg.dtype, or fp32 for the mLSTM gates, Mamba's dt_bias, A_log and D
    # and the MoE router) is then exact
    types = {k: p.dtype for k, p in model.state_dict().items()}
    state = {k: torch.from_numpy(np.array(v, np.float32)).to(types.get(k))
             for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model


def mlp_from_jax(layers: list, device=None) -> list[dict]:
    """The predictor MLP's parameter list (numpy leaves) as fp32 tensors on
    `device` (the CUDA card unless `device="cpu"` is passed)."""
    device = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k], np.float32), device=device)
             for k in ("w", "b")} for layer in layers]
