"""The assigned input shapes and per-(arch x shape) input specs, ported
from `repro/configs/shapes.py`.

Every shape maps to the step function it runs:
  train_4k    -> train_step    (seq 4096,   global batch 256)
  prefill_32k -> prefill       (seq 32768,  global batch 32)
  decode_32k  -> decode_step   (1 new token, KV cache of 32768, batch 128)
  long_500k   -> decode_step   (1 new token, context 524288,    batch 1)

`batch_specs` and `decode_specs` give `(shape, dtype)` stand-ins for the
data inputs (`repro`'s ShapeDtypeStructs), and `decode_specs` builds the
cache with `init_cache` on the meta device: shapes and types, no memory.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.model import ModelConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype with no values (`jax.ShapeDtypeStruct`)."""
    shape: tuple
    dtype: torch.dtype


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Applicability per the assignment: long_500k only for sub-quadratic
    context handling (SSM / hybrid / sliding-window)."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")) or (cfg.window is not None)
        if not sub_quadratic:
            return False, ("pure full-attention arch: 500k dense context is "
                           "quadratic; skipped per assignment (see DESIGN.md)")
    return True, ""


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """TensorSpec stand-ins for the *data* inputs of train/prefill."""
    B, S = shape.global_batch, shape.seq_len
    specs: dict = {}
    if cfg.frontend == "patch":
        n_p = cfg.num_patches
        specs["patch_embeds"] = TensorSpec((B, n_p, cfg.d_model), cfg.dtype)
        specs["tokens"] = TensorSpec((B, S - n_p), torch.int32)
    elif cfg.frontend == "audio":
        specs["src_embeds"] = TensorSpec((B, S, cfg.d_model), cfg.dtype)
        specs["tokens"] = TensorSpec((B, S), torch.int32)
    else:
        specs["tokens"] = TensorSpec((B, S), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for decode: the cache (meta tensors), one token
    (TensorSpec) and the position.

    The cache has capacity seq_len; the new token is written at
    pos=seq_len-1 and attends over the full window: 'one new token with a
    KV cache of seq_len' per the assignment."""
    B, S = shape.global_batch, shape.seq_len
    src_len = S if cfg.enc_layers else 0
    return {
        "cache": init_cache(cfg, B, S, src_len=src_len, device="meta"),
        "tokens": TensorSpec((B, 1), torch.int32),
        "pos": S - 1,
    }
