"""Gradient compression for the offline trainer's data-parallel path, a
port of `repro/runtime/compression.py` in plain PyTorch.

Two standard schemes with error feedback:
  * int8 quantization (per-tensor absmax scaling), 4x fewer bytes than fp32;
  * top-k sparsification by magnitude, the dropped part carried in a
    residual.

They trade collective bytes for a little compute: the lever when a
collective bounds the step.  Gradients are a dict or a list (or tuple) of
tensors, or nestings of those, the leaves in their own order.
"""
from __future__ import annotations

import dataclasses

import torch


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale): symmetric absmax over the whole tensor,
    rounded half to even."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_encode(x: torch.Tensor, k_frac: float = 0.05):
    """(values, flat indices, shape) of the max(1, int(numel * k_frac))
    entries of largest magnitude, largest first."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.numel() * k_frac))
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx, tuple(x.shape)


def topk_decode(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=torch.float32,
                      device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from the iterator
    `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


@dataclasses.dataclass
class CompressorState:
    residual: object     # error feedback, the gradients' structure in fp32


class GradCompressor:
    """Error-feedback compressor over a structure of gradients.  mode:
    'int8' | 'topk'."""

    def __init__(self, mode: str = "int8", k_frac: float = 0.05):
        if mode not in ("int8", "topk"):
            raise ValueError(f"mode must be 'int8' or 'topk', got {mode!r}")
        self.mode = mode
        self.k_frac = k_frac

    def init(self, grads) -> CompressorState:
        return CompressorState(residual=_rebuild(grads, iter(
            [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
             for g in _leaves(grads)])))

    def compress_decompress(self, grads, state: CompressorState):
        """The round trip (what the wire would carry) with error feedback.
        Returns (decoded grads, new state, bytes on the wire, raw bytes)."""
        wire = raw = 0
        out, res = [], []
        for g, r in zip(_leaves(grads), _leaves(state.residual)):
            gf = g.float() + r
            raw += g.numel() * 4
            if self.mode == "int8":
                q, scale = int8_encode(gf)
                dec = int8_decode(q, scale)
                wire += q.numel() + 4
            else:
                vals, idx, shape = topk_encode(gf, self.k_frac)
                dec = topk_decode(vals, idx, shape)
                wire += vals.numel() * 4 + idx.numel() * 4
            out.append(dec.to(g.dtype))
            res.append(gf - dec)
        return (_rebuild(grads, iter(out)),
                CompressorState(residual=_rebuild(grads, iter(res))),
                wire, raw)
