"""Public entry points for the port's kernels, dispatched by tensor device.

A CUDA tensor always goes to the hand-written kernel (which raises if it
cannot build or launch); a CPU tensor goes to the kernel's plain PyTorch
version.  `repro.kernels.ops` switched the Pallas kernels to interpret mode
off the TPU instead; the port has no such switch.
"""
from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import ssm_scan as _ssm


def _route(t: torch.Tensor, name: str, cuda, plain):
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no {name} for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """q: (B,1,H,d); caches: (B,Skv,Hk,d); kv_len: valid entries (int or
    (B,), each >= 1).  Returns (B,1,H,d) in q.dtype."""
    fn = _route(q, "decode_attention", _decode.decode_attention_cuda,
                _decode.decode_attention_plain)
    return fn(q, k_cache, v_cache, kv_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,Skv,Hk,d), H a multiple of Hk; causal and/or
    sliding-window (keys in (i - window, i] for query row i).  Returns
    (B,Sq,H,d) in q.dtype."""
    fn = _route(q, "flash_attention", _flash.flash_attention_cuda,
                _flash.flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window)


def ssm_scan(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
             C_ssm: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """dt, x: (B,S,di); B_ssm, C_ssm: (B,S,N); A_log: (di,N).  Returns fp32
    y (B,S,di), without the D*x skip."""
    fn = _route(x, "ssm_scan", _ssm.ssm_scan_cuda, _ssm.ssm_scan_plain)
    return fn(dt, x, B_ssm, C_ssm, A_log)
