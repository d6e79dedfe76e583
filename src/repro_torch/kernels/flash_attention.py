"""Flash attention forward: prefill attention with causal and sliding-window
masks.

Port of the Pallas TPU kernel `repro/kernels/flash_attention.py`.  The CUDA
kernel (`csrc/flash_attention.cu`, whose note gives its bound and design)
runs one block per (64 query rows, query head, sequence), streams 64-row K/V
tiles through shared memory with an fp32 online softmax, and skips the tiles
that the causal or window mask hides entirely.  `flash_attention_plain` is
the same function in plain PyTorch (`ref.attention_reference` behind the
kernel's checks); it serves CPU tensors and the tests, and is what the kernel
is held against on the card.

Divergences from the TPU kernel's interface: the tiling arguments
(`block_q`, `block_k`) are gone, since tiling belongs to the kernel; Sq and
Skv need not be multiples of anything; and a shape in which some query row
sees no key at all (a window that ends before the keys do) is refused, where
the TPU kernel and the oracle averaged every value for such a row.

`launches` counts the kernel's launches (one per call of
`flash_attention_cuda`), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import attention_reference

MAX_HEAD_DIM = 256

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int | None) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, d) and k, v (B, Skv, Hk, d): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Sq < 1 or Skv < 1:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"H={H} must be a multiple of Hk={Hk}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 8, <= {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be fp32 or bf16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        # row i sees keys in (i - window, i]; the last row must reach a key
        if Sq - 1 > Skv + window - 2:
            raise ValueError(f"query rows past {Skv + window - 2} see no key "
                             f"(Sq={Sq}, Skv={Skv}, window={window})")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same checks, then
    `ref.attention_reference` (one softmax over all keys)."""
    check_args(q, k, v, window)
    return attention_reference(q, k, v, causal=causal, window=window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B,Sq,H,d); k, v: (B,Skv,Hk,d), all read
    in place through their strides (unit stride on d).  Returns a contiguous
    (B,Sq,H,d) in q.dtype.  Raises on anything the kernel does not take, or
    if the launch fails."""
    global launches
    check_args(q, k, v, window)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs all tensors on one "
                         "CUDA device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"unit stride on d needed; strides {t.stride()}")
    B, Sq, H, d = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B} and H={H} must each be at most 65535")
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Skv, H, Hk, d, int(causal),
            0 if window is None else int(window), q.stride(0), q.stride(1),
            q.stride(2), k.stride(0), k.stride(1), k.stride(2), v.stride(0),
            v.stride(1), v.stride(2), stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I] + [P] * 4 + [I] * 8 + [L] * 9 + [P]
        fn.restype = I
        lib.repro_cuda_error_string.argtypes = [I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
