"""Selective scan: the Mamba recurrence h_t = exp(dt_t A) h_{t-1} +
(dt_t x_t) B_t, y_t = <h_t, C_t>, with A = -exp(A_log).

Port of the Pallas TPU kernel `repro/kernels/ssm_scan.py`.  The CUDA kernel
(`csrc/ssm_scan.cu`, whose note gives its bound and design) gives each
(channel, state) pair one warp lane that walks the whole sequence with its
state in a register; N lanes sum y_t with shuffles.  `ssm_scan_plain` is the
same function in plain PyTorch (`ref.ssm_scan_reference` behind the kernel's
checks); it serves CPU tensors and the tests, and is what the kernel is held
against on the card.

As in the TPU wrapper every input is cast to fp32 and the output is fp32
(without the D*x skip).  Divergence from the TPU kernel's interface: the
`chunk` tiling argument is gone (tiling belongs to the kernel), so S need not
be a multiple of it.  The kernel takes N a power of two up to 32.

`launches` counts the kernel's launches (one per call of `ssm_scan_cuda`).
"""
from __future__ import annotations

import ctypes

import torch

from .ref import ssm_scan_reference

STATE_DIMS = (1, 2, 4, 8, 16, 32)

launches = 0


def check_args(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
               C_ssm: torch.Tensor, A_log: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"dt and x must both be (B, S, di): "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    Bsz, S, di = x.shape
    if B_ssm.dim() != 3 or B_ssm.shape != C_ssm.shape \
            or tuple(B_ssm.shape[:2]) != (Bsz, S):
        raise ValueError(f"B and C must both be (B, S, N) matching x: "
                         f"{tuple(B_ssm.shape)}, {tuple(C_ssm.shape)}")
    N = B_ssm.shape[2]
    if tuple(A_log.shape) != (di, N):
        raise ValueError(f"A_log must be (di, N) = ({di}, {N}), got "
                         f"{tuple(A_log.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} must be one of {STATE_DIMS}")
    if min(Bsz, S, di) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    for t in (dt, x, B_ssm, C_ssm, A_log):
        if not t.is_floating_point():
            raise ValueError(f"float inputs needed, got {t.dtype}")


def ssm_scan_plain(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                   C_ssm: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same checks, then
    `ref.ssm_scan_reference` (a loop over the sequence)."""
    check_args(dt, x, B_ssm, C_ssm, A_log)
    return ssm_scan_reference(dt, x, B_ssm, C_ssm, A_log)


def ssm_scan_cuda(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                  C_ssm: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; returns fp32 y (B,S,di).  Inputs are cast to
    contiguous fp32 (no copy when they already are).  Raises on anything the
    kernel does not take, or if the launch fails."""
    global launches
    check_args(dt, x, B_ssm, C_ssm, A_log)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (dt, B_ssm, C_ssm, A_log)):
        raise ValueError("ssm_scan_cuda needs all tensors on one CUDA device")
    Bsz, S, di = x.shape
    N = B_ssm.shape[2]
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} must be at most 65535")
    dt, x, B_ssm, C_ssm, A_log = (t.float().contiguous()
                                  for t in (dt, x, B_ssm, C_ssm, A_log))
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssm_scan(dt.data_ptr(), x.data_ptr(), B_ssm.data_ptr(),
                                 C_ssm.data_ptr(), A_log.data_ptr(),
                                 y.data_ptr(), Bsz, S, di, N, stream)
    if err:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return y


def _library() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 4 + [P]
        fn.restype = I
        lib.repro_cuda_error_string.argtypes = [I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
