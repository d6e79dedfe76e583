"""Selective scan: the Mamba recurrence h_t = exp(dt_t A) h_{t-1} +
(dt_t x_t) B_t, y_t = <h_t, C_t>, with A = -exp(A_log).

Port of the Pallas TPU kernel `repro/kernels/ssm_scan.py`.  The CUDA kernel
(`csrc/ssm_scan.cu`, whose note gives its bound and design) gives each
channel L lanes (L in 1, 2, 4), each holding N/L of its states in registers
for the whole sequence; the states' factors are exp2 of a pre-scaled A, and
dt, x, B and C stream into shared memory through a cp.async ring.
`lane_plan` picks L from the card's SM count.  `ssm_scan_plain` is the same
function in plain PyTorch (`ref.ssm_scan_reference` behind the kernel's
checks); it serves CPU tensors and the tests, and is what the kernel is held
against on the card.

As in the TPU wrapper every input is cast to fp32 and the output is fp32
(without the D*x skip).  Divergences from the TPU kernel's interface: the
`chunk` tiling argument is gone (tiling belongs to the kernel), so S need not
be a multiple of it; and the port's kernel is a superset of the Pallas one:
it also takes an initial state `h0` (B, di, N) and, with `return_state`,
returns the final state h_last (B, di, N) beside y.  The Pallas kernel
starts every row from zero and keeps its state in VMEM scratch; `repro`'s
Mamba prefill takes h_last from its jnp mixer instead, and the port's
takes it from the kernel.  The kernel takes N a power of two up to 32.

`launches` counts the kernel's launches (one per call of `ssm_scan_cuda`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .ref import ssm_scan_reference

STATE_DIMS = (1, 2, 4, 8, 16, 32)
THREADS = 128           # a block of the kernel: one warp a sub-partition
LANES = (2, 1, 4)       # lanes a channel the kernel takes, in order of
                        # preference where two plans balance alike
MAX_BLOCKS = 2**31 - 1  # the grid is one dimension

launches = 0


class LanePlan(NamedTuple):
    lanes: int          # L: threads a channel, each holding N / L states
    channels: int       # channels a block, THREADS // lanes
    blocks: int         # the grid: B * ceil(di / channels)
    busiest: int        # channels (padding included) on the busiest SM
    mean: float         # B * di / sms


def lane_plan(B: int, di: int, N: int, sms: int) -> LanePlan:
    """The kernel's lanes a channel for B * di channels of N states on a
    card of `sms` SMs.  Every channel costs the same (N exponentials and
    12 bytes a step), so the time is that of the SM that holds the most
    channels: ceil(blocks / sms) blocks of `channels` each.  Of the L in
    LANES that divide N, the plan takes the one whose busiest SM holds the
    fewest channels, the first in LANES on a tie: L = 2 (two warps a
    sub-partition hide each other's waits for one shuffle a step), then
    1, then 4 (the order of their times at jamba's width on the H100;
    PERF.md)."""
    if min(B, di, sms) < 1 or N not in STATE_DIMS:
        raise ValueError(f"lane_plan needs positive sizes and N in "
                         f"{STATE_DIMS}: B={B} di={di} N={N} sms={sms}")
    best = None
    for L in LANES:
        if L > N:
            continue
        C = THREADS // L
        blocks = B * -(-di // C)
        plan = LanePlan(L, C, blocks, -(-blocks // sms) * C, B * di / sms)
        if blocks <= MAX_BLOCKS and (best is None
                                     or plan.busiest < best.busiest):
            best = plan
    if best is None:
        raise ValueError(f"B*di = {B * di} channels need more than "
                         f"{MAX_BLOCKS} blocks")
    return best


def check_args(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
               C_ssm: torch.Tensor, A_log: torch.Tensor,
               h0: torch.Tensor | None = None) -> None:
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
    if h0 is not None and tuple(h0.shape) != (Bsz, di, N):
        raise ValueError(f"h0 must be (B, di, N) = ({Bsz}, {di}, {N}), got "
                         f"{tuple(h0.shape)}")
    for t in (dt, x, B_ssm, C_ssm, A_log, h0):
        if t is not None and not t.is_floating_point():
            raise ValueError(f"float inputs needed, got {t.dtype}")


def ssm_scan_plain(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                   C_ssm: torch.Tensor, A_log: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   return_state: bool = False):
    """The kernel's function in plain PyTorch: the same checks, then
    `ref.ssm_scan_reference` (a loop over the sequence)."""
    check_args(dt, x, B_ssm, C_ssm, A_log, h0)
    return ssm_scan_reference(dt, x, B_ssm, C_ssm, A_log, h0, return_state)


def ssm_scan_cuda(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                  C_ssm: torch.Tensor, A_log: torch.Tensor,
                  h0: torch.Tensor | None = None, return_state: bool = False,
                  *, lanes: int | None = None):
    """Launch the CUDA kernel; returns fp32 y (B,S,di), or (y, h_last
    (B,di,N) fp32) with return_state; h0 (B,di,N) is the state before step
    0 (zero if None).  Inputs are cast to contiguous fp32 (no copy when they
    already are).  `lanes` overrides `lane_plan`'s L (for measurements).
    Raises on anything the kernel does not take, or if the launch fails."""
    global launches
    check_args(dt, x, B_ssm, C_ssm, A_log, h0)
    dev = x.device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in (dt, B_ssm, C_ssm, A_log, h0)):
        raise ValueError("ssm_scan_cuda needs all tensors on one CUDA device")
    Bsz, S, di = x.shape
    N = B_ssm.shape[2]
    if lanes is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lanes = lane_plan(Bsz, di, N, sms).lanes
    elif lanes not in LANES or lanes > N:
        raise ValueError(f"lanes={lanes} must be one of {LANES}, "
                         f"at most N={N}")
    dt, x, B_ssm, C_ssm, A_log = (t.float().contiguous()
                                  for t in (dt, x, B_ssm, C_ssm, A_log))
    if h0 is not None:
        h0 = h0.float().contiguous()
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=dev)
    h_last = (torch.empty((Bsz, di, N), dtype=torch.float32, device=dev)
              if return_state else None)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssm_scan(
            dt.data_ptr(), x.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
            A_log.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), None if h_last is None else h_last.data_ptr(),
            Bsz, S, di, N, lanes, stream)
    if err:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return (y, h_last) if return_state else y


def _library() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 5 + [P]
        fn.restype = I
        lib.repro_cuda_error_string.argtypes = [I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
