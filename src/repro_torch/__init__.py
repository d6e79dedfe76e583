"""PyTorch/CUDA port of the MuxFlow reproduction (`repro`).

Same module layout as `repro` (configs, models, kernels, core, serving,
launch); every Pallas TPU kernel on a ported path becomes a hand-written
CUDA kernel for Hopper (sm_90a) with a plain PyTorch version beside it.
This package imports neither `jax` nor `repro`.

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`), where every kernel takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card; raises when there is none.  The port never
    falls back to the CPU on its own: pass `device="cpu"` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
