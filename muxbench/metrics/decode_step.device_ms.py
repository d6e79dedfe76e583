"""Device ms an online step spends under the program's `decode.step` span
(a replayed CUDA graph's kernels included, through its
`cudaGraphLaunch`), over the online steps of the traced stretch
(torch.profiler, joined by correlation id).  The side's argmax and
synchronise lie outside it."""
from muxbench.metrics._spans import device_ms


def read(rd):
    return device_ms(rd, "decode.step")
