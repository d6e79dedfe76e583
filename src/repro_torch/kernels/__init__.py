"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

Call them through `repro_torch.kernels.ops`, which picks the kernel for CUDA
tensors and the plain version for CPU tensors.
"""
