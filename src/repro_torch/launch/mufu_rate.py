"""The card's measured rate of `ex2.approx.ftz.f32` (MUFU.EX2) and of fp32
FFMA, in results a clock an SM.

  PYTHONPATH=src python -m repro_torch.launch.mufu_rate

`ssm_scan`'s bound in chip_smoke.py takes the SFU at 16 exponentials a
clock an SM (the CUDA programming guide's throughput table for compute
capability 9.0).  This measures what the card does: a kernel in which every
thread runs 16 independent chains v = 2^(v * c) (one FMUL and one MUFU.EX2 a
step; the FMUL runs on the FMA pipe), and one in which it runs 16
independent FFMA chains, each over a full grid (8 blocks of 256 threads an
SM).  Rates are results over CUDA-event time and the SM clock that
nvidia-smi reads right after each timed loop.  Prints one JSON object with
the card's name and power limit.  Builds its kernels with nvcc into the
port's build directory; runs on the CUDA card only.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void exp_chains(float* out, int rounds, float c) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = 0.01f * (threadIdx.x + j);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = ex2(v[j] * c);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_chains(float* out, int rounds, float c) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = 0.01f * (threadIdx.x + j);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = fmaf(v[j], c, 0.25f);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int which, float* out, int blocks, int threads,
                   int rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0)
    exp_chains<<<blocks, threads, 0, s>>>(out, rounds, -0.5f);
  else
    ffma_chains<<<blocks, threads, 0, s>>>(out, rounds, 0.5f);
  return static_cast<int>(cudaGetLastError());
}
"""

THREADS, BLOCKS_PER_SM, ROUNDS = 256, 8, 4096


def _library() -> ctypes.CDLL:
    src = _build.BUILD_DIR / "tools" / "mufu_rate.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    dll = ctypes.CDLL(str(_build.build_file(src)))
    dll.run.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    dll.run.restype = ctypes.c_int
    return dll


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def measure() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("mufu_rate measures the CUDA card; none found")
    lib = _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = {"card": _smi("name,power.limit"), "sms": sms}
    for which, name in ((0, "ex2_approx_ftz_f32"), (1, "ffma_f32")):
        def call():
            err = lib.run(which, out.data_ptr(), blocks, THREADS, ROUNDS,
                          stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            call()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 10
        clock = _smi("clocks.sm")
        mhz = float(clock.split()[0])
        ops = blocks * THREADS * ROUNDS * 16
        results[name] = {"ms": ms, "sm_clock": clock,
                         "per_clock_per_sm": ops / (ms * 1e-3 * mhz * 1e6)
                         / sms}
    return results


def main() -> int:
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
