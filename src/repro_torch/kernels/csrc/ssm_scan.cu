// Mamba selective scan for Hopper (sm_90a), fp32:
//   A = -exp(A_log);  h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;
//   y_t = sum_n h_t[n] * C_t[n]       (no D * x skip; the caller adds it)
// dt, x, y: (B, S, di); B_t, C_t: (B, S, N); A_log: (di, N); all contiguous.
//
// Replaces the Pallas TPU kernel `ssm_scan` in src/repro/kernels/ssm_scan.py
// (body `_ssm_kernel`).
//
// Bound.  Each (step, channel, state) element costs one exponential and a
// handful of fp32 FMAs, against 12 bytes of dt, x and y per (step, channel).
// At jamba-1.5-large's Mamba width (B 1, S 4096, di 16384, N 16) that is
// 805 MB of dt, x and y (0.240 ms at 3.35 TB/s) and 1.07e9 exponentials,
// which run on the SFU at 16 a clock a SM (0.257 ms at 1.98 GHz on 132
// SMs): the exponentials, not the bytes, set the bound at N = 16, and the two
// are close enough that the kernel has to keep both streams busy.
// What the design does about that bound:
//   * the TPU's sequential chunk grid with its VMEM state becomes a time loop
//     inside each thread, with the state in a register: nothing of the state
//     ever goes to memory, and dt, x and y are each touched once;
//   * one lane per (channel, state n), N lanes a channel, and a shuffle sum
//     over those N lanes for y_t.  One thread per channel (with N states in
//     its registers) would give only B * di = 16,384 threads at jamba's
//     width, an eighth of what the card holds resident; a lane per state
//     gives B * di * N = 262,144, about one full wave on 132 SMs, and spreads
//     the exponentials over every SFU;
//   * a block owns 32 channels and stages 32 steps of dt and x (128-byte rows,
//     read coalesced along di) and of B_t and C_t (N floats each) in shared
//     memory, and writes y back the same way.
// dt * x is formed in fp32, as ref.ssm_scan_reference does; the output is
// fp32 whatever the caller's input type (the wrapper casts to fp32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;   // channels a block
constexpr int kSteps = 32;      // time steps staged in shared memory at once

template <int N>
__global__ void __launch_bounds__(kChannels * N)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a_log, float* __restrict__ y, int S,
                int di) {
  constexpr int kThreads = kChannels * N;
  __shared__ float dt_s[kSteps][kChannels];
  __shared__ float x_s[kSteps][kChannels];
  __shared__ float y_s[kSteps][kChannels];
  __shared__ float b_s[kSteps][N];
  __shared__ float c_s[kSteps][N];

  const int b = blockIdx.y, c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x, ch = tid / N, n = tid % N;
  const int c = c0 + ch;
  // lanes of channels past di run on zeros (every lane joins the shuffles)
  const float A = c < di ? -expf(a_log[static_cast<int64_t>(c) * N + n]) : 0.f;
  float h = 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    for (int i = tid; i < kSteps * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      const bool ok = t < steps && c0 + cc < di;
      const int64_t off = (row0 + t0 + t) * di + c0 + cc;
      dt_s[t][cc] = ok ? dt[off] : 0.f;
      x_s[t][cc] = ok ? x[off] : 0.f;
    }
    for (int i = tid; i < kSteps * N; i += kThreads) {
      const int t = i / N, nn = i % N;
      const bool ok = t < steps;
      const int64_t off = (row0 + t0 + t) * N + nn;
      b_s[t][nn] = ok ? bm[off] : 0.f;
      c_s[t][nn] = ok ? cm[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtv = dt_s[t][ch];
      const float bx = dtv * x_s[t][ch];
      h = expf(dtv * A) * h + bx * b_s[t][n];
      float yv = h * c_s[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (n == 0) y_s[t][ch] = yv;
    }
    __syncthreads();
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      if (c0 + cc < di) y[(row0 + t0 + t) * di + c0 + cc] = y_s[t][cc];
    }
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a_log, float* y, int B, int S, int di,
           cudaStream_t stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<N><<<grid, kChannels * N, 0, stream>>>(dt, x, bm, cm,
                                                        a_log, y, S, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are contiguous fp32: dt, x, y (B, S, di); bm, cm (B, S, N);
// a_log (di, N).  N is a power of two up to 32.  Returns a cudaError_t: the
// arguments' check or the launch's status.
extern "C" int repro_ssm_scan(const void* dt, const void* x, const void* bm,
                              const void* cm, const void* a_log, void* y,
                              int B, int S, int di, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *pdt = static_cast<const float*>(dt),
              *px = static_cast<const float*>(x),
              *pb = static_cast<const float*>(bm),
              *pc = static_cast<const float*>(cm),
              *pa = static_cast<const float*>(a_log);
  float* py = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(pdt, px, pb, pc, pa, py, B, S, di, s);
    case 2: return launch<2>(pdt, px, pb, pc, pa, py, B, S, di, s);
    case 4: return launch<4>(pdt, px, pb, pc, pa, py, B, S, di, s);
    case 8: return launch<8>(pdt, px, pb, pc, pa, py, B, S, di, s);
    case 16: return launch<16>(pdt, px, pb, pc, pa, py, B, S, di, s);
    case 32: return launch<32>(pdt, px, pb, pc, pa, py, B, S, di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
