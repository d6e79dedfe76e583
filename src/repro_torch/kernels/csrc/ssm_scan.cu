// Mamba selective scan for Hopper (sm_90a), fp32:
//   A = -exp(A_log);  h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;
//   y_t = sum_n h_t[n] * C_t[n]       (no D * x skip; the caller adds it)
// dt, x, y: (B, S, di); B_t, C_t: (B, S, N); A_log: (di, N); all contiguous.
// Optional state: h_{-1} from h0 and h_{S-1} into h_last, both (B, di, N);
// a null pointer means a zero start and no state out.
//
// Replaces the Pallas TPU kernel `ssm_scan` in src/repro/kernels/ssm_scan.py
// (body `_ssm_kernel`).
//
// Bound.  Each (step, channel, state) element costs one exponential and a
// handful of fp32 FMAs, against 12 bytes of dt, x and y per (step, channel).
// At jamba-1.5-large's Mamba width (B 1, S 4096, di 16384, N 16) that is
// 805 MB of dt, x and y (0.240 ms at 3.35 TB/s) and 1.07e9 exponentials,
// which run on the SFU at 16 a clock a SM (0.257 ms at 1.98 GHz on 132
// SMs): the exponentials set the bound at N = 16, with the bytes close
// behind, so the kernel has to keep both streams busy at once.
//
// Why the first design ran at 1.80 ms, 14 % of that bound.  It
// gave each (channel, state) pair a lane.  Its hot loop's SASS (`python -m
// repro_torch.kernels.sass_mix`; PERF.md) issues, per exponential,
// 9 MIO instructions (4 shared-memory loads of dt, x, B_t[n] and C_t[n], 4
// shuffles for the sum over states, a store) and 15 fp32 ones (libdevice's
// accurate `expf` around each MUFU.EX2, and the shuffles' adds).  The MIO
// pipe issues about one warp instruction a clock an SM, so the loads and
// shuffles alone came to some 1.15 ms at jamba's width.
//
// What this design does about it:
//   * a thread owns one channel and N/L of its states, in registers, with
//     L in {1, 2, 4} lanes a channel (`lane_plan` in kernels/ssm_scan.py
//     picks L from the card's SM count); y_t is summed over the thread's
//     states in registers, then over the L lanes with log2(L) shuffles.  dt
//     and x are read from shared memory once per N/L states, B_t and C_t as
//     16-byte broadcasts: 1.3 MIO instructions an exponential at L = 2;
//   * exp(dt A) = 2^(dt A log2 e): A2 = -exp(A_log) log2 e is computed once
//     per (channel, state) in a register, and each step's factor is one FMUL
//     and one `ex2.approx.ftz.f32` (a bare MUFU.EX2; an H100 80GB HBM3 at
//     700 W runs 15.8 of them a clock an SM, `python -m
//     repro_torch.launch.mufu_rate`);
//   * each step's dA does not depend on h, so the loop-carried chain is one
//     FFMA a state; a tile's 16 steps are unrolled, so the compiler overlaps
//     one step's exponentials with the last step's sums;
//   * dt and x (16 steps x the block's channels) and B_t, C_t (16 x N) go
//     through a ring of three stages in dynamic shared memory by 16-byte
//     cp.async (4-byte where di is not a multiple of 4 or a pointer is not
//     16-byte aligned), two tiles in flight while one is computed, one
//     barrier a tile; each thread's chunk offsets are computed once, and y
//     goes out through one pointer a thread advanced by di each step, so no
//     64-bit address is rebuilt in the step loop;
//   * a block is 128 threads, one warp on each of the SM's four
//     sub-partitions, and 128 / L channels.  The grid is one dimension,
//     blocks of a batch row next to each other, so B is limited only by
//     the grid.
// What sets its time now (PERF.md): with one warp a sub-partition
// the kernel runs at the pace of one warp's issue schedule, not of the SFU;
// L = 2 puts two warps on each sub-partition and is the fastest of L = 1,
// 2, 4 at jamba's width.
// The state in and out costs 2 * B * di * N * 4 bytes (2 MB at jamba's
// width, against the 805 MB above): each thread loads its N / L states of
// h0 where it would zero them and stores them once after the last tile,
// no shuffle needed.
// Rows past S and channels past di are zero-filled (dt 0 leaves h as it
// is) and not stored; a channel past di reads and writes no state.  dt * x
// is formed in fp32, as ref.ssm_scan_reference does; the output is fp32
// whatever the caller's input type (the wrapper casts to fp32).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // a block: one warp on each sub-partition
constexpr int kSteps = 16;      // time steps a ring stage holds (unrolled)
constexpr int kStages = 3;      // ring depth: two tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSteps * 32 <= 4 * kThreads,
              "a tile of B_t (or C_t) is at most one 16-byte chunk a thread");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared; with !ok, zeros and no read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int P>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(P) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NS consecutive floats of a 16-byte aligned row in shared memory.
template <int NS>
__device__ __forceinline__ void load_states(const float* p, float (&o)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (NS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x; o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) o[i] = p[i];
  }
}

// One ring stage: dt and x (kSteps rows of C channels), then B_t and C_t
// (kSteps rows of N states).
template <int N, int L>
struct Stage {
  static constexpr int kC = kThreads / L;           // channels a block
  static constexpr int kX = kSteps * kC;            // offset of x
  static constexpr int kB = 2 * kSteps * kC;        // offset of B_t
  static constexpr int kCm = kB + kSteps * N;       // offset of C_t
  static constexpr int kFloats = kCm + kSteps * N;
  static constexpr int kRingBytes = kStages * kFloats * 4;
  static_assert(kC % 4 == 0 && kX % 4 == 0 && kB % 4 == 0 && kCm % 4 == 0,
                "every part of a stage starts 16-byte aligned");
};

// One block per (batch row, 128 / L channels); one thread per (channel,
// lane), the lane owning states [lane * N / L, (lane + 1) * N / L).  The
// ring lives in dynamic shared memory.  vec: dt and x may be read in
// 16-byte chunks; bc_vec: B and C may (used when N is a multiple of 4).
template <int N, int L>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int di, int blocks_per_row,
                int vec, int bc_vec) {
  using St = Stage<N, L>;
  constexpr int C = St::kC, NS = N / L;
  extern __shared__ __align__(16) float smem[];
  float(*ring)[St::kFloats] = reinterpret_cast<float(*)[St::kFloats]>(smem);

  const int b = blockIdx.x / blocks_per_row;
  const int c0 = (blockIdx.x % blocks_per_row) * C;
  const int tid = threadIdx.x, ch = tid / L, lane = tid % L;
  const int c = c0 + ch, n0 = lane * NS;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  // this thread's states in h0 and h_last: (b, c, n0 .. n0 + NS - 1)
  const int64_t st0 = (static_cast<int64_t>(b) * di + c) * N + n0;

  float a2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = c < di ? -expf(a_log[static_cast<int64_t>(c) * N + n0 + j]) *
                         kLog2e
                   : 0.f;
    h[j] = h0 != nullptr && c < di ? h0[st0 + j] : 0.f;
  }
  // y: one pointer, advanced by di each step; lane 0 stores
  float* yp = y + row0 * di + min(c, di - 1);
  const bool yok = lane == 0 && c < di;

  // This thread's 16-byte chunks of a dt / x tile (the vec path): the
  // offset of row 0 in global memory, the place in a stage, and whether
  // the chunk's channels lie inside di.
  constexpr int kChunks = kSteps * C / 4, kRow = C / 4;
  constexpr int kIters = (kChunks + kThreads - 1) / kThreads;
  int64_t goff[kIters];
  int soff[kIters], grow[kIters];
  bool gok[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kThreads, r = i / kRow, q = 4 * (i % kRow);
    grow[it] = r;
    soff[it] = r * C + q;
    gok[it] = (kChunks % kThreads == 0 || i < kChunks) && c0 + q < di;
    goff[it] = gok[it] ? (row0 + r) * di + c0 + q : 0;
  }

  auto load_tile = [&](int tile, int st) {
    const int t0 = tile * kSteps;
    float* s = ring[st];
    if (vec) {
      const int64_t step0 = static_cast<int64_t>(t0) * di;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (kChunks % kThreads == 0 || tid + it * kThreads < kChunks) {
          const bool ok = gok[it] && t0 + grow[it] < S;
          const int64_t off = ok ? goff[it] + step0 : 0;
          cp_async16(smem_addr(s + soff[it]), dt + off, ok);
          cp_async16(smem_addr(s + St::kX + soff[it]), x + off, ok);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < kSteps * C / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / C, q = i % C;
        const bool ok = t0 + r < S && c0 + q < di;
        const int64_t off = ok ? (row0 + t0 + r) * di + c0 + q : 0;
        cp_async4(smem_addr(s + r * C + q), dt + off, ok);
        cp_async4(smem_addr(s + St::kX + r * C + q), x + off, ok);
      }
    }
    // kSteps rows of B_t and of C_t are kSteps * N floats in a row
    const int64_t base = (row0 + t0) * N;
    if (N % 4 == 0 && bc_vec) {
      const int i = 4 * tid;
      if (i < kSteps * N) {
        const bool ok = t0 + i / N < S;
        cp_async16(smem_addr(s + St::kB + i), bm + (ok ? base + i : 0), ok);
        cp_async16(smem_addr(s + St::kCm + i), cm + (ok ? base + i : 0), ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < (kSteps * N + kThreads - 1) / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (i < kSteps * N) {
          const bool ok = t0 + i / N < S;
          cp_async4(smem_addr(s + St::kB + i), bm + (ok ? base + i : 0), ok);
          cp_async4(smem_addr(s + St::kCm + i), cm + (ok ? base + i : 0), ok);
        }
      }
    }
  };

  const int ntiles = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < ntiles) load_tile(p, p);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();   // this thread's copies of the tile landed
    __syncthreads();                // everyone's; and the last stage is free
    const int next = tile + kStages - 1;
    if (next < ntiles) load_tile(next, next % kStages);
    cp_async_commit();              // an empty group keeps the count right

    const float* s = ring[tile % kStages];
    const int steps = S - tile * kSteps;    // rows of this tile inside S
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const float dtv = s[t * C + ch];
      const float bx = dtv * s[St::kX + t * C + ch];
      float bv[NS], cv[NS];
      load_states<NS>(s + St::kB + t * N + n0, bv);
      load_states<NS>(s + St::kCm + t * N + n0, cv);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        h[j] = fmaf(ex2(dtv * a2[j]), h[j], bx * bv[j]);
        yv = fmaf(h[j], cv[j], yv);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (yok && t < steps) *yp = yv;
      yp += di;
    }
  }
  if (h_last != nullptr && c < di) {
#pragma unroll
    for (int j = 0; j < NS; ++j) h_last[st0 + j] = h[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int N, int L>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a_log, const float* h0, float* y, float* h_last,
           int B, int S, int di, cudaStream_t stream) {
  using St = Stage<N, L>;
  const int per_row = (di + St::kC - 1) / St::kC;
  if (static_cast<int64_t>(per_row) * B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (St::kRingBytes > 48 * 1024) {   // above 48 KB it must be allowed
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        St::kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = di % 4 == 0 && aligned16(dt) && aligned16(x);
  const int bc_vec = aligned16(bm) && aligned16(cm);
  ssm_scan_kernel<N, L><<<per_row * B, kThreads, St::kRingBytes, stream>>>(
      dt, x, bm, cm, a_log, h0, y, h_last, S, di, per_row, vec, bc_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_lanes(int lanes, const float* dt, const float* x, const float* bm,
                 const float* cm, const float* a_log, const float* h0,
                 float* y, float* h_last, int B, int S, int di,
                 cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<N, 1>(dt, x, bm, cm, a_log, h0, y, h_last, B, S, di, s);
    case 2:
      if constexpr (N >= 2)
        return launch<N, 2>(dt, x, bm, cm, a_log, h0, y, h_last, B, S, di, s);
      break;
    case 4:
      if constexpr (N >= 4)
        return launch<N, 4>(dt, x, bm, cm, a_log, h0, y, h_last, B, S, di, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All pointers are contiguous fp32: dt, x, y (B, S, di); bm, cm (B, S, N);
// a_log (di, N); h0 and h_last (B, di, N), each may be null (zero state in,
// no state out).  N is a power of two up to 32; lanes (threads a channel)
// is 1, 2 or 4 and at most N.  Returns a cudaError_t: the arguments' check
// or the launch's status.
extern "C" int repro_ssm_scan(const void* dt, const void* x, const void* bm,
                              const void* cm, const void* a_log,
                              const void* h0, void* y, void* h_last, int B,
                              int S, int di, int N, int lanes, void* stream) {
  if (B < 1 || S < 1 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *pdt = static_cast<const float*>(dt),
              *px = static_cast<const float*>(x),
              *pb = static_cast<const float*>(bm),
              *pc = static_cast<const float*>(cm),
              *pa = static_cast<const float*>(a_log),
              *ph0 = static_cast<const float*>(h0);
  float *py = static_cast<float*>(y), *phl = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = lanes;
  switch (N) {
    case 1:
      return launch_lanes<1>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                             di, s);
    case 2:
      return launch_lanes<2>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                             di, s);
    case 4:
      return launch_lanes<4>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                             di, s);
    case 8:
      return launch_lanes<8>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                             di, s);
    case 16:
      return launch_lanes<16>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                              di, s);
    case 32:
      return launch_lanes<32>(L, pdt, px, pb, pc, pa, ph0, py, phl, B, S,
                              di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
