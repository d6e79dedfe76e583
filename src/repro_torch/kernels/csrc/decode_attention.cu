// Flash-decoding attention for Hopper (sm_90a): one query token per sequence
// against a KV cache laid out (B, Skv, Hk, d), G = H / Hk query heads per KV
// head, fp32 online softmax, output in the input type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`).
//
// Bound.  The work is B*H*kv_len*d multiply-adds for the scores and as many
// for the values, against B*kv_len*Hk*d*2*sizeof(T) bytes of K and V: at most
// 2*G/sizeof(T) operations a byte, far below the card's ratio of peak
// operations to bytes.  So the kernel is bound by device memory: the least
// time is the K and V bytes over 3.35 TB/s (H100 SXM).  What the design does
// about that bound:
//   * it reads the model's cache in place through its strides; the TPU code
//     transposed the whole cache to (B*Hk, Skv, d) on every call;
//   * it reads only the first kv_len[b] rows of each sequence: blocks that
//     start past kv_len[b] exit at once, and no position is masked;
//   * it splits the KV axis across blocks (flash-decoding): a grid of
//     (ceil(Skv / split_len), Hk, B) blocks, each reducing its rows to a
//     partial (max, sum, acc) per query head, keeps every SM streaming even at
//     B*Hk = 64; a second small kernel merges the partials of each head;
//   * 16 threads share a cache row and each loads 16 bytes, so a row is read
//     as whole contiguous segments, and the G query heads of a KV head reuse
//     each row from registers.
// The G query rows live in shared memory, pre-scaled by 1/sqrt(d) in fp32 as
// the TPU kernel scales them.  Probabilities stay fp32 for the product with
// V, as in the TPU kernel; the JAX model's dense decode path cast them to
// the cache type first, a bf16 rounding difference inside the 2e-2 bf16
// limit of the tests against the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;                         // one block: 4 warps
constexpr int kRowThreads = 16;                       // threads sharing a row
constexpr int kRowGroups = kThreads / kRowThreads;    // rows in flight a block
constexpr int kMaxD = 256;
constexpr int kMaxG = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Eight consecutive elements (16-byte aligned) into fp32 registers.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  __nv_bfloat162 h[4];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// One block per (split, kv head, sequence).  Row group rg walks rows
// start+rg, start+rg+8, ... of the split; every thread of the block runs the
// same number of iterations so that the warp shuffles see all 32 lanes.
// MAXG bounds G (the loops break at G); NCH = ceil(d / 128) chunks of
// 8 elements a thread.
template <typename T, int MAXG, int NCH>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_len,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int H, int Hk, int G, int d,
               int Skv, int split_len, int64_t k_sb, int64_t k_ss,
               int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
               float sm_scale) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(kv_len[b], 1), Skv);
  const int start = split * split_len;
  if (start >= len) return;                 // the merge never reads it
  const int stop = min(start + split_len, len);

  const int tid = threadIdx.x;
  const int rg = tid / kRowThreads;
  const int lane = tid % kRowThreads;

  __shared__ __align__(16) float q_s[MAXG * kMaxD];
  __shared__ float red_m[kRowGroups][MAXG];
  __shared__ float red_l[kRowGroups][MAXG];
  __shared__ __align__(16) float red_acc[kRowGroups][kMaxD];

  const T* qb = q + (static_cast<int64_t>(b) * H + kh * G) * d;
  for (int i = tid; i < G * d; i += kThreads) {
    q_s[i] = to_float(qb[i]) * sm_scale;
  }
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][NCH][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][c][i] = 0.f;
  }

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int base = start; base < stop; base += kRowGroups) {
    const int p = base + rg;
    const bool valid = p < stop;
    float kr[NCH][8], vr[NCH][8];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (lane + c * kRowThreads) * 8;
      if (valid && col < d) {
        load8(kb + p * k_ss + col, kr[c]);
        load8(vb + p * v_ss + col, vr[c]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kr[c][i] = vr[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;                    // G is the same for the block
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = (lane + c * kRowThreads) * 8;
        if (col < d) {
          const float4* qp = reinterpret_cast<const float4*>(q_s + g * d + col);
          const float4 a = qp[0], e = qp[1];
          s += a.x * kr[c][0] + a.y * kr[c][1] + a.z * kr[c][2] +
               a.w * kr[c][3] + e.x * kr[c][4] + e.y * kr[c][5] +
               e.z * kr[c][6] + e.w * kr[c][7];
        }
      }
#pragma unroll
      for (int off = kRowThreads / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid) {
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);     // 0 while m is -inf
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][c][i] = acc[g][c][i] * corr + pr * vr[c][i];
        m[g] = m_new;
      }
    }
  }

  // Merge the row groups' partials into one (max, sum, acc) per head.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      red_m[rg][g] = m[g];
      red_l[rg][g] = l[g];
    }
  }
  __syncthreads();
  const int64_t part = ((static_cast<int64_t>(b) * Hk + kh) * gridDim.x +
                        split) * G;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRowGroups; ++r) M = fmaxf(M, red_m[r][g]);
    const float w = expf(m[g] - M);      // 0 for a row group with no rows
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (lane + c * kRowThreads) * 8;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < 8; ++i) red_acc[rg][col + i] = acc[g][c][i] * w;
      }
    }
    __syncthreads();
    for (int col = tid; col < d; col += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kRowGroups; ++r) sum += red_acc[r][col];
      part_acc[(part + g) * d + col] = sum;
    }
    if (tid == 0) {
      float L = 0.f;
#pragma unroll
      for (int r = 0; r < kRowGroups; ++r)
        L += red_l[r][g] * expf(red_m[r][g] - M);
      part_m[part + g] = M;
      part_l[part + g] = L;
    }
    __syncthreads();
  }
}

// One block per (query head, sequence): merges the splits below kv_len[b].
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc,
               const int* __restrict__ kv_len, T* __restrict__ out, int H,
               int Hk, int G, int d, int Skv, int split_len, int num_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / G, g = h % G;
  const int len = min(max(kv_len[b], 1), Skv);
  const int ns = (len + split_len - 1) / split_len;
  const int64_t base = (static_cast<int64_t>(b) * Hk + kh) * num_splits * G + g;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, part_m[base + s * G]);
  float L = 0.f;
  for (int s = 0; s < ns; ++s)
    L += part_l[base + s * G] * expf(part_m[base + s * G] - M);
  L = fmaxf(L, 1e-30f);
  T* o = out + (static_cast<int64_t>(b) * H + h) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const int64_t i = base + s * G;
      acc += expf(part_m[i] - M) * part_acc[i * d + col];
    }
    store(o + col, acc / L);
  }
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void *out, *part_m, *part_l, *part_acc;
  int B, H, Hk, d, Skv, split_len;
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  cudaStream_t stream;
};

template <typename T, int MAXG, int NCH>
void launch(const Args& a) {
  const int G = a.H / a.Hk;
  const int num_splits = (a.Skv + a.split_len - 1) / a.split_len;
  decode_partial<T, MAXG, NCH>
      <<<dim3(num_splits, a.Hk, a.B), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const int*>(a.kv_len),
          static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
          static_cast<float*>(a.part_acc), a.H, a.Hk, G, a.d, a.Skv,
          a.split_len, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh,
          1.0f / sqrtf(static_cast<float>(a.d)));
  decode_combine<T><<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<const int*>(a.kv_len),
      static_cast<T*>(a.out), a.H, a.Hk, G, a.d, a.Skv, a.split_len,
      num_splits);
}

template <typename T, int MAXG>
void launch_d(const Args& a) {
  if (a.d <= 128) launch<T, MAXG, 1>(a);
  else launch<T, MAXG, 2>(a);
}

template <typename T>
void launch_g(const Args& a) {
  const int G = a.H / a.Hk;
  if (G <= 1) launch_d<T, 1>(a);
  else if (G <= 2) launch_d<T, 2>(a);
  else if (G <= 4) launch_d<T, 4>(a);
  else launch_d<T, kMaxG>(a);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  q and out are contiguous (B, 1, H, d); k and v
// are (B, Skv, Hk, d) with unit stride on d and the given element strides;
// kv_len is int32 (B,), clamped to [1, Skv].  part_m and part_l hold
// B*Hk*ceil(Skv/split_len)*G floats, part_acc d times as many.  Returns a
// cudaError_t: the arguments' check or the launches' status.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* part_m, void* part_l, void* part_acc, int B, int H,
    int Hk, int d, int Skv, int split_len, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    void* stream) {
  if (B < 1 || Hk < 1 || H % Hk != 0 || H / Hk > kMaxG || d < 8 ||
      d > kMaxD || d % 8 != 0 || Skv < 1 || split_len < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_len, out, part_m, part_l, part_acc,
               B, H, Hk, d, Skv, split_len,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) launch_g<float>(a);
  else launch_g<__nv_bfloat16>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
