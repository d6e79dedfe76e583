// Flash attention forward for Hopper (sm_90a): prefill attention of q
// (B, Sq, H, d) against k, v (B, Skv, Hk, d), G = H / Hk query heads per KV
// head, fp32 online softmax, causal and/or sliding-window masks from absolute
// positions, output (B, Sq, H, d) in the input type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`).
//
// Bound.  A query tile of 64 rows against a key tile of 64 rows does
// 2 * 64 * 64 * d multiply-adds and reads 2 * 64 * d K/V elements, so at
// d = 128 the work is about 64 operations per byte in bf16 and 32 in fp32:
// above the card's fp32 ratio (67 TFLOP/s over 3.35 TB/s, 20 a byte), so the
// kernel is bound by arithmetic.  With scalar fp32 FMAs, as here, the bound is
// the fp32 rate; a tensor-core version (mma.sync or wgmma) is later work.
// What the design does about that bound:
//   * every (query row, key row) pair that the causal or window mask hides
//     for a whole 64 x 64 tile is never visited: the KV loop of a query tile
//     starts at the window's first key and stops at the causal diagonal, so
//     a causal prefill does about half the work of a full one;
//   * each thread keeps a 4 x 4 block of scores and a 4 x ceil(d/16) block of
//     the output in registers, so every value read from shared memory feeds
//     four FMAs;
//   * the shared tiles have an odd row stride (d + 1 floats), so the 16 key
//     rows a warp reads in one step fall into 16 different banks.
// It reads q, k and v in place through their strides (unit stride on d); the
// TPU code transposed all three to a heads-major layout on every call.
// Query head h reads KV head h / G.  q is scaled by 1/sqrt(d) in fp32 as the
// TPU kernel scales it.  Rows past Sq and keys past Skv are masked here, so
// Sq and Skv need not be multiples of the tiles (the TPU kernel asserted they
// were multiples of its blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 64;          // key rows a tile
constexpr int kThreads = 256;    // 16 x 16: ty picks 4 rows, tx 4 keys
constexpr int kMaxD = 256;
constexpr int kPStride = kBK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Floats of dynamic shared memory a block needs at head width d.
inline size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ + 2 * kBK) * (d + 1) + kBQ * kPStride +
         3 * kBQ;
}

// One block per (query tile, query head, sequence).  NCOL = ceil(d / 16)
// rounded up to 4, 8 or 16: the output columns a thread owns are
// tx, tx + 16, ... below d.
template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads)
flash_forward(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
              int H, int Hk, int d, int causal, int window, int64_t q_sb,
              int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
              int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
              float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* q_s = smem;                        // [kBQ][dp], pre-scaled
  float* k_s = q_s + kBQ * dp;              // [kBK][dp]
  float* v_s = k_s + kBK * dp;              // [kBK][dp]
  float* p_s = v_s + kBK * dp;              // [kBQ][kPStride]
  float* m_s = p_s + kBQ * kPStride;        // running max of each row
  float* l_s = m_s + kBQ;                   // running sum of each row
  float* c_s = l_s + kBQ;                   // this tile's rescale of a row

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const T* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int qr = q0 + r;
    q_s[r * dp + c] = qr < Sq ? to_float(qb[qr * q_ss + c]) * sm_scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[i][j] = 0.f;

  // The keys any row of this tile may see: [k_lo, k_hi).
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int kr = kt + r;
      const bool ok = kr < Skv;
      k_s[r * dp + c] = ok ? to_float(kb[kr * k_ss + c]) : 0.f;
      v_s[r * dp + c] = ok ? to_float(vb[kr * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j, kp = kt + kk;
        const bool ok = kp < Skv && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        p_s[r * kPStride + kk] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = p_s + r * kPStride + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, row[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with no visible key yet keeps p = 0 and acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = expf(row[e] - m_use);
        row[e] = p;
        sum += p;
      }
      // the shuffles also order every lane's read of m_s[r] before the write
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_use);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty*4 + i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = v_s[kk * dp + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qr = q0 + r;
    if (qr >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + qr) * H + h) * d;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(o + c, acc[i][j] / l);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Skv, H, Hk, d, causal, window;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  cudaStream_t stream;
};

template <typename T, int NCOL>
int launch(const Args& a) {
  const size_t smem = smem_floats(a.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward<T, NCOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_forward<T, NCOL><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv, a.H,
      a.Hk, a.d, a.causal, a.window, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss,
      a.k_sh, a.v_sb, a.v_ss, a.v_sh, 1.0f / sqrtf(static_cast<float>(a.d)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a) {
  if (a.d <= 64) return launch<T, 4>(a);
  if (a.d <= 128) return launch<T, 8>(a);
  return launch<T, 16>(a);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  q (B, Sq, H, d) and k, v (B, Skv, Hk, d) with
// unit stride on d and the given element strides (batch, sequence, head);
// out is contiguous (B, Sq, H, d).  causal: 0 or 1; window: 0 for none, else
// the sliding window (keys in (q - window, q]).  Every query row must see at
// least one key (the caller checks).  Returns a cudaError_t: the arguments'
// check or the launch's status.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int Sq, int Skv, int H, int Hk, int d, int causal, int window,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hk < 1 || H % Hk != 0 || d < 8 ||
      d > kMaxD || d % 8 != 0 || window < 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    out,  B,    Sq,   Skv,  H,    Hk,   d,
               causal, window, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
               v_sh, static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? launch_d<float>(a) : launch_d<__nv_bfloat16>(a);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
