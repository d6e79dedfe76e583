// Flash-decoding attention for Hopper (sm_90a): one query token per sequence
// against a KV cache laid out (B, Skv, Hk, d), G = H / Hk query heads per KV
// head, fp32 online softmax, output in the input type (fp32 or bf16), or
// in fp32 where the caller asks for the log-sum-exp too.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`).
//
// Bound.  The work is B*H*kv_len*d multiply-adds for the scores and as many
// for the values, against B*kv_len*Hk*d*2*sizeof(T) bytes of K and V: at most
// 2*G/sizeof(T) operations a byte, far below the card's ratio of peak
// operations to bytes.  So the kernel is bound by device memory: the least
// time is the K and V bytes over 3.35 TB/s (H100 SXM).  To stream at that
// rate each SM needs some 25 KB of loads in flight (3.35 TB/s over 132 SMs,
// times about a microsecond of latency).  What the design does about it:
//   * it reads the model's cache in place through its strides; the TPU code
//     transposed the whole cache to (B*Hk, Skv, d) on every call;
//   * it reads only the first kv_len[b] rows of each sequence: blocks that
//     start past kv_len[b] exit at once, and no position is masked;
//   * K and V tiles of 16 KB together (TR rows) stream into shared memory by
//     16-byte cp.async through a ring of three stages, so two tiles are in
//     flight while one is computed; with three or four blocks an SM that is
//     some 100 KB in flight;
//   * the KV axis is split across blocks (flash-decoding): a grid of
//     (num_splits, Hk, B) blocks, each reducing its rows to a partial (max,
//     sum, acc) per query head.  The host sizes the split from the SM count
//     and the kernel's occupancy, so that the grid is at most one wave
//     (`split_plan` in kernels/decode_attention.py).  A second small kernel
//     merges the partials; when the plan has one split, the first kernel
//     writes the output itself and the merge is not launched;
//   * the G scores of a row are computed from shared memory by G threads
//     (one (row, head) pair a thread, a whole-row dot product), so no shuffle
//     chain sits between the loads; the softmax of a tile takes one warp
//     reduction per head, and P V gives each thread one 16-byte column chunk
//     for every head, over a share of the tile's rows.
// Rows are XOR-swizzled in 16-byte chunks (chunk ^ row % 8) in shared memory,
// so that the threads of a warp that read eight rows of one chunk hit eight
// different banks.  The G query rows live in shared memory, pre-scaled by
// log2(e)/sqrt(d) in fp32 (the TPU kernel scaled them by 1/sqrt(d) and took
// exp; this differs only in fp32 rounding order).  Probabilities stay fp32
// for the product with V, as in the TPU kernel; the JAX model's dense decode
// path cast them to the cache type first, a bf16 rounding difference inside
// the 2e-2 bf16 limit of the tests against the JAX package.
//
// Logit cap (Gemma 2's, the JAX model's `softcap`, which its Pallas kernel
// lacks): with cap > 0 a score s = q.k/sqrt(d) becomes cap*tanh(s/cap)
// before the softmax.  q is then pre-scaled by 1/(sqrt(d)*cap) instead, so
// that the dot product is s/cap, and the score kept is cap*log2(e) *
// tanhf(s/cap), in the same log2 units as without a cap.  tanhf (not
// tanh.approx, whose 2^-11 relative error moves a score at cap 50 by 0.025)
// is within 2 ulp.  Without a cap the fold and every result are those of
// the uncapped kernel.  The cap costs one tanhf a score, about 1e6 a call
// at B8 Skv4096 H32: it hides behind the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;                         // one block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;                            // K/V ring depth
constexpr int kTileBytes = 16384;                     // K + V of one tile
constexpr int kMaxD = 256;
constexpr int kMaxG = 8;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a row in shared memory, as fp32.
__device__ __forceinline__ void chunk_to_float(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void chunk_to_float(const __nv_bfloat16* p,
                                               float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162 h[4];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The tile of a (T, DMAX) instantiation: rows of DMAX elements (the head
// width zero-padded), TR rows of K and TR of V in 16 KB.
template <typename T, int DMAX>
struct Tile {
  static constexpr int kRowBytes = DMAX * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;          // a row, >= 8
  static constexpr int kEPC = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kRows = kTileBytes / (2 * kRowBytes);     // TR
  static constexpr int kRowGroups = kThreads / kChunks;   // of P V
  static_assert(kChunks >= 8 && kChunks % 8 == 0, "swizzle needs 8 chunks");
  static_assert(kRows >= 8 && kRowGroups >= 1, "tile too small");
};

template <typename T, int MAXG, int DMAX>
constexpr int smem_bytes() {
  // the ring, then q (fp32), the tile's scores, and max / sum / rescale
  return kStages * kTileBytes + MAXG * DMAX * 4 +
         MAXG * Tile<T, DMAX>::kRows * 4 + 3 * MAXG * 4;
}

__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// One block per (split, kv head, sequence).  MAXG bounds G (the loops break
// at G); d <= DMAX.  With `direct` (one split) the block writes the output
// (of type O: T, or float beside the lse); otherwise its partial (max, sum,
// acc) of each head.
template <typename T, typename O, int MAXG, int DMAX>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_len,
               O* __restrict__ out, float* __restrict__ lse,
               float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int H, int Hk, int G, int d, int Skv, int split_len,
               int direct, int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh, float q_scale,
               float cap_log2) {
  using C = Tile<T, DMAX>;
  constexpr int TR = C::kRows, EPC = C::kEPC;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(kv_len[b], 1), Skv);
  const int start = split * split_len;
  if (start >= len) return;                 // the merge never reads it
  const int stop = min(start + split_len, len);
  const int ntiles = (stop - start + TR - 1) / TR;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);     // [stage][K rows | V rows]
  float* q_s = reinterpret_cast<float*>(smem + kStages * kTileBytes);
  float* s_s = q_s + MAXG * DMAX;           // [g][TR] scores, then p
  float* m_s = s_s + MAXG * TR;             // running max of each head
  float* l_s = m_s + MAXG;                  // running sum
  float* c_s = l_s + MAXG;                  // this tile's rescale

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int used = d / EPC;                 // chunks of a row below d
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // Rows [row0, row0 + TR) below `stop` into ring stage `st`.
  auto copy_tile = [&](int tile, int st) {
    const int row0 = start + tile * TR;
    const int rows = min(TR, stop - row0);
    T* ks = ring + st * (kTileBytes / sizeof(T));
    T* vs = ks + TR * DMAX;
    for (int i = tid; i < rows * C::kChunks; i += kThreads) {
      const int r = i / C::kChunks, c = i % C::kChunks;
      if (c >= used) continue;
      const int off = r * DMAX + swz(r, c) * EPC;
      const int64_t p = static_cast<int64_t>(row0 + r);
      cp_async16(smem_addr(ks + off), kb + p * k_ss + c * EPC);
      cp_async16(smem_addr(vs + off), vb + p * v_ss + c * EPC);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) copy_tile(st, st);
    cp_async_commit();
  }

  const T* qb = q + (static_cast<int64_t>(b) * H + kh * G) * d;
  for (int i = tid; i < G * d; i += kThreads) {
    float x;
    if constexpr (sizeof(T) == 4) x = qb[i];
    else x = __bfloat162float(qb[i]);
    q_s[(i / d) * DMAX + i % d] = x * q_scale;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // P V: this thread's column chunk and row group; acc[g] holds the chunk's
  // EPC columns of head g, summed over the group's rows.
  const int pc = tid % C::kChunks, pg = tid / C::kChunks;
  float acc[MAXG][EPC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();           // tile t landed; tile t - 1 is fully consumed
    if (t + kStages - 1 < ntiles)
      copy_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const T* ks = ring + (t % kStages) * (kTileBytes / sizeof(T));
    const T* vs = ks + TR * DMAX;
    const int rows = min(TR, stop - (start + t * TR));

    // Scores: thread -> (row, head) pairs, a whole-row dot product each.
    for (int pr = tid; pr < TR * G; pr += kThreads) {
      const int r = pr % TR, g = pr / TR;
      float s = -INFINITY;
      if (r < rows) {
        const float* qg = q_s + g * DMAX;
        s = 0.f;
        for (int c = 0; c < used; ++c) {
          float kv[EPC];
          chunk_to_float(ks + r * DMAX + swz(r, c) * EPC, kv);
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qg + c * EPC + e);
            s = fmaf(qv.x, kv[e], s);
            s = fmaf(qv.y, kv[e + 1], s);
            s = fmaf(qv.z, kv[e + 2], s);
            s = fmaf(qv.w, kv[e + 3], s);
          }
        }
        if (cap_log2 != 0.f) s = cap_log2 * tanhf(s);   // s was s/cap
      }
      s_s[g * TR + r] = s;
    }
    __syncthreads();

    // Softmax of the tile: one warp a head.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < TR; r += 32) mx = fmaxf(mx, s_s[g * TR + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int r = lane; r < TR; r += 32) {
        const float p = exp2f(s_s[g * TR + r] - m_use);   // 0 past `rows`
        s_s[g * TR + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_use);          // 0 while m is -inf
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this thread's rows of the tile.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float corr = c_s[g];
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][e] *= corr;
    }
    if (pc < used) {
      for (int r = pg; r < rows; r += C::kRowGroups) {
        float vv[EPC];
        chunk_to_float(vs + r * DMAX + swz(r, pc) * EPC, vv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float p = s_s[g * TR + r];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring is free: reuse it to merge groups

  // Sum the row groups' acc (they share each head's max), then write.
  float* red = reinterpret_cast<float*>(smem);     // [group][g][DMAX]
  if (pc < used) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        red[(pg * MAXG + g) * DMAX + pc * EPC + e] = acc[g][e];
    }
  }
  __syncthreads();
  const int64_t part = ((static_cast<int64_t>(b) * Hk + kh) * gridDim.x +
                        split) * G;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, col = i % d;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < C::kRowGroups; ++r)
      sum += red[(r * MAXG + g) * DMAX + col];
    if (direct) {
      store(out + (static_cast<int64_t>(b) * H + kh * G + g) * d + col,
            sum / fmaxf(l_s[g], 1e-30f));
    } else {
      part_acc[(part + g) * d + col] = sum;
    }
  }
  if (!direct && tid < G) {
    part_m[part + tid] = m_s[tid];
    part_l[part + tid] = l_s[tid];
  }
  if (direct && lse != nullptr && tid < G)   // m and l are in log2 units
    lse[static_cast<int64_t>(b) * H + kh * G + tid] =
        (m_s[tid] + log2f(fmaxf(l_s[tid], 1e-30f))) * kLn2;
}

// One block per (query head, sequence): merges the splits below kv_len[b]
// into an output of type O.
template <typename O>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc,
               const int* __restrict__ kv_len, O* __restrict__ out,
               float* __restrict__ lse, int H,
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
    L += part_l[base + s * G] * exp2f(part_m[base + s * G] - M);
  L = fmaxf(L, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0)
    lse[static_cast<int64_t>(b) * H + h] = (M + log2f(L)) * kLn2;
  O* o = out + (static_cast<int64_t>(b) * H + h) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const int64_t i = base + s * G;
      acc += exp2f(part_m[i] - M) * part_acc[i * d + col];
    }
    store(o + col, acc / L);
  }
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void *out, *lse, *part_m, *part_l, *part_acc;
  int B, H, Hk, d, Skv, split_len, num_splits;
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float softcap;                                      // 0: none
  cudaStream_t stream;
};

template <typename T, typename O, int MAXG, int DMAX>
int launch(const Args& a) {
  constexpr int smem = smem_bytes<T, MAXG, DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, O, MAXG, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.split_len % Tile<T, DMAX>::kRows != 0 ||
      static_cast<int64_t>(a.num_splits) * a.split_len < a.Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = a.H / a.Hk;
  const int direct = a.num_splits == 1;
  const float rd = sqrtf(static_cast<float>(a.d));
  const float log2e = 1.4426950408889634f;
  decode_partial<T, O, MAXG, DMAX>
      <<<dim3(a.num_splits, a.Hk, a.B), kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const int*>(a.kv_len),
          static_cast<O*>(a.out), static_cast<float*>(a.lse),
          static_cast<float*>(a.part_m),
          static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc),
          a.H, a.Hk, G, a.d, a.Skv, a.split_len, direct, a.k_sb, a.k_ss,
          a.k_sh, a.v_sb, a.v_ss, a.v_sh,
          a.softcap > 0.f ? 1.f / (rd * a.softcap) : log2e / rd,
          a.softcap > 0.f ? a.softcap * log2e : 0.f);
  if (!direct) {
    decode_combine<O><<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.part_m),
        static_cast<const float*>(a.part_l),
        static_cast<const float*>(a.part_acc),
        static_cast<const int*>(a.kv_len), static_cast<O*>(a.out),
        static_cast<float*>(a.lse), a.H,
        a.Hk, G, a.d, a.Skv, a.split_len, a.num_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's occupancy: resident blocks an SM and the tile's rows (of
// the instantiation that writes T; the one that writes fp32 beside the lse
// differs only in its last stores, and takes the same plan).
template <typename T, int MAXG, int DMAX>
int occupancy(int* blocks, int* tile_rows) {
  constexpr int smem = smem_bytes<T, MAXG, DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, T, MAXG, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_partial<T, T, MAXG, DMAX>, kThreads, smem);
  *tile_rows = Tile<T, DMAX>::kRows;
  return static_cast<int>(err);
}

template <int N>
using Int = std::integral_constant<int, N>;

// fn(Int<MAXG>, Int<DMAX>) for the instantiation that takes G and d.
template <typename Fn>
int dispatch(int G, int d, Fn&& fn) {
  auto with_d = [&](auto mg) {
    return d <= 64 ? fn(mg, Int<64>{})
                   : d <= 128 ? fn(mg, Int<128>{}) : fn(mg, Int<256>{});
  };
  return G <= 1   ? with_d(Int<1>{})
         : G <= 2 ? with_d(Int<2>{})
         : G <= 4 ? with_d(Int<4>{})
                  : with_d(Int<kMaxG>{});
}

bool bad_args(int dtype, int B, int H, int Hk, int d) {
  return B < 1 || Hk < 1 || H % Hk != 0 || H / Hk > kMaxG || d < 8 ||
         d > kMaxD || d % 8 != 0 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  q and out are contiguous (B, 1, H, d); k and v
// are (B, Skv, Hk, d) with unit stride on d, rows on 16 bytes, and the given
// element strides; kv_len is int32 (B,), clamped to [1, Skv].  The KV axis
// is cut into num_splits splits of split_len rows (a multiple of the tile's
// rows, from repro_decode_occupancy).  With one split the output is written
// at once; otherwise part_m and part_l hold B*Hk*num_splits*G floats,
// part_acc d times as many, and a second launch merges them.  lse, when
// not null, receives each (sequence, query head)'s log-sum-exp of its
// scores (natural log, fp32, (B, H)): the merged row's max and sum, what a
// caller needs to merge outputs over caches split across devices; out is
// then fp32 whatever the dtype, the partial output not yet rounded, so
// that such a merge rounds once.  softcap: 0
// for none, else the cap (scores cap*tanh(s/cap)).  Returns a cudaError_t:
// the arguments' check or the launches' status.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* lse, void* part_m, void* part_l, void* part_acc, int B, int H,
    int Hk, int d, int Skv, int split_len, int num_splits, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float softcap, void* stream) {
  if (bad_args(dtype, B, H, Hk, d) || Skv < 1 || split_len < 1 ||
      num_splits < 1 || num_splits > 65535 || Hk > 65535 || B > 65535 ||
      !(softcap >= 0.f && softcap < INFINITY))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_len, out, lse, part_m, part_l, part_acc,
               B, H, Hk, d, Skv, split_len, num_splits,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, softcap,
               static_cast<cudaStream_t>(stream)};
  return dispatch(H / Hk, d, [&](auto mg, auto md) {
    constexpr int MAXG = decltype(mg)::value, DMAX = decltype(md)::value;
    if (dtype == 0) return launch<float, float, MAXG, DMAX>(a);
    return lse != nullptr ? launch<__nv_bfloat16, float, MAXG, DMAX>(a)
                          : launch<__nv_bfloat16, __nv_bfloat16, MAXG, DMAX>(a);
  });
}

// The partial kernel's resident blocks an SM (`blocks`), the current
// device's SM count (`sms`) and the rows of its K/V tile (`tile_rows`) for
// this dtype, G = H / Hk and d: what the host needs to size the split.
extern "C" int repro_decode_occupancy(int dtype, int H, int Hk, int d,
                                      int* sms, int* blocks, int* tile_rows) {
  if (bad_args(dtype, 1, H, Hk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch(H / Hk, d, [&](auto mg, auto md) {
    constexpr int MAXG = decltype(mg)::value, DMAX = decltype(md)::value;
    return dtype == 0 ? occupancy<float, MAXG, DMAX>(blocks, tile_rows)
                      : occupancy<__nv_bfloat16, MAXG, DMAX>(blocks, tile_rows);
  });
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
