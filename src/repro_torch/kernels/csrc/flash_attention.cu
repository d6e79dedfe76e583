// Flash attention forward for Hopper (sm_90a): prefill attention of q
// (B, Sq, H, d) against k, v (B, Skv, Hk, d), G = H / Hk query heads per KV
// head, fp32 online softmax, causal and/or sliding-window masks from absolute
// positions, output (B, Sq, H, d) in the input type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`).
//
// Two kernels, chosen by the input type:
//   * bf16 runs on the tensor cores (`tc::wgmma_forward`, below);
//   * fp32 runs the scalar kernel (`scalar::flash_forward`): Hopper's tensor
//     cores have no fp32 x fp32 product, and TF32 keeps about three digits,
//     which the fp32 limit of 2e-5 does not allow.  Its only caller on the
//     port's paths is the profiling catalog's `flash-prefill` (B1 S128 H4
//     Hk2 d64), which launch time bounds.
//
// Bound.  A query tile of 64 rows against a key tile of 64 rows does
// 2 * 64 * 64 * d multiply-adds and reads 2 * 64 * d K/V elements, so at
// d = 128 the work is about 64 operations per byte in bf16: the kernel is
// bound by arithmetic, the tensor cores' 989 TFLOP/s in bf16 (H100 SXM).
//
// The bf16 kernel (FlashAttention's shape, on Hopper's wgmma):
//   * one block, one warpgroup of 4 warps, owns 64 query rows of one query
//     head, 16 rows a warp; the grid walks the query tiles last-first (the
//     slowest grid axis, reversed), so that the longest causal rows start
//     first on every head;
//   * Q is copied once into shared memory; K and V tiles of BK rows stream
//     through a two-stage ring by 16-byte cp.async, the next tile in flight
//     while the current one is computed.  Tiles are laid out as wgmma's
//     128-byte swizzle wants them: blocks of 64 columns, 128-byte rows, the
//     16-byte chunks of every 8 rows XOR-permuted (chunk ^ row % 8);
//   * S = Q K^T by wgmma m64nBKk16, Q and K read from shared memory through
//     matrix descriptors, fp32 accumulators in registers; S is scaled in
//     fp32 by log2(e) / sqrt(d) so that the exponentials are 2^x on the SFU
//     (the TPU kernel scaled q instead: a difference of fp32 rounding order);
//   * masks are applied only to tiles that cross the causal diagonal, the
//     window's edge or the end of the keys; tiles that the masks hide
//     entirely are never loaded;
//   * the online softmax runs in registers (row max and sum over the four
//     lanes that share a row), and the S accumulators are repacked in
//     registers as the A operand of P V: P never goes through shared memory;
//   * P is split into two bf16 terms, P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), and P V is accumulated from both by wgmma
//     m64n128k16 (m64n64k16 at head width 64) with A in registers and V read
//     transposed from shared memory.  A single bf16 rounding of P, as FlashAttention does, misses
//     the card check's limit (2e-5 beyond the output's own rounding) some
//     40-fold; the split keeps about 16 bits of P at 1.5x the MMA work.  Each
//     tile's P V starts from zero accumulators and is added to O in fp32, so
//     no sum runs through more than one tile's products inside the tensor
//     core;
//   * the epilogue divides by max(l, 1e-30), rounds once to bf16, and writes
//     whole 16-byte chunks through shared memory.
// Head widths are zero-padded in shared memory to 64, 128 or 256 (the class
// that `kernels/flash_attention.py:tile_plan` names), with a key tile of 64
// rows (32 at 256, to keep two blocks on an SM).  The computing warps make
// the loads themselves; a TMA producer warp with an mbarrier ring,
// and two warpgroups whose softmax and products overlap, are later work.
//
// Logit cap (Gemma 2's, the JAX model's `softcap`, which its Pallas kernel
// lacks): with cap > 0 a score s = q.k/sqrt(d) becomes cap*tanh(s/cap)
// before the mask and the softmax.  In the bf16 kernel the scale that S is
// multiplied by is then 1/(sqrt(d)*cap), so that the product is s/cap in
// natural units, and the score kept is cap*log2(e)*tanhf(s/cap) (its
// exponentials are 2^x).  The fp32 kernel keeps q's scale of 1/sqrt(d),
// exact at d 256, and divides s by cap, as the plain version does: a scale
// of 1/(sqrt(d)*cap) would round q once more, enough at scores near 30 to
// move the result past the fp32 rule at d 256.  tanhf is within 2 ulp;
// tanh.approx (2^-11 relative) would move a score at cap 50 by 0.025.  The
// bf16 kernel takes the cap as a template flag, so its uncapped
// instantiations are those of the kernel without a cap; the fp32 kernel
// takes it at run time.
// The cost is one tanhf a visible score, some twenty instructions: about
// 2.7e8 at B1 S4096 H32 causal.
//
// Both kernels read q, k and v in place through their strides (unit stride
// on d); the TPU code transposed all three to a heads-major layout on every
// call.  Query head h reads KV head h / G.  Rows past Sq and keys past Skv
// are masked here, so Sq and Skv need not be multiples of the tiles (the TPU
// kernel asserted they were multiples of its blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// ---------------------------------------------------------------------------
// The scalar kernel (fp32): scalar fp32 FMAs, bound by the fp32 rate.
//   * every (query row, key row) pair that the causal or window mask hides
//     for a whole 64 x 64 tile is never visited;
//   * each thread keeps a 4 x 4 block of scores and a 4 x ceil(d/16) block of
//     the output in registers, so every value read from shared memory feeds
//     four FMAs;
//   * the shared tiles have an odd row stride (d + 1 floats), so the 16 key
//     rows a warp reads in one step fall into 16 different banks.
// q is scaled by 1/sqrt(d) in fp32 as the TPU kernel scales it.
namespace scalar {

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 64;          // key rows a tile
constexpr int kThreads = 256;    // 16 x 16: ty picks 4 rows, tx 4 keys
constexpr int kPStride = kBK + 1;

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
              float sm_scale, float cap) {
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
        const float x = cap != 0.f ? cap * tanhf(s[i][j] / cap) : s[i][j];
        p_s[r * kPStride + kk] = ok ? x : -INFINITY;
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

}  // namespace scalar

// ---------------------------------------------------------------------------
// The bf16 kernel, on wgmma.
namespace tc {

constexpr int kThreads = 128;         // one warpgroup
constexpr int kBQ = 64;               // query rows a block, 16 a warp
constexpr int kStages = 2;            // K/V ring depth

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of DP bf16 a row,
// the chunks of every 8 rows XOR-permuted: the epilogue's staging layout.
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (DP * 2) + ((c ^ (r & 7)) << 4));
}


// D (64 x 64, fp32) = A (64 x 16, K-major, shared) * B (64 x 16, K-major,
// shared) [+ D when scale_d], both through 128B-swizzled descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) = A (64 x 16, K-major, shared) * B (32 x 16, K-major,
// shared) [+ D when scale_d], both through 128B-swizzled descriptors.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) = A (64 x 16, registers) * B (16 x 64, MN-major in
// shared memory, read transposed through a 128B-swizzled descriptor)
// [+ D when scale_d].
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A (64 x 16, registers) * B (16 x 128, MN-major in
// shared memory, read transposed through a 128B-swizzled descriptor: two
// blocks of 64 columns, the leading byte offset apart) [+ D when scale_d].
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// A shared-memory matrix descriptor of a 128B-swizzled layout: the start
// address, the leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the SFU (relative error about 2^-22; results below 2^-126 are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy writes of shared memory (cp.async)
// before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A tile of ROWS rows of DP bf16 is stored as DP/64 blocks of ROWS rows of
// 128 bytes (64 columns each), 16-byte chunks swizzled within every 8 rows
// (chunk ^ row % 8): the layout of wgmma's 128B swizzle.  Byte offset of
// chunk c of row r:
template <int ROWS>
__device__ __forceinline__ uint32_t atom_off(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (ROWS * 128) + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// Copy rows [row0, row0 + ROWS) of a (rows, d) matrix with row stride `rs`
// into a tile of that layout; rows at or past `limit` and columns at or
// past d are zeros.  A thread copies one column chunk of every kStep-th row,
// walking one pointer, so that no per-row address outlives the copy.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t rs, int row0, int limit,
                                          int d, int tid) {
  constexpr int kChunks = DP / 8, kStep = kThreads / kChunks;
  static_assert(ROWS % kStep == 0, "a tile is whole passes of the block");
  const int c = tid % kChunks, r = tid / kChunks;
  const bool col_ok = c * 8 < d;
  const bf16* p = src + (row0 + r) * rs + c * 8;
#pragma unroll
  for (int j = 0; j < ROWS / kStep; ++j) {
    const int rr = r + j * kStep;
    const bool ok = col_ok && row0 + rr < limit;
    cp_async16(dst + atom_off<ROWS>(rr, c), ok ? p : src, ok ? 16 : 0);
    p += kStep * rs;
  }
}

template <int DP, int BK>
struct Tile {
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kKS = DP / 16;       // 16-wide k steps of Q K^T
  static constexpr int kAtoms = DP / 64;    // 64-column blocks of O
  static constexpr int kPC = BK / 16;       // 16-key k steps of P V
  static constexpr int kS = BK / 2;         // S accumulators a thread
  // columns of one P V product: 128 (two blocks, the leading byte offset
  // apart) where the width allows, which measured faster than 64
  static constexpr int kPV = DP >= 128 ? 128 : 64;
};

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&x)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 128) wgmma_rs_n128(x, a, db, scale_d);
  else wgmma_rs_n64(x, a, db, scale_d);
}

template <int BK>
__device__ __forceinline__ void wgmma_s(float (&s)[BK / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64(s, da, db, scale_d);
  else wgmma_ss_n32(s, da, db, scale_d);
}

// One block (one warpgroup) per (query head, sequence, query tile of 64);
// blockIdx.z counts the query tiles from the last.  Without CAP, S is
// scaled by `scale` = log2(e)/sqrt(d); with it, by `scale` = 1/(sqrt(d)*cap)
// and then capped to cap_log2 * tanhf(.), cap_log2 = cap*log2(e).
template <int DP, int BK, bool CAP>
__global__ void __launch_bounds__(kThreads)
wgmma_forward(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
              int Skv, int H, int Hk, int d, int causal, int window,
              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
              int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
              int64_t v_sh, float scale, float cap_log2) {
  using C = Tile<DP, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;  // 1024-aligned
  const uint32_t k_s = q_s + C::kQBytes;                      // [stage]
  const uint32_t v_s = k_s + kStages * C::kKVBytes;           // [stage]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kh * k_sh;
  const bf16* vb = v + b * v_sb + kh * v_sh;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / BK, t_end = (k_hi + BK - 1) / BK;

  load_tile<DP, kBQ>(q_s, qb, q_ss, q0, Sq, d, tid);
  load_tile<DP, BK>(k_s, kb, k_ss, t_begin * BK, Skv, d, tid);
  load_tile<DP, BK>(v_s, vb, v_ss, t_begin * BK, Skv, d, tid);
  cp_async_commit();

  float o[C::kAtoms][32];
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % kStages;
    if (t + 1 < t_end) {
      const int ns = (stage + 1) % kStages;
      load_tile<DP, BK>(k_s + ns * C::kKVBytes, kb, k_ss, (t + 1) * BK, Skv,
                        d, tid);
      load_tile<DP, BK>(v_s + ns * C::kKVBytes, vb, v_ss, (t + 1) * BK, Skv,
                        d, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t kt_s = k_s + stage * C::kKVBytes;
    const uint32_t vt_s = v_s + stage * C::kKVBytes;

    // S = Q K^T: 64 rows x BK keys, DP/16 k steps.
    float s[C::kS];
#pragma unroll
    for (int i = 0; i < C::kS; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKS; ++kk) {
      const uint32_t koff = (kk & 3) * 32;
      wgmma_s<BK>(s, desc(q_s + (kk >> 2) * (kBQ * 128) + koff, 0, 1024),
                  desc(kt_s + (kk >> 2) * (BK * 128) + koff, 0, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();

    // Scale, and mask the tiles that a mask crosses; s[4j + e] holds row
    // r0 (e < 2) or r1, key kt + 8j + 2 t4 + (e & 1).
    const int kt = t * BK;
    const bool edge = kt + BK > Skv || (causal && kt + BK - 1 > q0) ||
                      (window > 0 && kt <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      float x = CAP ? cap_log2 * tanhf(s[i] * scale) : s[i] * scale;
      if (edge) {
        const int qp = (i & 2) ? r1 : r0;
        const int kp = kt + (i >> 2) * 8 + t4 * 2 + (i & 1);
        const bool ok = kp < Skv && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        if (!ok) x = -INFINITY;
      }
      s[i] = x;
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < C::kS; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = ex2(m0 - u0), c1 = ex2(m1 - u1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < C::kS; i += 4) {
      s[i] = ex2(s[i] - u0);
      s[i + 1] = ex2(s[i + 1] - u0);
      s[i + 2] = ex2(s[i + 2] - u1);
      s[i + 3] = ex2(s[i + 3] - u1);
      sum0 += s[i] + s[i + 1];
      sum1 += s[i + 2] + s[i + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;

    // P as A fragments in two bf16 terms (hi, lo), from the accumulators.
    uint32_t ph[C::kPC][4], pl[C::kPC][4];
#pragma unroll
    for (int kc = 0; kc < C::kPC; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* f = s + (2 * kc + (i >> 1)) * 4 + (i & 1) * 2;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(f[0], f[1]);
        const float2 hf = __bfloat1622float2(hi);
        ph[kc][i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kc][i] = pack_bf16(f[0] - hf.x, f[1] - hf.y);
      }
    }

    // O = O * corr + (P_hi + P_lo) V, C::kPV columns at a time, the
    // tile's product from zero.
#pragma unroll
    for (int a = 0; a < C::kAtoms; a += C::kPV / 64) {
      float x[C::kPV / 2];
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < C::kPC; ++kc) {
        const uint64_t dv = desc(vt_s + a * (BK * 128) + kc * 16 * 128,
                                 BK * 128, 1024);
        wgmma_pv<C::kPV>(x, ph[kc], dv, kc > 0);  // x starts at this product
        wgmma_pv<C::kPV>(x, pl[kc], dv, 1);
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int i = 0; i < C::kPV / 2; ++i)
        o[a + i / 32][i % 32] =
            fmaf(o[a + i / 32][i % 32], (i & 2) ? c1 : c0, x[i]);
    }
    __syncthreads();           // this stage's readers are done
  }

  // Epilogue: O / max(l, 1e-30), one bf16 rounding, through this warp's 16
  // rows of the Q tile (as a plain row-swizzled tile), then 16-byte stores.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const int w0 = warp * 16 + g;
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t lo = pack_bf16(o[a][4 * j] / l0, o[a][4 * j + 1] / l0);
      const uint32_t hi = pack_bf16(o[a][4 * j + 2] / l1, o[a][4 * j + 3] / l1);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   ::"r"(q_s + swz<DP>(w0, 8 * a + j) + t4 * 4), "r"(lo)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n"
                   ::"r"(q_s + swz<DP>(w0 + 8, 8 * a + j) + t4 * 4),
                   "r"(hi)
                   : "memory");
    }
  }
  __syncwarp();
  const int cpr = d / 8;
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr, c = i - r * cpr;
    const int qr = q0 + warp * 16 + r;
    if (qr >= Sq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(q_s + swz<DP>(warp * 16 + r, c))
                 : "memory");
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * Sq + qr) * H + h) * d + c * 8) = val;
  }
}

}  // namespace tc

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Skv, H, Hk, d, causal, window;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float softcap;                                      // 0: none
  cudaStream_t stream;
};

template <int NCOL>
int launch_scalar(const Args& a) {
  using scalar::kBQ;
  const size_t smem = scalar::smem_floats(a.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scalar::flash_forward<float, NCOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  const float rd = sqrtf(static_cast<float>(a.d));
  scalar::flash_forward<float, NCOL>
      <<<grid, scalar::kThreads, smem, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<float*>(a.out), a.Sq,
          a.Skv, a.H, a.Hk, a.d, a.causal, a.window, a.q_sb, a.q_ss, a.q_sh,
          a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh,
          1.0f / rd, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(const Args& a) {
  if (a.d <= 64) return launch_scalar<4>(a);
  if (a.d <= 128) return launch_scalar<8>(a);
  return launch_scalar<16>(a);
}

template <int DP, int BK, bool CAP>
int launch_tc(const Args& a) {
  using C = tc::Tile<DP, BK>;
  const cudaError_t attr = cudaFuncSetAttribute(
      tc::wgmma_forward<DP, BK, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (a.Sq + tc::kBQ - 1) / tc::kBQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.H, a.B, tiles);
  const float log2e = 1.4426950408889634f;
  const float rd = sqrtf(static_cast<float>(a.d));
  tc::wgmma_forward<DP, BK, CAP><<<grid, tc::kThreads, C::kSmem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<tc::bf16*>(a.out), a.Sq,
      a.Skv, a.H, a.Hk, a.d, a.causal, a.window, a.q_sb, a.q_ss, a.q_sh,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh,
      CAP ? 1.0f / (rd * a.softcap) : log2e / rd, a.softcap * log2e);
  return static_cast<int>(cudaGetLastError());
}

// The (padded width, key tile) classes of the bf16 kernel; they must match
// `tile_plan` in kernels/flash_attention.py, and any other pair is refused.
template <bool CAP>
int launch_bf16(const Args& a, int dp, int bk) {
  if (a.d > dp) return static_cast<int>(cudaErrorInvalidValue);
  if (dp == 64 && bk == 64) return launch_tc<64, 64, CAP>(a);
  if (dp == 128 && bk == 64) return launch_tc<128, 64, CAP>(a);
  if (dp == 256 && bk == 32) return launch_tc<256, 32, CAP>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32 (scalar kernel), 1 = bf16 (tensor-core kernel, head width
// padded to dp with key tiles of bk rows).  q (B, Sq, H, d) and k, v
// (B, Skv, Hk, d) with unit stride on d and the given element strides
// (batch, sequence, head); for bf16 every row starts on 16 bytes.  out is
// contiguous (B, Sq, H, d).  causal: 0 or 1; window: 0 for none, else the
// sliding window (keys in (q - window, q]).  softcap: 0 for none, else the
// cap (scores cap*tanh(s/cap)).  Every query row must see at least one key
// (the caller checks).  Returns a cudaError_t: the arguments' check or the
// launch's status.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int Sq, int Skv, int H, int Hk, int d, int causal, int window,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float softcap, int dp, int bk, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hk < 1 || H % Hk != 0 || d < 8 ||
      d > kMaxD || d % 8 != 0 || window < 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1) || !(softcap >= 0.f && softcap < INFINITY))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    out,  B,    Sq,   Skv,  H,    Hk,   d,
               causal, window, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
               v_sh, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_fp32(a);
  return softcap > 0.f ? launch_bf16<true>(a, dp, bk)
                       : launch_bf16<false>(a, dp, bk);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
