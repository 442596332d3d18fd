// Grouped matrix multiply (gmm) and its transposed form (tgmm) for Hopper
// (sm_90a): the dropless MoE expert FFN's three products and their
// gradients.
//
// Replaces: the megablox Pallas TPU kernels the JAX package calls from
//   tensorflow_train_distributed_tpu/models/moe.py:248-265 (_gmm) through
//   jax/experimental/pallas/ops/tpu/megablox/ops.py (gmm, a custom_vjp):
//   gmm (megablox/gmm.py:314, pallas_call :526) for the forward and, with
//   transpose_rhs, the grad_lhs; tgmm (gmm.py:573, pallas_call :763) for
//   the grad_rhs (ops.py:63-106, _gmm_bwd).
//     gmm:  out[r, :] = lhs[r, :] . rhs[g(r)] for the rows r of group g
//           (rhs [E, k, n], or [E, n, k] read transposed); rows past the
//           sum of the group sizes are written as zeros.
//     tgmm: out[g] = lhs[rows of g, :]^T . rhs[rows of g, :], [E, k, n];
//           an empty group writes zeros (its expert gets a zero gradient).
//   Numerics are megablox's (common.py select_input_dtype): bf16 x bf16
//   products on the tensor cores with f32 accumulation; an f32 operand
//   makes the whole product f32 (the bf16 one converted exactly); the
//   output is rounded once to its dtype.
//
// Bound on this card (moe_370m: m 16384, k 768, n 2048, 51.5 GFLOP a
//   product): bf16 x bf16 -> f32 is bound by its bytes, the f32 output
//   (134 MB) most of them, 55.1 us at 3.35 TB/s against 52.1 us of
//   operations at 989 TFLOP/s.  An f32 operand: each f32 value is the sum
//   of three bf16 terms, so the same products run as three bf16 tensor-
//   core products, 3 x 52.1 = 156.3 us (bytes 55.1 us); on FMAs they
//   would take 769.2 us at 67 TFLOP/s.
//
// Bodies, chosen statically by the operands (gmm_body, tgmm_body; the
//   wrappers' K.gmm_body / K.tgmm_body name them):
//
// "wgmma" (bf16 rhs with a bf16 or f32 lhs for gmm; bf16 lhs with a bf16
//   or f32 rhs for tgmm; bases and rows 16-byte aligned, as TMA needs).
//   384 threads: warpgroup 2 is the producer, one thread of it keeping
//   TMA loads (128-byte swizzle, rank-2 and rank-3 tensor maps encoded on
//   the host per call, elements past an edge read as zeros) in flight in
//   a ring of 4 stages of 64 of depth, each with a full and an empty
//   mbarrier; warpgroups 0 and 1 each own 64 output rows.
//   gmm: a block owns a 128-row tile of one group (each group's tiles
//   counted from its first row; the grid is the upper bound ceil(m /
//   128) + E + 1 row tiles, the surplus blocks return, the extra group is
//   the zero tail past the sizes' sum) by BN columns, the column tiles of
//   a row strip neighbours in launch order.  bf16 x bf16: BN 256, wgmma
//   from shared memory (lhs K-major, rhs MN-major through the transpose
//   bit, or K-major with transpose_rhs), one stage in flight while the
//   next is issued, f32 accumulators in registers.  A 128-row box that
//   crosses into the next group only computes rows that are not stored;
//   a warpgroup whose 64 rows all lie past the group skips its products.
//   tgmm: a block owns one (128 k, 128 n, group) and loops over the
//   group's rows: out[g]^T = cot^T . x, the cotangent the A operand read
//   MN-major, x the B operand read MN-major; depth rows past the group
//   are zeroed in both tiles before the products (0 x Inf is NaN);
//   out[g] is written through a transposed tile.  No atomics: bitwise
//   repeatable.
//   An f32 operand (grad_lhs: the cotangent [rows, n] K-major; tgmm: the
//   cotangent MN-major) is loaded by TMA unconverted (32-column panels)
//   and read by each consumer thread into wgmma's register-A layout
//   (conflict-free through the swizzle for tgmm, 2-way for grad_lhs'
//   8-byte loads); each value splits exactly into hi = bf16(a), mid =
//   bf16(a - hi), lo = bf16(a - hi - mid), and three register-A wgmma
//   passes (lo, mid, hi) run against the same bf16 B.  The tensor core
//   truncates its running sum, so each stage's passes go into a fresh
//   accumulator that is added to an f32 total with rounded adds: the
//   truncation stays near sqrt(depth) instead of growing with depth, and
//   the products meet the f32 tolerance (ops/kernels.py gmm_tolerance).
//   BN 128 (the total and the stage's accumulator take 128 registers).
//   Epilogue: the accumulators through an f32 tile in shared memory
//   (reusing the ring), then 16-byte stores of whole row runs, masked
//   only at a tile's ragged edge.
//   Left for later: a persistent grid whose epilogue overlaps the next
//   tile's loads, TMA multicast across a cluster, and a wider tile for
//   the split products.
// "mma.sync" (other bf16 x bf16: rows of the operands not 16-byte
//   multiples, e.g. k 36) and "FMA" (every other input, f32 x f32 and a
//   bf16 gmm lhs against an f32 rhs among them): the first port's bodies.
//   A block computes a 64 x 128 tile from 32-deep slices staged in shared
//   memory, one slice in flight: bf16 x bf16 with mma.sync m16n8k16 (each
//   warp a 16-row strip), f32 with FMAs (an 8 x 8 register tile a
//   thread).  Slices are staged with 16-byte loads where the operands'
//   alignment allows, their layout turned in registers where the shared
//   tile wants the other axis contiguous.  gmm counts 64-row tiles; a
//   tgmm block owns one (k tile, n tile, group), reading lhs [m, k] in
//   place (megablox's lhs.swapaxes(0, 1) is never built).
// Every body keeps the group sizes on the device: warp 0 of a block
//   walks them 32 at a time (find_row_tile, group_span).
#include <type_traits>

#include "flash_common.cuh"

namespace ttd_grouped {
namespace {

using bf16 = __nv_bfloat16;
using ttd_flash::bits;
using ttd_flash::ld32;
using ttd_flash::mma16816;
using ttd_flash::split3;

constexpr int kTm = 64;         // output rows a block
constexpr int kTn = 128;        // output columns a block
constexpr int kTk = 32;         // depth of one staged slice
constexpr int kThreads = 128;   // four warps
constexpr int kLdH = kTk + 8;   // bf16 tiles: [rows][kLdH], depth contiguous
constexpr int kLdT = kTn + 8;   // bf16 B tile read by rows: [depth][kLdT]
constexpr int kLdA = kTm + 4;   // f32 tiles: [depth][kLdA] and [depth][kLdB]
constexpr int kLdB = kTn + 4;
constexpr int kSmemH = (kTm * kLdH + (kTn * kLdH > kTk * kLdT
                                         ? kTn * kLdH : kTk * kLdT)) * 2;
constexpr int kSmemF = kTk * (kLdA + kLdB) * 4;
constexpr int kSmem = kSmemH > kSmemF ? kSmemH : kSmemF;

template <typename TC>
struct Cvt;
template <>
struct Cvt<float> {
  template <typename TS>
  static __device__ __forceinline__ float of(TS v) { return ttd::to_f32(v); }
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <>
struct Cvt<bf16> {
  static __device__ __forceinline__ bf16 of(bf16 v) { return v; }
  static __device__ __forceinline__ bf16 zero() { return __float2bfloat16(0.f); }
};

// One operand of a tile product, [rows x depth]: element (i, kk) lies at
// base[i * si + kk * sk]; rows at or past ``ni`` read as zero.
template <typename TS>
struct Operand {
  const TS* base;
  long long si, sk;
  int ni;
};

// Stores element (i, kk) of a staged slice.
template <typename TC, typename TS>
__device__ __forceinline__ void put(TC* dst, int di, int dk, int i, int kk,
                                    TS v) {
  dst[i * di + kk * dk] = Cvt<TC>::of(v);
}

// Stages the depth slice [k0, k0 + nk) of R operand rows into shared
// memory as TC, element (i, kk) at dst[i * di + kk * dk]; rows at or past
// ni and depth past nk are zero.  Loads are 16-byte vectors of V
// elements along the source's contiguous axis (rows i when si == 1,
// depth kk when sk == 1) wherever the operand's alignment allows and the
// vector lies inside the operand, element by element elsewhere.  When
// the shared layout is contiguous along the same axis, neighbouring
// threads take neighbouring vectors (coalesced loads, whole-vector
// stores); when it is transposed, neighbouring threads take neighbouring
// lines of the other axis, so that each of the V scalar stores of a warp
// falls on distinct banks.
template <typename TC, typename TS, int R>
__device__ __forceinline__ void stage(TC* dst, int di, int dk,
                                      const Operand<TS>& op, long long k0,
                                      int nk) {
  constexpr int V = 16 / static_cast<int>(sizeof(TS));
  const bool kk_contig = op.sk == 1;
  const TS* base = op.base + k0 * op.sk;
  const long long stride = kk_contig ? op.si : op.sk;   // between lines
  const int lines = kk_contig ? R : kTk;                // other axis
  const int nvec = (kk_contig ? kTk : R) / V;           // vectors a line
  const int valid_lines = kk_contig ? op.ni : nk;
  const int valid_along = kk_contig ? nk : op.ni;
  const bool aligned = (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
                       stride % V == 0;
  const bool same = kk_contig ? dk == 1 : di == 1;
  for (int e = threadIdx.x; e < lines * nvec; e += kThreads) {
    const int line = same ? e / nvec : e % lines;
    const int vec = same ? e % nvec : e / lines;
    const int c0 = vec * V;
    const TS* src = base + line * stride + c0;
    const bool inside = line < valid_lines;
    if (aligned && inside && c0 + V <= valid_along) {
      union {
        uint4 raw;
        TS v[V];
      } u;
      u.raw = *reinterpret_cast<const uint4*>(src);
      TC* d = kk_contig ? dst + line * di + c0 : dst + c0 + line * dk;
      if constexpr (std::is_same<TC, TS>::value) {
        if (same) {
          // One 16-byte store (the offsets are 16-byte aligned: pitches
          // and c0 are multiples of V elements).
          *reinterpret_cast<uint4*>(d) = u.raw;
          continue;
        }
      } else {
        if (same) {                     // bf16 -> f32: two 16-byte stores
          float4 lo, hi;
          lo.x = ttd::to_f32(u.v[0]); lo.y = ttd::to_f32(u.v[1]);
          lo.z = ttd::to_f32(u.v[2]); lo.w = ttd::to_f32(u.v[3]);
          hi.x = ttd::to_f32(u.v[4]); hi.y = ttd::to_f32(u.v[5]);
          hi.z = ttd::to_f32(u.v[6]); hi.w = ttd::to_f32(u.v[7]);
          reinterpret_cast<float4*>(d)[0] = lo;
          reinterpret_cast<float4*>(d)[1] = hi;
          continue;
        }
      }
      {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (kk_contig) put(dst, di, dk, line, c0 + j, u.v[j]);
          else put(dst, di, dk, c0 + j, line, u.v[j]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool ok = inside && c0 + j < valid_along;
        const int i = kk_contig ? line : c0 + j;
        const int kk = kk_contig ? c0 + j : line;
        dst[i * di + kk * dk] = ok ? Cvt<TC>::of(src[j]) : Cvt<TC>::zero();
      }
    }
  }
}

// Four 8 x 8 bf16 matrices from shared memory, transposed (ldmatrix):
// lanes 8q..8q+7 give the row addresses of matrix q, r[q] its fragment.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <bool kMma>
struct Core;

// bf16 x bf16: tensor cores.  Warp w owns output rows 16w..16w+15 in the
// mma accumulator layout (flash_common.cuh): lane 4g + t holds, for each
// 8-column tile n, rows g and g + 8 at columns 8n + 2t and 8n + 2t + 1.
template <>
struct Core<true> {
  float acc[kTn / 8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kTn / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  template <typename TA, typename TB>
  __device__ __forceinline__ void run(const Operand<TA>& a,
                                      const Operand<TB>& b, long long depth,
                                      unsigned char* smem) {
    bf16* as = reinterpret_cast<bf16*>(smem);
    bf16* bs = as + kTm * kLdH;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bf16* aw = as + warp * 16 * kLdH;
    // B with its columns contiguous (rhs [k, n]) is staged as
    // [depth][kLdT] with 16-byte copies and its fragments read with
    // ldmatrix.trans; B with its depth contiguous as [n][kLdH].
    const bool b_rows = b.si == 1 && b.sk != 1;
    // ldmatrix: lane 8q + r addresses row r of matrix q = (depth half
    // q & 1, column tile q >> 1).
    const bf16* bl = bs + ((lane >> 3 & 1) * 8 + (lane & 7)) * kLdT +
                     (lane >> 4) * 8;
    for (long long k0 = 0; k0 < depth; k0 += kTk) {
      const int nk = static_cast<int>(depth - k0 < kTk ? depth - k0 : kTk);
      __syncthreads();                  // the previous slice is consumed
      stage<bf16, TA, kTm>(as, kLdH, 1, a, k0, nk);
      if (b_rows) stage<bf16, TB, kTn>(bs, 1, kLdT, b, k0, nk);
      else stage<bf16, TB, kTn>(bs, kLdH, 1, b, k0, nk);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTk; kk += 16) {
        uint32_t af[4];
        af[0] = ld32(aw + g * kLdH + kk + 2 * t);
        af[1] = ld32(aw + (g + 8) * kLdH + kk + 2 * t);
        af[2] = ld32(aw + g * kLdH + kk + 8 + 2 * t);
        af[3] = ld32(aw + (g + 8) * kLdH + kk + 8 + 2 * t);
        if (b_rows) {
#pragma unroll
          for (int n = 0; n < kTn / 8; n += 2) {
            uint32_t r[4];
            ldsm_x4_trans(r, bl + kk * kLdT + n * 8);
            mma16816(acc[n], af, r);
            mma16816(acc[n + 1], af, r + 2);
          }
        } else {
#pragma unroll
          for (int n = 0; n < kTn / 8; ++n) {
            uint32_t bfr[2];
            bfr[0] = ld32(bs + (n * 8 + g) * kLdH + kk + 2 * t);
            bfr[1] = ld32(bs + (n * 8 + g) * kLdH + kk + 8 + 2 * t);
            mma16816(acc[n], af, bfr);
          }
        }
      }
    }
  }

  // Writes the tile's first ``ni`` rows and ``nj`` columns to out
  // (row stride ``ld`` elements).
  template <typename TO>
  __device__ __forceinline__ void store(TO* out, long long ld, int ni,
                                        int nj) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < kTn / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = warp * 16 + g + (e >= 2 ? 8 : 0);
        const int j = n * 8 + 2 * t + (e & 1);
        if (i < ni && j < nj) out[i * ld + j] = ttd::from_f32<TO>(acc[n][e]);
      }
    }
  }
};

// f32 products with FMAs: thread (ty, tx) = (tid / 16, tid % 16) owns
// rows 8ty..8ty+7 and columns 4tx..4tx+3 and 64+4tx..64+4tx+3.
template <>
struct Core<false> {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  static __device__ __forceinline__ int col(int tx, int c) {
    return c < 4 ? 4 * tx + c : kTn / 2 + 4 * tx + c - 4;
  }

  template <typename TA, typename TB>
  __device__ __forceinline__ void run(const Operand<TA>& a,
                                      const Operand<TB>& b, long long depth,
                                      unsigned char* smem) {
    float* as = reinterpret_cast<float*>(smem);
    float* bs = as + kTk * kLdA;
    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
    for (long long k0 = 0; k0 < depth; k0 += kTk) {
      const int nk = static_cast<int>(depth - k0 < kTk ? depth - k0 : kTk);
      __syncthreads();
      stage<float, TA, kTm>(as, 1, kLdA, a, k0, nk);
      stage<float, TB, kTn>(bs, 1, kLdB, b, k0, nk);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTk; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kLdA + 8 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kLdA + 8 * ty + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kLdB + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kLdB + kTn / 2 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
  }

  template <typename TO>
  __device__ __forceinline__ void store(TO* out, long long ld, int ni,
                                        int nj) const {
    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = 8 * ty + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = col(tx, c);
        if (i < ni && j < nj) out[i * ld + j] = ttd::from_f32<TO>(acc[r][c]);
      }
    }
  }
};

// The group sizes, walked by one warp 32 groups at a time (one round
// trip to memory per 32 groups, not one per group).  A group's rows are
// [min(P, m), min(P + size, m)), P the sum of the sizes before it
// (negative sizes count as 0).

// Row tile ``t`` (each group's TM-row tiles counted from its first row,
// then the zero tail past the sizes' sum as group ``groups``) into
// tile = (group, first row, rows), or group -1 past the last tile.
// Called by the 32 threads of warp 0.
template <int TM>
__device__ __forceinline__ void find_row_tile(const int* sizes, int groups,
                                              int m, int t, int* tile) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) tile[0] = -1;
  __syncwarp();
  long long base = 0;
  int tbase = 0;
  for (int e0 = 0; e0 <= groups; e0 += 32) {
    const int e = e0 + lane;
    const long long size =
        e < groups ? max(sizes[e], 0) : (e == groups ? m : 0);
    long long incl = size;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const long long p = base + incl - size;
    const int start = static_cast<int>(min(p, static_cast<long long>(m)));
    const int end = static_cast<int>(min(p + size, static_cast<long long>(m)));
    const int tiles = (end - start + TM - 1) / TM;
    int tincl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, tincl, o);
      if (lane >= o) tincl += v;
    }
    const int first = tbase + tincl - tiles;
    if (tiles > 0 && t >= first && t < first + tiles) {
      const int r = start + (t - first) * TM;
      tile[0] = e;
      tile[1] = r;
      tile[2] = min(TM, end - r);
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
    tbase += __shfl_sync(0xffffffffu, tincl, 31);
  }
}

// Group g's rows into span = (first row, rows).  Warp 0.
__device__ __forceinline__ void group_span(const int* sizes, int g, int m,
                                           int* span) {
  const int lane = threadIdx.x & 31;
  long long p = 0;
  for (int e = lane; e < g; e += 32) p += max(sizes[e], 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if (lane == 0) {
    const long long mm = m;
    const int start = static_cast<int>(min(p, mm));
    span[0] = start;
    span[1] = static_cast<int>(min(p + max(sizes[g], 0), mm)) - start;
  }
}

template <typename TA, typename TB, typename TO, bool kMma>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const TA* lhs, const TB* rhs, const int* sizes, TO* out, int m,
               int k, int n, int groups, int transpose_rhs) {
  __shared__ int tile[3];               // group (groups: zero tail), row, rows
  __shared__ __align__(16) unsigned char smem[kSmem];
  if (threadIdx.x < 32) find_row_tile<kTm>(sizes, groups, m, blockIdx.x, tile);
  __syncthreads();
  const int g = tile[0];
  if (g < 0) return;                    // a surplus block
  const int r0 = tile[1];
  const int rows = tile[2];
  const int j0 = blockIdx.y * kTn;
  const int nj = min(kTn, n - j0);
  Core<kMma> core;
  core.zero();
  if (g < groups) {
    const Operand<TA> a{lhs + static_cast<long long>(r0) * k, k, 1, rows};
    const TB* w = rhs + static_cast<long long>(g) * k * n;
    const Operand<TB> b =
        transpose_rhs
            ? Operand<TB>{w + static_cast<long long>(j0) * k, k, 1, nj}
            : Operand<TB>{w + j0, 1, n, nj};
    core.run(a, b, k, smem);
  }
  core.store(out + static_cast<long long>(r0) * n + j0, n, rows, nj);
}

template <typename TA, typename TB, typename TO, bool kMma>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const TA* lhs, const TB* rhs, const int* sizes, TO* out, int m,
                int k, int n) {
  __shared__ int span[2];               // the group's first row, rows
  __shared__ __align__(16) unsigned char smem[kSmem];
  const int g = blockIdx.z;
  if (threadIdx.x < 32) group_span(sizes, g, m, span);
  __syncthreads();
  const int start = span[0];
  const int i0 = blockIdx.x * kTm;
  const int j0 = blockIdx.y * kTn;
  const int ni = min(kTm, k - i0);
  const int nj = min(kTn, n - j0);
  Core<kMma> core;
  core.zero();
  const Operand<TA> a{lhs + static_cast<long long>(start) * k + i0, 1, k, ni};
  const Operand<TB> b{rhs + static_cast<long long>(start) * n + j0, 1, n, nj};
  core.run(a, b, span[1], smem);
  core.store(out + static_cast<long long>(g) * k * n +
                 static_cast<long long>(i0) * n + j0,
             n, ni, nj);
}

template <typename TA, typename TB, typename TO, bool kMma>
int launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out,
               int m, int k, int n, int groups, int transpose_rhs,
               cudaStream_t stream) {
  const dim3 grid((m + kTm - 1) / kTm + groups + 1, (n + kTn - 1) / kTn);
  gmm_kernel<TA, TB, TO, kMma><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs),
      static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n, groups,
      transpose_rhs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB, typename TO, bool kMma>
int launch_tgmm(const void* lhs, const void* rhs, const void* sizes,
                void* out, int m, int k, int n, int groups,
                cudaStream_t stream) {
  const dim3 grid((k + kTm - 1) / kTm, (n + kTn - 1) / kTn, groups);
  tgmm_kernel<TA, TB, TO, kMma><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs),
      static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// -- the wgmma body --------------------------------------------------------

namespace hw = ttd_hopper;

constexpr int kWgBm = 128;        // output rows a block: two warpgroups of 64
constexpr int kWgBk = 64;         // depth of one ring stage
constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kStages = 4;

// The ring for an A operand of type TA (bf16: read through descriptors;
// f32: read by the consumers and split) and a bf16 B operand, for output
// tiles of 128 x BN.  A stage is A's 128 x 64 (gmm) or 64 x 128 (tgmm)
// tile, then B's 64 x BN tile, each in 128-byte swizzled panels; the
// epilogue's f32 tile reuses the ring once every stage is consumed.
template <typename TA, int BN>
struct WgCfg {
  static constexpr bool kSplit = std::is_same<TA, float>::value;
  static constexpr int kABytes = kWgBm * kWgBk * static_cast<int>(sizeof(TA));
  static constexpr int kBBytes = kWgBk * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kEp = kWgBm * (BN + 8) * 4;
  static constexpr int kBars = kRing > kEp ? kRing : kEp;
  static constexpr int kSmem = 1024 + kBars + 2 * kStages * 8;
};

// Output columns a block: 256 for bf16 x bf16 gmm (the tile's operands
// are read from L2 once per 128 x 256 outputs, not 128 x 128), 128 where
// an f32 operand is split (its two f32 accumulators take 128 registers).
template <typename TA>
__host__ __device__ constexpr int gmm_bn() {
  return std::is_same<TA, float>::value ? 128 : 256;
}

// Element (row, col) of an f32 tile of 32-column, 128-byte swizzled panels
// of ``ROWS`` rows (TMA's layout with CU_TENSOR_MAP_SWIZZLE_128B).
template <int ROWS>
__device__ __forceinline__ const float* f32_at(const float* tile, int row,
                                               int col) {
  return tile + (col >> 5) * ROWS * 32 + row * 32 +
         ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// The split A fragments of depth step kk of a 64-row warpgroup slice, in
// the layout of mma.sync m16n8k16's A: register 0 (row g, depth 2t and
// 2t + 1), 1 (row g + 8), 2 (row g, depth 2t + 8), 3 (row g + 8, 2t + 8).
// ``KMAJOR``: A's tile is [128 rows][64 depth] (gmm, rows from ``row0``);
// else [64 depth][128 rows] (tgmm: the cotangent read MN-major).  Both
// read conflict-free or 2-way (KMAJOR's 8-byte loads) through the
// swizzle.
template <bool KMAJOR>
__device__ __forceinline__ void split_frag(const float* as, int row0, int kk,
                                           uint32_t* hi, uint32_t* mid,
                                           uint32_t* lo) {
  const int tid = threadIdx.x & 127;
  const int r = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int d = 16 * kk + 2 * (tid & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int rr = r + (q & 1) * 8;
    const int dd = d + (q >> 1) * 8;
    float x0, x1;
    if constexpr (KMAJOR) {
      const float2 v =
          *reinterpret_cast<const float2*>(f32_at<kWgBm>(as, rr, dd));
      x0 = v.x;
      x1 = v.y;
    } else {
      x0 = *f32_at<kWgBk>(as, dd, rr);
      x1 = *f32_at<kWgBk>(as, dd + 1, rr);
    }
    split3(x0, x1, hi[q], mid[q], lo[q]);
  }
}

// B's descriptor at depth step kk for output columns [128 h, 128 h + 128):
// MN-major (TB = 1) [64 depth][BN columns] in 64-column panels, or
// K-major [BN rows][64 depth] in one panel.
template <int TB, int BN>
__device__ __forceinline__ uint64_t desc_b(const bf16* bs, int kk, int h) {
  if constexpr (TB) return hw::desc_mn<kWgBk>(bs + h * 2 * kWgBk * 64, kk);
  else return hw::desc_k<BN>(bs, 128 * h, kk);
}

// A consumer warpgroup's share of one ring stage: its [64, BN] product
// over the stage's 64 of depth.  bf16 A: wgmma from descriptors into
// ``acc`` (one m64n128k16 per 128 columns and depth step), left in
// flight (the caller waits).  f32 A: the split terms into a fresh
// ``chunk`` (lo, then mid, then hi: the small terms first, so that the
// tensor core's truncation of its running sum falls on the smallest
// values), waited for, then added to ``acc`` with rounded f32 adds.
template <typename TA, bool KMAJOR_A, int TB, int BN>
struct Stage;

template <bool KMAJOR_A, int TB, int BN>
struct Stage<bf16, KMAJOR_A, TB, BN> {
  static __device__ __forceinline__ void run(float* acc, float*,
                                             const unsigned char* st, int wg,
                                             bool first) {
    const bf16* as = reinterpret_cast<const bf16*>(st);
    const bf16* bs =
        reinterpret_cast<const bf16*>(st + WgCfg<bf16, BN>::kABytes);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk) {
      const uint64_t da = KMAJOR_A ? hw::desc_k<kWgBm>(as, 64 * wg, kk)
                                   : hw::desc_mn<kWgBk>(as + wg * 64 * 64, kk);
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
        hw::wgmma_ss<128, KMAJOR_A ? 0 : 1, TB>(acc + 64 * h, da,
                                              desc_b<TB, BN>(bs, kk, h),
                                              !first || kk > 0);
    }
    hw::wgmma_commit();
  }
};

template <bool KMAJOR_A, int TB>
struct Stage<float, KMAJOR_A, TB, 128> {
  static __device__ __forceinline__ void run(float* acc, float* chunk,
                                             const unsigned char* st, int wg,
                                             bool) {
    const float* as = reinterpret_cast<const float*>(st);
    const bf16* bs =
        reinterpret_cast<const bf16*>(st + WgCfg<float, 128>::kABytes);
    uint32_t hi[kWgBk / 16][4], mid[kWgBk / 16][4], lo[kWgBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk)
      split_frag<KMAJOR_A>(as, 64 * wg, kk, hi[kk], mid[kk], lo[kk]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk)
      hw::wgmma_rs<128, TB>(chunk, lo[kk], desc_b<TB, 128>(bs, kk, 0), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk)
      hw::wgmma_rs<128, TB>(chunk, mid[kk], desc_b<TB, 128>(bs, kk, 0), 1);
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk)
      hw::wgmma_rs<128, TB>(chunk, hi[kk], desc_b<TB, 128>(bs, kk, 0), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::reg_fence<64>(chunk);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += chunk[i];
  }
};

// The consumers' main loop over ``stages`` ring stages.  ``active``: this
// warpgroup has rows to compute (else it only frees the stages).
// ``tail_rows`` (tgmm): rows of the last stage that belong to the group;
// the others are zeroed in both tiles before any product reads them.
// With bf16 A one stage's products stay in flight while the next stage's
// are issued; its accumulators are not touched until the last wait.
template <typename TA, bool KMAJOR_A, int TB, int BN>
__device__ __forceinline__ void consume(float* acc, unsigned char* base,
                                        uint64_t* full, uint64_t* empty,
                                        int stages, int wg, bool active,
                                        int tail_rows) {
  using C = WgCfg<TA, BN>;
  float chunk[C::kSplit ? 64 : 1];
  for (int i = 0; i < stages; ++i) {
    const int s = i % kStages;
    unsigned char* st = base + s * C::kStageBytes;
    hw::mbar_wait(&full[s], (i / kStages) & 1);
    if (i == stages - 1 && tail_rows < kWgBk) {
      // Zero depth rows [tail_rows, 64) of A ([64][128] as 128-byte panel
      // rows) and B: other groups' rows, which may hold Inf or NaN.
      constexpr int kAPanels = C::kABytes / (kWgBk * 128);
      constexpr int kPanels = kAPanels + BN / 64;
      const int n = (kWgBk - tail_rows) * kPanels * 8;
      for (int e = threadIdx.x; e < n; e += 256) {
        const int chunk16 = e & 7;
        const int panel = (e >> 3) % kPanels;
        const int row = tail_rows + (e >> 3) / kPanels;
        *reinterpret_cast<uint4*>(st + panel * kWgBk * 128 + row * 128 +
                                  chunk16 * 16) = make_uint4(0, 0, 0, 0);
      }
      hw::fence_proxy_async();
      hw::bar_sync(1, 256);
    }
    if (active) {
      Stage<TA, KMAJOR_A, TB, BN>::run(acc, chunk, st, wg, i == 0);
      if constexpr (!C::kSplit) {
        hw::wgmma_wait<1>();          // the previous stage's products are in
        if (i > 0) hw::mbar_arrive(&empty[(i - 1) % kStages]);
        continue;
      }
    }
    hw::mbar_arrive(&empty[s]);
  }
  if (!C::kSplit && active && stages > 0) {
    hw::wgmma_wait<0>();
    hw::mbar_arrive(&empty[(stages - 1) % kStages]);
  }
  hw::reg_fence<BN / 2>(acc);
}

// The epilogue: both warpgroups' [64, BN] accumulators into an f32 tile
// in shared memory (TRANS: transposed, for tgmm's out[g]^T), then its
// first ``rows`` x ``cols`` to ``out`` (row stride ``ld``) in TO, with
// 16-byte stores of whole rows' runs where ``vec`` (aligned rows).
template <bool TRANS, typename TO, int BN>
__device__ __forceinline__ void store_tile(const float* acc,
                                           unsigned char* base, TO* out,
                                           long long ld, int rows, int cols,
                                           bool vec, int wg) {
  // Pitches for conflict-free writes: float2 rows, or transposed scalars.
  constexpr int kLd = TRANS ? kWgBm + 4 : BN + 8;
  constexpr int kCols = TRANS ? kWgBm : BN;     // the tile's columns
  float* ep = reinterpret_cast<float*>(base);
  const int tid = threadIdx.x & 127;
  const int r0 = 64 * wg + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  hw::bar_sync(1, 256);               // every stage is consumed
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const int c = 8 * j + c0;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (TRANS) {
        ep[c * kLd + r] = v0;
        ep[(c + 1) * kLd + r] = v1;
      } else {
        *reinterpret_cast<float2*>(ep + r * kLd + c) = make_float2(v0, v1);
      }
    }
  }
  hw::bar_sync(1, 256);
  constexpr int V = 16 / static_cast<int>(sizeof(TO));
  constexpr int kChunks = kCols / V;
  constexpr int kRows = TRANS ? BN : kWgBm;
  for (int e = threadIdx.x; e < kRows * kChunks; e += 256) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * V;
    if (r >= rows || c >= cols) continue;
    const float* src = ep + r * kLd + c;
    TO* dst = out + r * ld + c;
    if (vec && c + V <= cols) {
      if constexpr (std::is_same<TO, float>::value) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        uint4 u;
        u.x = bits(__floats2bfloat162_rn(a.x, a.y));
        u.y = bits(__floats2bfloat162_rn(a.z, a.w));
        u.z = bits(__floats2bfloat162_rn(b.x, b.y));
        u.w = bits(__floats2bfloat162_rn(b.z, b.w));
        *reinterpret_cast<uint4*>(dst) = u;
      }
    } else {
      for (int j = 0; j < V && c + j < cols; ++j)
        dst[j] = ttd::from_f32<TO>(src[j]);
    }
  }
}

// Ring barriers: full[s] (the producer's expect_tx, completed by TMA) and
// empty[s] (every consumer thread), after the ring.
template <typename C>
__device__ __forceinline__ unsigned char* ring_setup(unsigned char* raw,
                                                     uint64_t*& full,
                                                     uint64_t*& empty) {
  unsigned char* base = raw + ((1024 - (hw::smem_addr(raw) & 1023)) & 1023);
  full = reinterpret_cast<uint64_t*>(base + C::kBars);
  empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 256);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  return base;
}

// gmm: block (column tile blockIdx.x, row tile blockIdx.y); a row strip's
// column tiles are neighbours in launch order, so its A strip is read
// from device memory once and from L2 after that.  lhs [m, k] (TA) and
// rhs [E, k, n] bf16 (TRANS_B: [E, n, k]) through the maps ``ta`` (boxes
// 64 bf16 or 32 f32 columns x 128 rows) and ``tb`` (rank 3; boxes 64 x
// 64, or 64 x BN when TRANS_B).
template <typename TA, typename TO, bool TRANS_B>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const int* sizes, TO* out, int m, int k, int n,
                     int groups, int vec) {
  constexpr int BN = gmm_bn<TA>();
  using C = WgCfg<TA, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int tile[3];               // group (groups: zero tail), row, rows
  if (threadIdx.x < 32)
    find_row_tile<kWgBm>(sizes, groups, m, blockIdx.y, tile);
  uint64_t *full, *empty;
  unsigned char* base = ring_setup<C>(smem_raw, full, empty);
  const int g = tile[0];
  if (g < 0) return;                    // a surplus block
  const int r0 = tile[1];
  const int rows = tile[2];
  const int j0 = blockIdx.x * BN;
  const int stages = g < groups ? (k + kWgBk - 1) / kWgBk : 0;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < stages; ++i) {
        const int s = i % kStages;
        hw::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], C::kStageBytes);
        unsigned char* st = base + s * C::kStageBytes;
        const int d0 = i * kWgBk;
        if constexpr (C::kSplit) {
          hw::tma_load_2d(st, &ta, &full[s], d0, r0);
          hw::tma_load_2d(st + kWgBm * 128, &ta, &full[s], d0 + 32, r0);
        } else {
          hw::tma_load_2d(st, &ta, &full[s], d0, r0);
        }
        unsigned char* bs = st + C::kABytes;
        if constexpr (TRANS_B) {
          hw::tma_load_3d(bs, &tb, &full[s], d0, j0, g);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            hw::tma_load_3d(bs + p * kWgBk * 128, &tb, &full[s], j0 + 64 * p,
                            d0, g);
        }
      }
    }
    return;
  }
  hw::regs_inc<232>();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  consume<TA, true, TRANS_B ? 0 : 1, BN>(acc, base, full, empty, stages, wg,
                                         64 * wg < rows, kWgBk);
  store_tile<false, TO, BN>(acc, base,
                            out + static_cast<long long>(r0) * n + j0, n,
                            rows, min(BN, n - j0), vec != 0, wg);
}

// tgmm: block (k tile blockIdx.x, n tile blockIdx.y, group blockIdx.z)
// computes out[g]^T [n tile, k tile] = cot^T . x over the group's rows,
// the cotangent rhs [m, n] (TA) as A read MN-major and lhs x [m, k] bf16
// as B (MN-major), both through rank-2 maps with 64-row boxes; the k
// tiles of one (n tile, group) are neighbours, so the cotangent strip is
// read from device memory once.  Writes out[g] [k, n] through a
// transposed tile.  An empty group writes zeros.
template <typename TA, typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
    tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const int* sizes, TO* out, int m, int k, int n,
                      int vec) {
  using C = WgCfg<TA, 128>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int span[2];               // the group's first row, rows
  const int g = blockIdx.z;
  if (threadIdx.x < 32) group_span(sizes, g, m, span);
  uint64_t *full, *empty;
  unsigned char* base = ring_setup<C>(smem_raw, full, empty);
  const int start = span[0];
  const int rows = span[1];
  const int i0 = blockIdx.x * 128;      // out rows (k)
  const int j0 = blockIdx.y * kWgBm;    // out columns (n): the products' rows
  const int stages = (rows + kWgBk - 1) / kWgBk;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      constexpr int kAPanels = C::kABytes / (kWgBk * 128);
      constexpr int kACols = kWgBm / kAPanels;
      for (int i = 0; i < stages; ++i) {
        const int s = i % kStages;
        hw::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], C::kStageBytes);
        unsigned char* st = base + s * C::kStageBytes;
        const int row = start + i * kWgBk;
#pragma unroll
        for (int p = 0; p < kAPanels; ++p)
          hw::tma_load_2d(st + p * kWgBk * 128, &ta, &full[s],
                          j0 + p * kACols, row);
        unsigned char* bs = st + C::kABytes;
        hw::tma_load_2d(bs, &tb, &full[s], i0, row);
        hw::tma_load_2d(bs + kWgBk * 128, &tb, &full[s], i0 + 64, row);
      }
    }
    return;
  }
  hw::regs_inc<232>();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  consume<TA, false, 1, 128>(acc, base, full, empty, stages, wg,
                             j0 + 64 * wg < n, rows - (stages - 1) * kWgBk);
  store_tile<true, TO, 128>(acc, base,
                            out + static_cast<long long>(g) * k * n +
                                static_cast<long long>(i0) * n + j0,
                            n, min(128, k - i0), min(kWgBm, n - j0),
                            vec != 0, wg);
}

template <typename TO>
bool vec_ok(const void* out, int ld) {
  return reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         (static_cast<long long>(ld) * sizeof(TO)) % 16 == 0;
}

template <typename TA, typename TO, bool TRANS_B>
int launch_gmm_wgmma(const void* lhs, const void* rhs, const void* sizes,
                     void* out, int m, int k, int n, int groups,
                     cudaStream_t stream) {
  constexpr int BN = gmm_bn<TA>();
  using C = WgCfg<TA, BN>;
  CUtensorMap ta, tb;
  const int da = C::kSplit ? ttd::kF32 : ttd::kBF16;
  if (!hw::make_map_rows(&ta, lhs, da, 0, m, k, C::kSplit ? 32 : 64, kWgBm) ||
      !hw::make_map_rows(&tb, rhs, ttd::kBF16, groups, TRANS_B ? n : k,
                         TRANS_B ? k : n, 64, TRANS_B ? BN : kWgBk))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gmm_wgmma_kernel<TA, TO, TRANS_B>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + kWgBm - 1) / kWgBm + groups + 1);
  kernel<<<grid, kWgThreads, C::kSmem, stream>>>(
      ta, tb, static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n,
      groups, vec_ok<TO>(out, n));
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TO>
int launch_tgmm_wgmma(const void* lhs, const void* rhs, const void* sizes,
                      void* out, int m, int k, int n, int groups,
                      cudaStream_t stream) {
  using C = WgCfg<TA, 128>;
  CUtensorMap ta, tb;
  const int da = C::kSplit ? ttd::kF32 : ttd::kBF16;
  if (!hw::make_map_rows(&ta, rhs, da, 0, m, n, C::kSplit ? 32 : 64, kWgBk) ||
      !hw::make_map_rows(&tb, lhs, ttd::kBF16, 0, m, k, 64, kWgBk))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tgmm_wgmma_kernel<TA, TO>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + 127) / 128, (n + kWgBm - 1) / kWgBm, groups);
  kernel<<<grid, kWgThreads, C::kSmem, stream>>>(
      ta, tb, static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n,
      vec_ok<TO>(out, n));
  return static_cast<int>(cudaGetLastError());
}

// -- the choice of body ----------------------------------------------------

enum Body : int { kFma = 0, kMmaSync = 1, kWgmma = 2 };

int dtype_bytes(int d) { return d == ttd::kF32 ? 4 : 2; }
bool float_type(int d) { return d == ttd::kF32 || d == ttd::kBF16; }

// gmm: "wgmma" for a bf16 rhs and a bf16 or f32 lhs whose rows TMA can
// load (16-byte aligned bases and rows: bf16 k and rhs rows multiples of
// 8, f32 k of 4); "mma.sync" for other bf16 x bf16; "FMA" otherwise.
int gmm_body(int k, int n, int transpose_rhs, int da, int db, int aligned) {
  if (!float_type(da) || !float_type(db)) return -1;
  if (db == ttd::kBF16 && aligned && k > 0 &&
      (static_cast<long long>(k) * dtype_bytes(da)) % 16 == 0 &&
      ((transpose_rhs ? k : n) * 2ll) % 16 == 0)
    return kWgmma;
  return da == ttd::kBF16 && db == ttd::kBF16 ? kMmaSync : kFma;
}

// tgmm (lhs x [m, k], rhs the cotangent [m, n]): "wgmma" for a bf16 lhs
// and a bf16 or f32 rhs with TMA-loadable rows, as gmm_body.
int tgmm_body(int m, int k, int n, int da, int db, int aligned) {
  if (!float_type(da) || !float_type(db)) return -1;
  if (da == ttd::kBF16 && aligned && m > 0 && (k * 2ll) % 16 == 0 &&
      (static_cast<long long>(n) * dtype_bytes(db)) % 16 == 0)
    return kWgmma;
  return da == ttd::kBF16 && db == ttd::kBF16 ? kMmaSync : kFma;
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
             16 == 0;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<TA>, Tag<TB>, Tag<TO>) for the element-type codes given.
template <typename F>
int with_types(int da, int db, int dout, F f) {
  auto by_out = [&](auto a, auto b) -> int {
    if (dout == ttd::kF32) return f(a, b, Tag<float>{});
    if (dout == ttd::kBF16) return f(a, b, Tag<bf16>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  auto by_rhs = [&](auto a) -> int {
    if (db == ttd::kF32) return by_out(a, Tag<float>{});
    if (db == ttd::kBF16) return by_out(a, Tag<bf16>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (da == ttd::kF32) return by_rhs(Tag<float>{});
  if (da == ttd::kBF16) return by_rhs(Tag<bf16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ttd_grouped

// The body ttd_gmm runs for these operands (a 16-byte ``aligned`` lhs
// and rhs): 2 "wgmma", 1 "mma.sync", 0 "FMA"; -1 for types it refuses.
extern "C" int ttd_gmm_body(int k, int n, int transpose_rhs, int lhs_dtype,
                            int rhs_dtype, int aligned) {
  return ttd_grouped::gmm_body(k, n, transpose_rhs, lhs_dtype, rhs_dtype,
                               aligned);
}

// The body ttd_tgmm runs, as ttd_gmm_body.
extern "C" int ttd_tgmm_body(int m, int k, int n, int lhs_dtype,
                             int rhs_dtype, int aligned) {
  return ttd_grouped::tgmm_body(m, k, n, lhs_dtype, rhs_dtype, aligned);
}

// ttd_gmm with the body given (to time the bodies side by side):
// ttd_gmm_body's choice, "mma.sync" for bf16 x bf16, or "FMA".
extern "C" int ttd_gmm_as(const void* lhs, const void* rhs,
                          const void* group_sizes, void* out, int m, int k,
                          int n, int groups, int transpose_rhs, int lhs_dtype,
                          int rhs_dtype, int out_dtype, int body,
                          void* stream) {
  using namespace ttd_grouped;
  if (m <= 0 || n <= 0) return 0;
  const int chosen = gmm_body(k, n, transpose_rhs, lhs_dtype, rhs_dtype,
                              aligned16(lhs, rhs));
  const bool bf16s = lhs_dtype == ttd::kBF16 && rhs_dtype == ttd::kBF16;
  if (k < 0 || groups < 0 || chosen < 0 ||
      !(body == chosen || body == kFma || (body == kMmaSync && bf16s)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(
      lhs_dtype, rhs_dtype, out_dtype, [&](auto a, auto b, auto o) -> int {
        using TA = typename decltype(a)::type;
        using TB = typename decltype(b)::type;
        using TO = typename decltype(o)::type;
        if constexpr (std::is_same<TB, bf16>::value) {
          if (body == kWgmma)
            return transpose_rhs
                       ? launch_gmm_wgmma<TA, TO, true>(
                             lhs, rhs, group_sizes, out, m, k, n, groups, st)
                       : launch_gmm_wgmma<TA, TO, false>(
                             lhs, rhs, group_sizes, out, m, k, n, groups, st);
          if constexpr (std::is_same<TA, bf16>::value) {
            if (body == kMmaSync)
              return launch_gmm<TA, TB, TO, true>(lhs, rhs, group_sizes, out,
                                                  m, k, n, groups,
                                                  transpose_rhs, st);
          }
        }
        return launch_gmm<TA, TB, TO, false>(lhs, rhs, group_sizes, out, m,
                                             k, n, groups, transpose_rhs, st);
      });
}

// ttd_tgmm with the body given, as ttd_gmm_as.
extern "C" int ttd_tgmm_as(const void* lhs, const void* rhs,
                           const void* group_sizes, void* out, int m, int k,
                           int n, int groups, int lhs_dtype, int rhs_dtype,
                           int out_dtype, int body, void* stream) {
  using namespace ttd_grouped;
  if (k <= 0 || n <= 0 || groups <= 0) return 0;
  const int chosen = tgmm_body(m, k, n, lhs_dtype, rhs_dtype,
                               aligned16(lhs, rhs));
  const bool bf16s = lhs_dtype == ttd::kBF16 && rhs_dtype == ttd::kBF16;
  if (m < 0 || chosen < 0 ||
      !(body == chosen || body == kFma || (body == kMmaSync && bf16s)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(
      lhs_dtype, rhs_dtype, out_dtype, [&](auto a, auto b, auto o) -> int {
        using TA = typename decltype(a)::type;
        using TB = typename decltype(b)::type;
        using TO = typename decltype(o)::type;
        if constexpr (std::is_same<TA, bf16>::value) {
          if (body == kWgmma)
            return launch_tgmm_wgmma<TB, TO>(lhs, rhs, group_sizes, out, m,
                                             k, n, groups, st);
          if constexpr (std::is_same<TB, bf16>::value) {
            if (body == kMmaSync)
              return launch_tgmm<TA, TB, TO, true>(lhs, rhs, group_sizes, out,
                                                   m, k, n, groups, st);
          }
        }
        return launch_tgmm<TA, TB, TO, false>(lhs, rhs, group_sizes, out, m,
                                              k, n, groups, st);
      });
}

// lhs [m, k]; rhs [groups, k, n] (or [groups, n, k] when transpose_rhs);
// group_sizes [groups] int32 on the device; out [m, n].  All contiguous.
// Element types by code (ttd::DType): lhs and rhs f32 or bf16, out f32
// or bf16.  The body is ttd_gmm_body's.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int ttd_gmm(const void* lhs, const void* rhs,
                       const void* group_sizes, void* out, int m, int k,
                       int n, int groups, int transpose_rhs, int lhs_dtype,
                       int rhs_dtype, int out_dtype, void* stream) {
  const int body = ttd_grouped::gmm_body(k, n, transpose_rhs, lhs_dtype,
                                         rhs_dtype,
                                         ttd_grouped::aligned16(lhs, rhs));
  return ttd_gmm_as(lhs, rhs, group_sizes, out, m, k, n, groups,
                    transpose_rhs, lhs_dtype, rhs_dtype, out_dtype, body,
                    stream);
}

// lhs [m, k] (read as its transpose, [k, m]); rhs [m, n]; group_sizes
// [groups] int32 on the device; out [groups, k, n].  All contiguous.
// Element types as ttd_gmm; the body is ttd_tgmm_body's.  Returns the
// CUDA error code of the launch.
extern "C" int ttd_tgmm(const void* lhs, const void* rhs,
                        const void* group_sizes, void* out, int m, int k,
                        int n, int groups, int lhs_dtype, int rhs_dtype,
                        int out_dtype, void* stream) {
  const int body = ttd_grouped::tgmm_body(m, k, n, lhs_dtype, rhs_dtype,
                                          ttd_grouped::aligned16(lhs, rhs));
  return ttd_tgmm_as(lhs, rhs, group_sizes, out, m, k, n, groups, lhs_dtype,
                     rhs_dtype, out_dtype, body, stream);
}
