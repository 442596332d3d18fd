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
// Bound on this card: operations at the MoE shapes (moe_370m: m 16384,
//   k 768, n 2048 is 51.5 GFLOP against ~0.2 GB moved): 989 TFLOP/s for
//   bf16 x bf16, 67 TFLOP/s for the f32 products of the backward.
//
// Design: the group sizes stay on the device.  A gmm block finds its
//   (group, row range) itself: thread 0 walks the sizes (E <= a few
//   hundred), counting each group's 64-row tiles from the group's own
//   first row, so a tile never straddles two groups and stores need a
//   mask only at a group's tail.  The grid launches the upper bound
//   ceil(m / 64) + E + 1 tiles (the extra "group" is the zero tail past
//   the sizes' sum) and the surplus blocks return.  A tgmm block owns one
//   (k tile, n tile, group) and loops over the group's rows, reading lhs
//   [m, k] in place (megablox's lhs.swapaxes(0, 1) is never built).  Both
//   compute a 64 x 128 output tile from 32-deep slices of the two
//   operands staged in shared memory: bf16 x bf16 with mma.sync m16n8k16
//   (each warp a 16-row strip, f32 accumulators in registers), f32 with
//   FMAs (an 8 x 8 register tile a thread).  Slices are staged with
//   16-byte loads where the operands' alignment allows, their layout
//   turned in registers where the shared tile wants the other axis
//   contiguous.  Simple first: one slice in flight, no cp.async/TMA
//   pipelining, no wgmma.
#include <type_traits>

#include "flash_common.cuh"

namespace ttd_grouped {
namespace {

using bf16 = __nv_bfloat16;
using ttd_flash::ld32;
using ttd_flash::mma16816;

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

template <typename TA, typename TB>
using CoreFor = Core<std::is_same<TA, bf16>::value &&
                     std::is_same<TB, bf16>::value>;

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const TA* lhs, const TB* rhs, const int* sizes, TO* out, int m,
               int k, int n, int groups, int transpose_rhs) {
  __shared__ int tile[3];               // group (groups: zero tail), row, rows
  __shared__ __align__(16) unsigned char smem[kSmem];
  if (threadIdx.x == 0) {
    int t = blockIdx.x, start = 0;
    tile[0] = -1;
    for (int e = 0; e <= groups; ++e) {
      int size = e < groups ? max(sizes[e], 0) : m - start;
      size = min(size, m - start);
      const int tiles = (size + kTm - 1) / kTm;
      if (t < tiles) {
        tile[0] = e;
        tile[1] = start + t * kTm;
        tile[2] = min(kTm, size - t * kTm);
        break;
      }
      t -= tiles;
      start += size;
    }
  }
  __syncthreads();
  const int g = tile[0];
  if (g < 0) return;                    // a surplus block
  const int r0 = tile[1];
  const int rows = tile[2];
  const int j0 = blockIdx.y * kTn;
  const int nj = min(kTn, n - j0);
  CoreFor<TA, TB> core;
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

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const TA* lhs, const TB* rhs, const int* sizes, TO* out, int m,
                int k, int n) {
  __shared__ int span[2];               // the group's first row, rows
  __shared__ __align__(16) unsigned char smem[kSmem];
  const int g = blockIdx.z;
  if (threadIdx.x == 0) {
    int start = 0;
    for (int e = 0; e < g; ++e) start += min(max(sizes[e], 0), m - start);
    span[0] = start;
    span[1] = min(max(sizes[g], 0), m - start);
  }
  __syncthreads();
  const int start = span[0];
  const int i0 = blockIdx.x * kTm;
  const int j0 = blockIdx.y * kTn;
  const int ni = min(kTm, k - i0);
  const int nj = min(kTn, n - j0);
  CoreFor<TA, TB> core;
  core.zero();
  const Operand<TA> a{lhs + static_cast<long long>(start) * k + i0, 1, k, ni};
  const Operand<TB> b{rhs + static_cast<long long>(start) * n + j0, 1, n, nj};
  core.run(a, b, span[1], smem);
  core.store(out + static_cast<long long>(g) * k * n +
                 static_cast<long long>(i0) * n + j0,
             n, ni, nj);
}

template <typename TA, typename TB, typename TO>
int launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out,
               int m, int k, int n, int groups, int transpose_rhs,
               cudaStream_t stream) {
  const dim3 grid((m + kTm - 1) / kTm + groups + 1, (n + kTn - 1) / kTn);
  gmm_kernel<TA, TB, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs),
      static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n, groups,
      transpose_rhs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB, typename TO>
int launch_tgmm(const void* lhs, const void* rhs, const void* sizes,
                void* out, int m, int k, int n, int groups,
                cudaStream_t stream) {
  const dim3 grid((k + kTm - 1) / kTm, (n + kTn - 1) / kTn, groups);
  tgmm_kernel<TA, TB, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs),
      static_cast<const int*>(sizes), static_cast<TO*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
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

// lhs [m, k]; rhs [groups, k, n] (or [groups, n, k] when transpose_rhs);
// group_sizes [groups] int32 on the device; out [m, n].  All contiguous.
// Element types by code (ttd::DType): lhs and rhs f32 or bf16, out f32
// or bf16.  Returns the CUDA error code of the launch (0 on success).
extern "C" int ttd_gmm(const void* lhs, const void* rhs,
                       const void* group_sizes, void* out, int m, int k,
                       int n, int groups, int transpose_rhs, int lhs_dtype,
                       int rhs_dtype, int out_dtype, void* stream) {
  using namespace ttd_grouped;
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(lhs_dtype, rhs_dtype, out_dtype,
                    [&](auto a, auto b, auto o) -> int {
                      return launch_gmm<typename decltype(a)::type,
                                        typename decltype(b)::type,
                                        typename decltype(o)::type>(
                          lhs, rhs, group_sizes, out, m, k, n, groups,
                          transpose_rhs, st);
                    });
}

// lhs [m, k] (read as its transpose, [k, m]); rhs [m, n]; group_sizes
// [groups] int32 on the device; out [groups, k, n].  All contiguous.
// Element types as ttd_gmm.  Returns the CUDA error code of the launch.
extern "C" int ttd_tgmm(const void* lhs, const void* rhs,
                        const void* group_sizes, void* out, int m, int k,
                        int n, int groups, int lhs_dtype, int rhs_dtype,
                        int out_dtype, void* stream) {
  using namespace ttd_grouped;
  if (k <= 0 || n <= 0 || groups <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(lhs_dtype, rhs_dtype, out_dtype,
                    [&](auto a, auto b, auto o) -> int {
                      return launch_tgmm<typename decltype(a)::type,
                                         typename decltype(b)::type,
                                         typename decltype(o)::type>(
                          lhs, rhs, group_sizes, out, m, k, n, groups, st);
                    });
}
