// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the argument block, the choice of body, the
// sliding-window band of the splash kernels (K7), which run the same
// bodies instantiated with BAND = true, and for each body its tiles:
// the wgmma bodies' masks, register fragments and epilogue (below, on
// hopper.cuh's TMA ring and wgmma), the split body's bf16 terms of f32
// tiles and its products (at the end), and the mma.sync / FMA bodies' tile
// loads and two warp-level tile products with one register layout for
// both element types (f32 and bf16 at D 256).
//
// Layout of a warp's [16, 8*NT] f32 tile in registers (the accumulator
// layout of mma.sync m16n8k16): lane = 4*g + t holds, for each n-tile n,
//   c[n][0], c[n][1] at row g,     columns 8n + 2t, 8n + 2t + 1
//   c[n][2], c[n][3] at row g + 8, the same columns.
// bf16 tiles run on the tensor cores (mma.sync, f32 accumulation); f32
// tiles run the same products with FMAs in that layout, so every kernel
// body is written once.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace ttd_flash {

using bf16 = __nv_bfloat16;

// The library kernel's mask value (flash_attention.py DEFAULT_MASK_VALUE):
// added, not substituted, to a masked score.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// Element strides of a [B, H, S, D] operand; D is contiguous.
struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;      // forward: o; backward: unused
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // [B, H, S] f32 row logsumexp (written fwd, read bwd)
  float* di;      // [B, H, S] f32 rowsum(dO * O) (backward scratch)
  const int* seg; // [B, S] int32 segment ids, or null
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, seq;
  float scale;
  int causal;
  int window;     // K7 (BAND): keys q - window < k <= q, plus
  int sinks;      // the first ``sinks`` keys; 1 <= window <= seq
};

// Copies BT rows of D elements (row stride ``stride`` elements) from
// global memory into a shared tile of row pitch D + 16 bytes, with
// 16-byte loads.  The wrapper guarantees 16-byte aligned rows.
template <typename T, int D, int BT, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride) {
  constexpr int kEpv = 16 / sizeof(T);
  constexpr int kVpr = D / kEpv;
  constexpr int kLd = D + kEpv;
  for (int i = threadIdx.x; i < BT * kVpr; i += NTHREADS) {
    const int r = i / kVpr;
    const int c = (i - r * kVpr) * kEpv;
    *reinterpret_cast<uint4*>(dst + r * kLd + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Tile;

// bf16: tensor cores.
template <>
struct Tile<bf16> {
  // c[16, 8*NT] = A[16, D] . B[8*NT, D]^T; A and B row-major in shared
  // memory with row pitch LD, products accumulated in f32.
  template <int D, int NT, int LD>
  static __device__ __forceinline__ void abt(const bf16* a, const bf16* b,
                                             float (*c)[4], float*) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t af[4];
      af[0] = ld32(a + g * LD + kk + 2 * t);
      af[1] = ld32(a + (g + 8) * LD + kk + 2 * t);
      af[2] = ld32(a + g * LD + kk + 8 + 2 * t);
      af[3] = ld32(a + (g + 8) * LD + kk + 8 + 2 * t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bfr[2];
        bfr[0] = ld32(b + (n * 8 + g) * LD + kk + 2 * t);
        bfr[1] = ld32(b + (n * 8 + g) * LD + kk + 8 + 2 * t);
        mma16816(c[n], af, bfr);
      }
    }
  }

  // acc[16, D] += P[16, 8*NT] . B[8*NT, D]; P is a register tile (rounded
  // to bf16 here, as the library casts p to v's dtype), B row-major in
  // shared memory with row pitch LD.
  template <int D, int NT, int LD>
  static __device__ __forceinline__ void pb(const float (*p)[4],
                                            const bf16* b, float (*acc)[4],
                                            float*) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t af[4];
      af[0] = pack_f32(p[2 * j][0], p[2 * j][1]);
      af[1] = pack_f32(p[2 * j][2], p[2 * j][3]);
      af[2] = pack_f32(p[2 * j + 1][0], p[2 * j + 1][1]);
      af[3] = pack_f32(p[2 * j + 1][2], p[2 * j + 1][3]);
      const bf16* r0 = b + (16 * j + 2 * t) * LD;
      const bf16* r8 = b + (16 * j + 8 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        uint32_t bfr[2];
        bfr[0] = pack_raw(r0[col], r0[LD + col]);
        bfr[1] = pack_raw(r8[col], r8[LD + col]);
        mma16816(acc[n], af, bfr);
      }
    }
  }
};

// f32: the same products with FMAs in the same register layout.  ``pb``
// stages P through a per-warp shared scratch of 16 x (8*NT + 4) floats.
template <>
struct Tile<float> {
  template <int D, int NT, int LD>
  static __device__ __forceinline__ void abt(const float* a, const float* b,
                                             float (*c)[4], float*) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float a0 = a[g * LD + k];
      const float a1 = a[(g + 8) * LD + k];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = b[(n * 8 + 2 * t) * LD + k];
        const float b1 = b[(n * 8 + 2 * t + 1) * LD + k];
        c[n][0] += a0 * b0;
        c[n][1] += a0 * b1;
        c[n][2] += a1 * b0;
        c[n][3] += a1 * b1;
      }
    }
  }

  template <int D, int NT, int LD>
  static __device__ __forceinline__ void pb(const float (*p)[4],
                                            const float* b, float (*acc)[4],
                                            float* scratch) {
    constexpr int kPl = NT * 8 + 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      scratch[g * kPl + n * 8 + 2 * t] = p[n][0];
      scratch[g * kPl + n * 8 + 2 * t + 1] = p[n][1];
      scratch[(g + 8) * kPl + n * 8 + 2 * t] = p[n][2];
      scratch[(g + 8) * kPl + n * 8 + 2 * t + 1] = p[n][3];
    }
    __syncwarp();
#pragma unroll 2
    for (int k = 0; k < NT * 8; ++k) {
      const float p0 = scratch[g * kPl + k];
      const float p1 = scratch[(g + 8) * kPl + k];
      const float* row = b + k * LD;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float b0 = row[n * 8 + 2 * t];
        const float b1 = row[n * 8 + 2 * t + 1];
        acc[n][0] += p0 * b0;
        acc[n][1] += p0 * b1;
        acc[n][2] += p1 * b0;
        acc[n][3] += p1 * b1;
      }
    }
    __syncwarp();
  }
};

// Tile rows: 64 for bf16 (four warps of 16 rows), 32 for f32 (two warps),
// so that four tiles of head_dim 256 fit the 227 KB of shared memory.
template <typename T>
struct Cfg {
  static constexpr int kBt = sizeof(T) == 2 ? 64 : 32;
  static constexpr int kThreads = kBt * 2;
  static constexpr int kNt = kBt / 8;
};

template <typename T, int D>
__host__ __device__ constexpr int tile_pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Shared bytes of ``tiles`` tiles plus 4 int/float vectors of BT and, for
// f32, the per-warp P scratch.
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int tiles) {
  return tiles * Cfg<T>::kBt * tile_pitch<T, D>() * static_cast<int>(sizeof(T)) +
         4 * Cfg<T>::kBt * 4 +
         (sizeof(T) == 4 ? (Cfg<T>::kBt / 16) * 16 * (Cfg<T>::kNt * 8 + 4) * 4
                         : 0);
}

// Whether key ``col`` is visible to query ``row`` (absolute positions;
// ``sq``/``sk`` their segment ids when ``seg``).  With BAND (K7, always
// causal) a key also has to lie in the window or among the sinks.
template <bool BAND>
__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int window, int sinks, bool seg,
                                        int sq, int sk) {
  return (!causal || col <= row) &&
         (!BAND || row - col < window || col < sinks) && (!seg || sq == sk);
}

// The kv tiles a q tile starting at ``q0`` visits under BAND: the sink
// tiles [0, sink_end), then [lo, its diagonal].  Tiles wholly left of the
// band are skipped, as splash skips the blocks its mask empties.  K2
// (BAND = false) starts at 0 and steps by one.
template <bool BAND, int BT>
struct KvTiles {
  int lo = 0;
  int sink_end = 0;
  __device__ __forceinline__ KvTiles(int window, int sinks, int q0) {
    if (BAND) {
      lo = max(0, q0 - window + 1) / BT;
      sink_end = min((sinks + BT - 1) / BT, lo);
    }
  }
  __device__ __forceinline__ int first() const {
    return BAND && sink_end > 0 ? 0 : lo;
  }
  __device__ __forceinline__ int next(int kt) const {
    return BAND && kt + 1 == sink_end ? lo : kt + 1;
  }
};

// One past the last q tile whose rows see a key of the kv tile starting
// at ``k0``: under BAND, the last row the window reaches from the tile's
// last key, or every tile for a tile holding a sink.
template <bool BAND, int BT>
__device__ __forceinline__ int q_tiles_end(int window, int sinks, int k0,
                                           int n_tiles) {
  if (!BAND || k0 < sinks) return n_tiles;
  return min(n_tiles, (k0 + BT + window - 2) / BT + 1);
}

// -- the wgmma bodies (bf16, head_dim 64 and 128) ----------------------------
//
// A consumer warpgroup owns 64 rows of the products; its [64, N] f32
// accumulators follow the wgmma layout: thread 32 w + 4 g + t (warp w,
// lane 4 g + t) holds, for each n-tile j of 8 columns,
//   d[4j], d[4j + 1] at row 16 w + g,     columns 8j + 2t, 8j + 2t + 1
//   d[4j + 2], d[4j + 3] at row 16 w + g + 8, the same columns,
// the register layout of the mma.sync bodies above, four warps deep.

// The body that serves (head_dim, dtype), chosen statically and the same
// for the forward and the backward: kWgmma for bf16 at D 64 and 128;
// kSplit for f32 at D 64 and 128 (the wgmma bodies on exact bf16 terms of
// the f32 operands, below: wgmma's tf32 would keep 10 bits of each, and
// takes a transposed operand only for 16-bit types); kMmaSync for bf16 at
// D 256 and kFma for f32 at D 256 (a [64, 256] f32 accumulator would not
// fit a warpgroup's registers beside the scores); kNone where the pair is
// refused.  ``chosen`` resolves a caller's request: -1 takes body(), and
// kFma may stand in for kSplit (to time the two side by side).
enum Body : int { kNone = -1, kFma = 0, kMmaSync = 1, kWgmma = 2, kSplit = 3 };

inline Body body(int head_dim, int dtype) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return kNone;
  if (dtype == ttd::kF32) return head_dim == 256 ? kFma : kSplit;
  if (dtype == ttd::kBF16) return head_dim == 256 ? kMmaSync : kWgmma;
  return kNone;
}

inline Body chosen(int head_dim, int dtype, int request) {
  const Body b = body(head_dim, dtype);
  if (request < 0 || request == b) return b;
  return request == kFma && b == kSplit ? kFma : kNone;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Whether a tile of rows [r0, r1] x columns [c0, c1] (absolute positions,
// c1 possibly past S) may hold a pair that is not visible: only such
// tiles are masked element by element.  Conservative: a tile it flags may
// turn out wholly visible.  (Rows past S are never stored.)
template <bool BAND>
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int r1,
                                            int c0, int c1) {
  return p.seg != nullptr || c1 >= p.seq || (p.causal && c1 > r0) ||
         (BAND && r1 - c0 >= p.window && c1 >= p.sinks);
}

// Whether no pair of the tile is visible (it is skipped: its
// probabilities would all be exactly 0).
template <bool BAND>
__device__ __forceinline__ bool tile_empty(const Params& p, int r0, int r1,
                                           int c0, int c1) {
  return r0 >= p.seq || c0 >= p.seq || (p.causal && c0 > r1) ||
         (BAND && r0 - c1 >= p.window && c0 >= p.sinks);
}

// The A operand of depth step ``kk`` (16 columns) from a [64, N] f32
// accumulator: its columns 16 kk .. 16 kk + 15 rounded to bf16, in
// wgmma's register-A layout (that of mma.sync m16n8k16).
__device__ __forceinline__ void frag_a(const float* s, int kk, uint32_t* a) {
  a[0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
}

// Rounds a warpgroup's [64, D] f32 accumulator (rows of thread-row half 0
// scaled by ``f0``, half 1 by ``f1``) to bf16 and writes rows [row0,
// row0 + 64) of a strided output: first into the warpgroup's own rows of
// a swizzled tile in shared memory (``stage``: those rows of panel 0;
// ``panel_elems``: elements between panels), then with 16-byte stores.
// Rows at or past ``seq`` are not written.  ``wg`` names the warpgroup's
// barrier (1 + wg).
template <int D>
__device__ __forceinline__ void store_rows(const float* acc, float f0,
                                           float f1, bf16* stage,
                                           int panel_elems, bf16* out,
                                           long long row_stride, int row0,
                                           int seq, int wg) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  unsigned char* st = reinterpret_cast<unsigned char*>(stage);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      const float f = half ? f1 : f0;
      *reinterpret_cast<uint32_t*>(
          st + (j / 8) * panel_elems * 2 + r * 128 +
          (((j % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack_f32(acc[4 * j + 2 * half] * f, acc[4 * j + 2 * half + 1] * f);
    }
  }
  ttd_hopper::bar_sync(1 + wg, 128);
  constexpr int kRowChunks = D / 8;
  for (int c = tid; c < 64 * kRowChunks; c += 128) {
    const int r = c / kRowChunks;
    const int c8 = c % kRowChunks;
    if (row0 + r >= seq) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        st + (c8 / 8) * panel_elems * 2 + r * 128 + (((c8 % 8) ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row0 + r) *
                                        row_stride + c8 * 8) = v;
  }
}

// -- the split body (f32, head_dim 64 and 128) ---------------------------
//
// Each f32 value x is the sum hi + mid + lo of bf16 terms: hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), both differences exact in
// f32, |mid| <= 2^-9 |x| and |lo| <= 2^-18 |x|; the three carry all 24
// bits of x's significand.  A product a.b of two f32 operands runs as six
// bf16 products on wgmma with f32 accumulation, the small ones first:
// lo(a).hi(b) + mid(a).mid(b) + hi(a).lo(b) + mid(a).hi(b) + hi(a).mid(b)
// + hi(a).hi(b).  What it drops, mid.lo + lo.mid + lo.lo, is 2^-27 |a||b|
// and less, below f32's own rounding, so the body is held to the same
// bounds as the FMA body.  tests/test_torch_flash_split.py emulates the
// body's arithmetic on the CPU: six products stay within 0.08 of those
// bounds and 0.011 of the rule 2^-14 (|ref32| + |terms|) + 1e-6; three
// (hi and mid alone) reach 0.6 of the bounds in exact arithmetic, which
// the tensor core's truncated sums took past them on the card; one
// (bf16) misses the rule.
//
// A split tile of R rows and D columns sits in shared memory as D / 64
// groups of three bf16 panels of hopper.cuh's layout (R rows of 128
// bytes, 128-byte swizzle): group j holds the hi, mid and lo terms of
// columns [64 j, 64 j + 64), R * D * 6 bytes in all.  TMA lands the f32
// tile's two 32-column panels of group j where its hi and mid panels go
// (``tma_load_split``), and ``split_rows`` turns them in place into the
// group's three planes; wgmma reads each plane through PR 5's descriptors
// with a panel stride of three panels.

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The exact three-way split of two f32 values into bf16x2 terms (x0 in
// the low half): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), each rounded to nearest, as ops/kernels.py's ``bf16_split3``.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h);
  const float r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// Bytes of a split tile of R rows and D columns.
template <int R, int D>
__host__ __device__ constexpr int split_bytes() {
  return R * D * 6;
}

// Rows [row0, row0 + R) of head ``h``, batch row ``b`` of an f32 map from
// hopper.cuh's ``make_map`` into split tile ``tile`` (R a multiple of 64):
// f32 panel p (columns [32 p, 32 p + 32)) lands on panel 3 (p / 2) + p % 2.
// Adds R * D * 4 bytes to ``bar``'s transaction count.
template <int R, int D>
__device__ __forceinline__ void tma_load_split(unsigned char* tile,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int row0,
                                               int h, int b) {
#pragma unroll
  for (int panel = 0; panel < D / 32; ++panel)
#pragma unroll
    for (int c = 0; c < R / 64; ++c)
      ttd_hopper::tma_load_4d(
          tile + ((3 * (panel / 2) + panel % 2) * R + c * 64) * 128, map,
          bar, panel * 32, row0 + c * 64, h, b);
}

// Splits rows [row0, row0 + n) (n a multiple of 8) of a split tile whose
// f32 panels have landed into their hi, mid and lo planes, by thread
// ``tid`` of ``nthreads`` (a multiple of 32).  Eight lanes of a warp own a
// row's 64 columns of a group, read all of them, meet at __syncwarp, then
// write the row's hi and mid terms back over the same bytes and its lo
// terms into the group's third panel.  Ends with the fence that orders
// these writes before the async proxy (wgmma, a later TMA load into the
// tile): the caller's barrier then publishes them.
template <int R, int D>
__device__ __forceinline__ void split_rows(unsigned char* tile, int row0,
                                           int n, int tid, int nthreads) {
  const int items = n * (D / 64) * 8;
  for (int i = tid; i < items; i += nthreads) {
    const int c = i & 7;                   // 16-byte bf16 chunk of the row
    const int j = (i >> 3) % (D / 64);     // 64-column group
    const int r = row0 + (i >> 3) / (D / 64);
    const int sw = r & 7;
    unsigned char* row = tile + 3 * j * R * 128 + r * 128;
    const unsigned char* src = row + (c >> 2) * R * 128;
    const float4 a = *reinterpret_cast<const float4*>(
        src + (((2 * (c & 3)) ^ sw) << 4));
    const float4 b = *reinterpret_cast<const float4*>(
        src + (((2 * (c & 3) + 1) ^ sw) << 4));
    uint4 hi, mid, lo;
    split3(a.x, a.y, hi.x, mid.x, lo.x);
    split3(a.z, a.w, hi.y, mid.y, lo.y);
    split3(b.x, b.y, hi.z, mid.z, lo.z);
    split3(b.z, b.w, hi.w, mid.w, lo.w);
    __syncwarp();
    const int at = (c ^ sw) << 4;
    *reinterpret_cast<uint4*>(row + at) = hi;
    *reinterpret_cast<uint4*>(row + R * 128 + at) = mid;
    *reinterpret_cast<uint4*>(row + 2 * R * 128 + at) = lo;
  }
  ttd_hopper::fence_proxy_async();
}

// Depth step ``kk`` (16 columns) of rows [row0, row0 + 64) of plane
// ``pl`` (0 hi, 1 mid, 2 lo) of a split R-row tile, read K-major.
template <int R>
__device__ __forceinline__ uint64_t desc_k_split(const unsigned char* tile,
                                                 int pl, int row0, int kk) {
  return ttd_hopper::sw128_desc(
      tile + ((kk / 4) * 3 + pl) * R * 128 + row0 * 128 + (kk % 4) * 32, 16,
      1024);
}

// Depth step ``kk`` (16 rows) of plane ``pl`` of a split R-row tile, read
// MN-major for output columns [64 h, 64 h + 64).
template <int R>
__device__ __forceinline__ uint64_t desc_mn_split(const unsigned char* tile,
                                                  int pl, int kk, int h) {
  return ttd_hopper::sw128_desc(tile + (3 * h + pl) * R * 128 + kk * 2048,
                                3 * R * 128, 1024);
}

// frag_a's register-A operand of depth step ``kk``, split into its hi,
// mid and lo terms.
__device__ __forceinline__ void frag_split(const float* s, int kk,
                                           uint32_t* hi, uint32_t* mid,
                                           uint32_t* lo) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split3(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], hi[q], mid[q], lo[q]);
}

// The split terms of a register-A operand of K depth steps.
template <int K>
struct SplitFrags {
  uint32_t t[3][K][4];   // [hi, mid, lo][depth step][register]
};

template <int K>
__device__ __forceinline__ void split_frags(const float* s,
                                            SplitFrags<K>& f) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    frag_split(s, kk, f.t[0][kk], f.t[1][kk], f.t[2][kk]);
}

// Keeps register-A fragments live until the products that read them have
// completed (after the wgmma wait).
template <int K>
__device__ __forceinline__ void frag_fence(SplitFrags<K>& f) {
#pragma unroll
  for (int pl = 0; pl < 3; ++pl)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      asm volatile("" : "+r"(f.t[pl][kk][0]), "+r"(f.t[pl][kk][1]),
                   "+r"(f.t[pl][kk][2]), "+r"(f.t[pl][kk][3]) :: "memory");
}

// Product x of the six, as (plane of a, plane of b): (lo, hi), (mid, mid),
// (hi, lo), (mid, hi), (hi, mid), (hi, hi), small ones first: the tensor
// core truncates its running sum, so the large terms arrive last.
__host__ __device__ constexpr int split_a(int x) {
  return x == 0 ? 2 : x == 1 || x == 3 ? 1 : 0;
}
__host__ __device__ constexpr int split_b(int x) {
  return x == 2 ? 2 : x == 1 || x == 4 ? 1 : 0;
}

// The split products of [64, N] (+)= A . B over DEPTH / 16 depth steps,
// issued (not committed), both operands in shared memory: ``da(pl, kk)``
// and ``db(pl, kk)`` give plane pl's descriptor at depth step kk.
// ``accumulate`` = 0 overwrites d.
template <int N, int DEPTH, typename DA, typename DB>
__device__ __forceinline__ void wgmma_ss_split(float* d, DA da, DB db,
                                               int accumulate) {
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int kk = 0; kk < DEPTH / 16; ++kk)
      ttd_hopper::wgmma_ss<N>(d, da(split_a(x), kk), db(split_b(x), kk),
                              accumulate || x > 0 || kk > 0);
}

// acc[64, N] += A . B over K depth steps as split products, A in registers
// (``a``, its split fragments), B MN-major in shared memory (``db(pl, kk,
// h)``: plane pl's descriptor at depth step kk for output columns [64 h,
// 64 h + 64)); waits for them.  The tensor core truncates its running f32
// sum, so an accumulator fed tile after tile over a long sequence would
// drift toward zero by up to an ulp of itself a step (dK of a 4096-key
// window over four heads: ~3,000 steps).  So each 64-column part of the
// tile's products goes into a fresh [64, 64] ``chunk`` (32 registers,
// this tile's depth only) that is then added to acc with rounded f32 adds,
// as K6 adds its stages.
template <int N, int K, typename DB>
__device__ __forceinline__ void wgmma_rs_split_add(float* acc, float* chunk,
                                                   SplitFrags<K>& a, DB db) {
#pragma unroll
  for (int h = 0; h < N / 64; ++h) {
    ttd_hopper::wgmma_fence();
#pragma unroll
    for (int x = 0; x < 6; ++x)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        ttd_hopper::wgmma_rs<64>(chunk, a.t[split_a(x)][kk],
                                 db(split_b(x), kk, h), x > 0 || kk > 0);
    ttd_hopper::wgmma_commit();
    ttd_hopper::wgmma_wait<0>();
    ttd_hopper::reg_fence<32>(chunk);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * h + i] += chunk[i];
  }
}

// Writes a warpgroup's [64, D] f32 accumulator (rows of thread-row half 0
// scaled by ``f0``, half 1 by ``f1``) to rows [row0, row0 + 64) of a
// strided f32 output with 8-byte stores (four lanes fill a 32-byte
// sector).  Rows at or past ``seq`` are not written.
template <int D>
__device__ __forceinline__ void store_rows_f32(const float* acc, float f0,
                                               float f1, float* out,
                                               long long row_stride,
                                               int row0, int seq) {
  const int tid = threadIdx.x & 127;
  const int r = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int t = tid & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= seq) continue;
    const float f = half ? f1 : f0;
    float* dst = out + static_cast<long long>(row) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * half] * f,
                      acc[4 * j + 2 * half + 1] * f);
  }
}

// The split body's work items: its kernels launch one block an SM
// (``split_blocks``), and each block walks several items, so that one
// item's loads overlap the previous item's products (at S 128-256 a q
// tile meets one or two kv tiles, and a block of one item would wait on
// its loads).  Item ``idx`` is (x, y, z) = (idx % nx, (idx / nx) % ny,
// idx / (nx ny)).
struct Item {
  int x, y, z;
};

__device__ __forceinline__ Item item_at(int idx, int nx, int ny) {
  return {idx % nx, (idx / nx) % ny, idx / (nx * ny)};
}

// The idx of this block's n-th item: the blocks take the items in rounds
// of gridDim.x, every other round in reverse, so that a block's share of
// a causal grid (whose neighbouring items alternate long and short) evens
// out.
__device__ __forceinline__ int item_index(int n) {
  return n * gridDim.x +
         (n & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The blocks of a grid of ``items`` work items: one an SM, or fewer.
inline unsigned split_blocks(long long items) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return static_cast<unsigned>(items < sms ? items : sms);
}

}  // namespace ttd_flash
