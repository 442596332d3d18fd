// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the argument block, the choice of body, the
// sliding-window band of the splash kernels (K7), which run the same
// bodies instantiated with BAND = true, and for each body its tiles:
// the wgmma bodies' masks, register fragments and epilogue (below, on
// hopper.cuh's TMA ring and wgmma), and the mma.sync / FMA bodies' tile
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
// for the forward and the backward: kWgmma for bf16 at D 64 and 128,
// kMmaSync for bf16 at D 256 (its [64, 256] f32 accumulators would not
// fit a warpgroup's registers beside the scores), kFma for f32 (wgmma's
// tf32 would change its numerics); kNone where the pair is refused.
enum Body : int { kNone = -1, kFma = 0, kMmaSync = 1, kWgmma = 2 };

inline Body body(int head_dim, int dtype) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return kNone;
  if (dtype == ttd::kF32) return kFma;
  if (dtype == ttd::kBF16) return head_dim == 256 ? kMmaSync : kWgmma;
  return kNone;
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

}  // namespace ttd_flash
