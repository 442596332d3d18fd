// Fused paged decode attention for Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   paged_attention (kernel _paged_attn_kernel): flash-style attention of
//   q [lanes, q_len, H, hd] over each lane's KV rows read straight through
//   its block table, online (max, sumexp, acc) per query row, GQA groups,
//   visibility p <= lengths[lane] + qi, scale hd^-0.5, optional int8 pools
//   with per-(row, kv_head) f32 scales dequantised on load.
//
// Bound on this card: bytes.  Decode reads every visible K/V row once and
//   does 4*hd flops per (query row, key), i.e. about rep*q_len/elem_bytes
//   flops a byte: 0.5 for Llama-2-7B bf16 decode, far below the ridge.  So
//   the kernel has to keep enough loads in flight, on every SM, to cover
//   the memory latency, and little else matters.
//
// Two bodies, chosen statically (``choose_body``):
//   ring (bf16 and int8 pools at hd 64 and 128, 16-byte aligned pools, at
//     most 8 query rows a kv-head group): a long lane spreads over several
//     blocks (flash-decoding in one launch).  The grid is (kv head, lane,
//     chunk of kChunkRows rows); a block whose chunk lies past its lane's
//     last visible row returns at once.  The block stages its chunk's
//     block ids in shared memory once; 32-row tiles then stream through
//     a 4-stage ring in shared memory, in the pool's own dtype, filled by
//     16-byte cp.async copies (4-byte ones for the int8 scales): three
//     tiles are in flight while one is consumed.  cp.async, not TMA: the
//     scales are 4-byte values strided by kvh, below TMA's 16-byte box,
//     and a copy per row needs no tensor map encoded on the host per
//     call.  Each thread's copies of a tile are one cp.async group; one
//     block barrier a tile both publishes tile j and frees tile j - 1's
//     stage, and is the only block-wide wait in the tile loop (faster, on
//     the card, than full/empty mbarriers with per-thread arrivals).
//     Every warp works on every tile: the 8 warps take
//     a tile's keys in turn, each lane owns hd / 32 dims, and a warp keeps
//     its own online softmax and f32 accumulator for the group's rows in
//     registers (4 values a lane at hd 128, one row); rows are converted
//     (and int8 dequantised: bytes to floats by a byte permute and an
//     add, products rounded to bf16 two at a time) at use.  The warps merge once, at the end, through
//     shared memory.  A lane of one chunk writes its output; a lane of
//     several writes each chunk's (m, l, acc) to a workspace, and the
//     last block of the lane to finish (an atomic ticket, reset for the
//     next call) merges them in chunk order, so the result is
//     deterministic.  No tensor cores: at R = 1 a dot product per key on
//     the CUDA cores is far from the bound.
//   staged (every other case: f32 pools, hd 8/6/256, rows not a whole
//     number of 16-byte vectors, more than 8 query rows a group): one
//     256-thread block per (kv head, lane) walks the lane in tiles of up
//     to 64 rows staged in shared memory as f32; one warp per (row, key)
//     for the logits, one per row for the softmax, a thread per
//     accumulator slice; loads and math do not overlap.
// Both: tiles wholly past len + q_len - 1 (or past cache_len) are
//   skipped, their contribution being exactly zero; table ids are clamped
//   into the pool, so a stale lane reads only pool rows; int8 rows
//   dequantise as round_q(round_q(v) * round_q(s)), the math is f32 to
//   the output's one rounding; position 0 is visible to every row, so no
//   row ends with an empty softmax.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // 16-byte loads in flight per thread
constexpr int kTileRows = 64;    // target rows per tile
constexpr int kSmemLimit = 232448;

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;  // [nb, bs, kvh], int8 pools only
  const float* v_scales;
  const int* table;    // [lanes, n_blk]
  const int* lengths;  // [lanes]
  void* out;           // [lanes, q_len, heads, hd], q's dtype
  int q_len, heads, kvh, hd, nb, bs, n_blk, cache_len;
  int blocks_per_tile;
  int vec;  // rows load as 16-byte vectors (size and alignment allow it)
  float scale;
  float* part;       // ring: [kvh, lanes, max_chunks, R, hd + 2] partials
  int* tickets;      // ring: [kvh * lanes], zero between calls
  int max_chunks;    // ring: chunks of the longest possible lane
};

// 16 bytes of KT as floats.
template <typename KT>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = f[i];
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& raw, float* out) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(c[i]);
  }
};

// reference: pool.astype(q.dtype) * scales.astype(q.dtype)
template <typename QT>
__device__ __forceinline__ float dequant(float v, float s) {
  return ttd::round_to<QT>(ttd::round_to<QT>(v) * ttd::round_to<QT>(s));
}

__host__ __device__ inline long long smem_bytes(int rows, int hd,
                                                int tile_rows) {
  // qs, acc [rows, hd]; ks, vs [tile, hd]; sc [rows, tile]; m, l, alpha
  // [rows]; tile block ids (ints).
  return 4LL * (2LL * rows * hd + 2LL * tile_rows * hd +
                1LL * rows * tile_rows + 3LL * rows) +
         4LL * tile_rows;
}

template <typename QT, typename KT, bool kInt8>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  const int g = blockIdx.x;      // kv head
  const int lane = blockIdx.y;   // sequence
  const int hd = p.hd;
  const int bs = p.bs;
  const int rep = p.heads / p.kvh;
  const int R = rep * p.q_len;  // query rows of this kv-head group
  const int T = p.blocks_per_tile * bs;

  extern __shared__ float smem[];
  float* qs = smem;              // [R, hd]
  float* acc = qs + R * hd;      // [R, hd]
  float* ks = acc + R * hd;      // [T, hd]
  float* vs = ks + T * hd;       // [T, hd]
  float* sc = vs + T * hd;       // [R, T] logits, then probabilities
  float* m = sc + R * T;         // [R] running max
  float* l = m + R;              // [R] running sum
  float* alpha = l + R;          // [R] this tile's rescale
  int* phys_s = reinterpret_cast<int*>(alpha + R);  // [blocks_per_tile]

  // Row r = h_local * q_len + qi, head h = g * rep + h_local.
  const QT* q = static_cast<const QT*>(p.q);
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int h = g * rep + r / p.q_len;
    const int qi = r % p.q_len;
    qs[i] = ttd::to_f32(
        q[((static_cast<long long>(lane) * p.q_len + qi) * p.heads + h) * hd +
          d]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }

  const int cur = p.lengths[lane];
  const int c = min(p.cache_len, p.n_blk * bs);
  const int last = min(c - 1, cur + p.q_len - 1);  // last visible position
  const int n_blocks = last < 0 ? 0 : last / bs + 1;
  const KT* kp = static_cast<const KT*>(p.k_pool);
  const KT* vp = static_cast<const KT*>(p.v_pool);
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  constexpr int V = Vec<KT>::N;
  const int nvec_row = hd / V;

  for (int jb0 = 0; jb0 < n_blocks; jb0 += p.blocks_per_tile) {
    const int nbt = min(p.blocks_per_tile, n_blocks - jb0);
    const int rows = nbt * bs;
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < nbt; i += kThreads) {
      const int ph =
          p.table[static_cast<long long>(lane) * p.n_blk + jb0 + i];
      phys_s[i] = min(max(ph, 0), p.nb - 1);  // never read outside the pool
    }
    __syncthreads();

    if (p.vec) {
      const int total = rows * nvec_row;
      for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
        uint4 kr[kUnroll], vr[kUnroll];
        float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = base + u * kThreads;
          if (v < total) {
            const int tr = v / nvec_row;
            const int dv = v - tr * nvec_row;
            const long long row =
                (static_cast<long long>(phys_s[tr / bs]) * bs + tr % bs) *
                    p.kvh + g;
            kr[u] = *reinterpret_cast<const uint4*>(kp + row * hd + dv * V);
            vr[u] = *reinterpret_cast<const uint4*>(vp + row * hd + dv * V);
            if (kInt8) {
              ksc[u] = p.k_scales[row];
              vsc[u] = p.v_scales[row];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = base + u * kThreads;
          if (v < total) {
            const int tr = v / nvec_row;
            const int dv = v - tr * nvec_row;
            float kf[V], vf[V];
            Vec<KT>::unpack(kr[u], kf);
            Vec<KT>::unpack(vr[u], vf);
            if (kInt8) {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                kf[e] = dequant<QT>(kf[e], ksc[u]);
                vf[e] = dequant<QT>(vf[e], vsc[u]);
              }
            }
            float4* kd = reinterpret_cast<float4*>(ks + tr * hd + dv * V);
            float4* vd = reinterpret_cast<float4*>(vs + tr * hd + dv * V);
#pragma unroll
            for (int e = 0; e < V / 4; ++e) {
              kd[e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2],
                                  kf[4 * e + 3]);
              vd[e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2],
                                  vf[4 * e + 3]);
            }
          }
        }
      }
    } else {  // rows not a whole number of 16-byte vectors
      for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
        const int tr = i / hd;
        const int d = i - tr * hd;
        const long long row =
            (static_cast<long long>(phys_s[tr / bs]) * bs + tr % bs) * p.kvh +
            g;
        float kv = ttd::to_f32(kp[row * hd + d]);
        float vv = ttd::to_f32(vp[row * hd + d]);
        if (kInt8) {
          kv = dequant<QT>(kv, p.k_scales[row]);
          vv = dequant<QT>(vv, p.v_scales[row]);
        }
        ks[i] = kv;
        vs[i] = vv;
      }
    }
    __syncthreads();

    // Logits: one warp per (row, key).
    for (int pair = warp; pair < R * rows; pair += kWarps) {
      const int r = pair / rows;
      const int tr = pair - r * rows;
      float s = 0.f;
      for (int d = wl; d < hd; d += 32) s += qs[r * hd + d] * ks[tr * hd + d];
      s = ttd::warp_sum(s);
      if (wl == 0) {
        const int pos = jb0 * bs + tr;
        const bool vis = pos < c && pos <= cur + r % p.q_len;
        sc[r * T + tr] = vis ? s * p.scale : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // Online softmax: one warp per row.
    for (int r = warp; r < R; r += kWarps) {
      float mx = -CUDART_INF_F;
      for (int tr = wl; tr < rows; tr += 32) mx = fmaxf(mx, sc[r * T + tr]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int tr = wl; tr < rows; tr += 32) {
        const float e = m_new == -CUDART_INF_F
                            ? 0.f
                            : expf(sc[r * T + tr] - m_new);
        sc[r * T + tr] = e;
        sum += e;
      }
      sum = ttd::warp_sum(sum);
      if (wl == 0) {
        // exp(-inf) = 0 on a row's first visible tile.
        const float a = m_new == -CUDART_INF_F ? 1.f : expf(m_old - m_new);
        l[r] = l[r] * a + sum;
        m[r] = m_new;
        alpha[r] = a;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < R * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      float v = acc[i] * alpha[r];
      for (int tr = 0; tr < rows; ++tr) v += sc[r * T + tr] * vs[tr * hd + d];
      acc[i] = v;
    }
  }
  __syncthreads();

  QT* out = static_cast<QT*>(p.out);
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int h = g * rep + r / p.q_len;
    const int qi = r % p.q_len;
    out[((static_cast<long long>(lane) * p.q_len + qi) * p.heads + h) * hd +
        d] = ttd::from_f32<QT>(acc[i] / l[r]);
  }
}

template <typename QT, typename KT, bool kInt8>
int launch(Params p, int lanes, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT, kInt8>;
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.k_pool) |
                         reinterpret_cast<uintptr_t>(p.v_pool);
  p.vec = p.hd % Vec<KT>::N == 0 && base % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(p.kvh, lanes), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// -- the ring body ---------------------------------------------------------

namespace ring {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // logical rows a tile
constexpr int kKeys = kRows / kWarps;      // a tile's keys each warp takes
constexpr int kStages = 4;
constexpr int kChunkRows = 8 * kRows;      // rows one block takes at most
constexpr int kMaxRows = 8;                // query rows a kv-head group

template <typename KT, int HD>
__host__ __device__ constexpr int stage_bytes() {  // K, V rows and scales
  return 2 * kRows * HD * static_cast<int>(sizeof(KT)) + 2 * kRows * 4;
}

template <typename KT, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<KT, HD>();
}

// Byte i of ``w`` (int8 values, each XOR 0x80) as an exact float: the
// offset byte under the exponent of 2^23, less 2^23 + 128.
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 | i)) -
         8388736.f;
}

// A lane's DL consecutive values of a row in shared memory, as floats
// (int8 exact, not yet scaled).
template <typename KT, int DL>
__device__ __forceinline__ void lane_load(const KT* src, float* f) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    uint32_t w;
    if constexpr (DL == 4) {
      w = *reinterpret_cast<const uint32_t*>(src);
    } else {
      w = *reinterpret_cast<const uint16_t*>(src);
    }
    w ^= 0x80808080u;
#pragma unroll
    for (int e = 0; e < DL; ++e) f[e] = i8_at(w, e);
  } else if constexpr (DL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(b[0]);
    const float2 hi = __bfloat1622float2(b[1]);
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  } else {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    f[0] = v.x;
    f[1] = v.y;
  }
}

// int8 dequantised as the reference does, round_q(round_q(v) *
// round_q(s)) with ``sq`` = round_q(s): v is exact in either dtype; for
// bf16 the product of two 8-bit significands is exact in f32, so its one
// rounding to bf16 (two at a time, cvt.rn.bf16x2) is the reference's,
// and for f32 the product is.
template <typename QT, int DL>
__device__ __forceinline__ void dequant_lane(float* f, float sq) {
#pragma unroll
  for (int e = 0; e < DL; e += 2) {
    f[e] *= sq;
    f[e + 1] *= sq;
    if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
      const float2 v =
          __bfloat1622float2(__floats2bfloat162_rn(f[e], f[e + 1]));
      f[e] = v.x;
      f[e + 1] = v.y;
    }
  }
}

// One block: kv head blockIdx.x, lane blockIdx.y, rows [chunk *
// kChunkRows, +kChunkRows) of the lane; KR >= R query rows.  The tile
// loop has no branch on R: padding rows repeat row 0 and are never
// stored, so the keys' shuffle reductions interleave.
template <typename QT, typename KT, int HD, int KR>
__global__ void __launch_bounds__(kThreads)
    paged_attention_ring_kernel(const Params p) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int DL = HD / 32;                              // dims a lane
  constexpr int RB = HD * static_cast<int>(sizeof(KT));    // bytes a row
  constexpr int CPR = RB / 16;                             // copies a row
  constexpr int kStage = stage_bytes<KT, HD>();
  constexpr int kCopies = 2 * kRows * CPR / kThreads;      // a thread, tile
  static_assert(2 * kRows * CPR % kThreads == 0, "whole copies a thread");
  static_assert(kWarps * KR * (HD + 2) * 4 <= kStages * kStage,
                "the warps' partials fit the ring");
  const int g = blockIdx.x;
  const int seq = blockIdx.y;
  const int chunk = blockIdx.z;
  const int q_len = p.q_len, heads = p.heads, kvh = p.kvh, bs = p.bs;
  const int rep = heads / kvh;
  const int R = rep * q_len;
  const int cur = p.lengths[seq];
  const int c = min(p.cache_len, p.n_blk * bs);
  const int last = min(c - 1, cur + q_len - 1);  // last visible position
  const int row0 = chunk * kChunkRows;
  const int tid = threadIdx.x;
  QT* out = static_cast<QT*>(p.out);
  // Output element (query row r, dim d) of this block's group.
  auto out_at = [&](int r, int d) -> QT& {
    const int h = g * rep + r / q_len;
    const int qi = r % q_len;
    return out[((static_cast<long long>(seq) * q_len + qi) * heads + h) * HD +
               d];
  };
  if (row0 > last) {  // past the lane's last row (no row at all: 0 / 0)
    if (last < 0 && chunk == 0)
      for (int i = tid; i < R * HD; i += kThreads)
        out_at(i / HD, i % HD) = ttd::from_f32<QT>(CUDART_NAN_F);
    return;
  }
  const int row_end = min(row0 + kChunkRows, last + 1);
  const int n_tiles = (row_end - row0 + kRows - 1) / kRows;
  const int n_chunks = last / kChunkRows + 1;

  extern __shared__ __align__(128) unsigned char ring_smem[];
  // The chunk's physical block ids, clamped into the pool (a stale table
  // reads only pool rows).
  __shared__ int ids[kChunkRows];
  const int pow2 = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;  // log2 bs
  const int blk0 = pow2 >= 0 ? row0 >> pow2 : row0 / bs;
  const int blk1 = pow2 >= 0 ? (row_end - 1) >> pow2 : (row_end - 1) / bs;
  const int* tbl = p.table + static_cast<long long>(seq) * p.n_blk;
  for (int i = tid; i <= blk1 - blk0; i += kThreads)
    ids[i] = min(max(__ldg(tbl + blk0 + i), 0), p.nb - 1);
  __syncthreads();
  const int warp = tid >> 5;
  const int wl = tid & 31;

  auto pool_row = [&](int pos) -> long long {  // element row of the pool
    const int blk = pow2 >= 0 ? pos >> pow2 : pos / bs;
    return (static_cast<long long>(ids[blk - blk0]) * bs + (pos - blk * bs)) *
               kvh + g;
  };
  const unsigned char* kp = static_cast<const unsigned char*>(p.k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(p.v_pool);
  const float* k_scales = p.k_scales;
  const float* v_scales = p.v_scales;

  // Tile j of the chunk into stage j % kStages (the stage of tile j -
  // kStages, which every thread is done with by then).  Rows past
  // ``last`` are not loaded.
  auto issue = [&](int j) {
    unsigned char* st = ring_smem + (j % kStages) * kStage;
    const int t0 = row0 + j * kRows;
    const int n = min(kRows, row_end - t0);
#pragma unroll
    for (int it = 0; it < kCopies; ++it) {
      const int i = tid + it * kThreads;
      const int kv = i / (kRows * CPR);
      const int rem = i - kv * kRows * CPR;
      const int r = rem / CPR;
      const int cc = rem - r * CPR;
      if (r < n)
        ttd_hopper::cp_async16(st + (kv * kRows + r) * RB + cc * 16,
                               (kv ? vp : kp) + pool_row(t0 + r) * RB +
                                   cc * 16);
    }
    if constexpr (kInt8) {
      if (tid < 2 * kRows) {
        const int kv = tid / kRows;
        const int r = tid - kv * kRows;
        if (r < n)
          ttd_hopper::cp_async4(st + 2 * kRows * RB + tid * 4,
                                (kv ? v_scales : k_scales) +
                                    pool_row(t0 + r));
      }
    }
  };

  // Query rows r = h_local * q_len + qi of head g * rep + h_local; lim[r]
  // is the last position row r sees.
  const QT* q = static_cast<const QT*>(p.q);
  float qf[KR][DL];
  int lim[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int rr = r < R ? r : 0;  // padding rows repeat row 0
    const int h = g * rep + rr / q_len;
    const int qi = rr % q_len;
    const QT* qr =
        q + ((static_cast<long long>(seq) * q_len + qi) * heads + h) * HD +
        wl * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) qf[r][e] = ttd::to_f32(qr[e]);
    lim[r] = min(cur + qi, last);
  }
  float m[KR], l[KR], acc[KR][DL];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  // The ring: kStages - 1 tiles in flight while one is consumed; each
  // thread's copies of a tile are one cp.async group, and one block
  // barrier a tile makes every group of tile j visible and frees the
  // stage of tile j - 1 for tile j + kStages - 1.
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) issue(j);
    ttd_hopper::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    ttd_hopper::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_tiles) issue(j + kStages - 1);
    ttd_hopper::cp_async_commit();
    const unsigned char* st = ring_smem + (j % kStages) * kStage;
    const KT* kt = reinterpret_cast<const KT*>(st);
    const KT* vt = reinterpret_cast<const KT*>(st + kRows * RB);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kRows * RB);
    const float* vsc = ksc + kRows;
    const int t0 = row0 + j * kRows;

    // Logits of this warp's keys t = k * kWarps + warp.  Rows past
    // ``last`` were not loaded: their logits are -inf whatever was read.
    float sc[kKeys][KR];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int t = k * kWarps + warp;
      float kf[DL];
      lane_load<KT, DL>(kt + t * HD + wl * DL, kf);
      if constexpr (kInt8)
        dequant_lane<QT, DL>(kf, ttd::round_to<QT>(ksc[t]));
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) dot += qf[r][e] * kf[e];
        dot = ttd::warp_sum(dot);
        sc[k][r] = t0 + t <= lim[r] ? dot * p.scale : -CUDART_INF_F;
      }
    }
    // Fold them into the warp's online softmax.
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      float mx = m[r];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) mx = fmaxf(mx, sc[k][r]);
      // exp(-inf) = 0 until the row's first visible key.
      const float a = mx == -CUDART_INF_F ? 1.f : expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const float e = mx == -CUDART_INF_F ? 0.f : expf(sc[k][r] - mx);
        sc[k][r] = e;
        sum += e;
      }
      l[r] = l[r] * a + sum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] *= a;
    }
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int t = k * kWarps + warp;
      float vf[DL];
      lane_load<KT, DL>(vt + t * HD + wl * DL, vf);
      if constexpr (kInt8)
        dequant_lane<QT, DL>(vf, ttd::round_to<QT>(vsc[t]));
      const bool loaded = t0 + t <= last;
#pragma unroll
      for (int e = 0; e < DL; ++e) vf[e] = loaded ? vf[e] : 0.f;
#pragma unroll
      for (int r = 0; r < KR; ++r)
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] += sc[k][r] * vf[e];
    }
  }

  // Merge the warps (in warp order) through the now idle ring.
  ttd_hopper::cp_async_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(ring_smem);  // [kWarps, KR, HD]
  float* red_m = red_acc + kWarps * KR * HD;             // [kWarps, KR]
  float* red_l = red_m + kWarps * KR;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (r < R) {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        red_acc[(warp * KR + r) * HD + wl * DL + e] = acc[r][e];
      if (wl == 0) {
        red_m[warp * KR + r] = m[r];
        red_l[warp * KR + r] = l[r];
      }
    }
  }
  __syncthreads();
  const bool direct = n_chunks == 1;
  // This (kv head, lane)'s partials: [max_chunks, R, HD + 2] (acc, m, l).
  float* part = direct ? nullptr
                       : p.part + (static_cast<long long>(g) * gridDim.y +
                                   seq) * p.max_chunks * R * (HD + 2);
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * KR + r]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w * KR + r];
      const float e = mw == -CUDART_INF_F ? 0.f : expf(mw - mx);
      sum += red_l[w * KR + r] * e;
      a += red_acc[(w * KR + r) * HD + d] * e;
    }
    if (direct) {
      out_at(r, d) = ttd::from_f32<QT>(a / sum);
    } else {
      float* pc = part + (static_cast<long long>(chunk) * R + r) * (HD + 2);
      pc[d] = a;
      if (d == 0) {
        pc[HD] = mx;
        pc[HD + 1] = sum;
      }
    }
  }
  if (direct) return;

  // The lane's last block to finish merges every chunk, in chunk order.
  __shared__ int merge;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = p.tickets + static_cast<long long>(g) * gridDim.y + seq;
    merge = atomicAdd(ticket, 1) == n_chunks - 1;
    if (merge) *ticket = 0;  // ready for the next call
  }
  __syncthreads();
  if (!merge) return;
  __threadfence();
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    float mx = -CUDART_INF_F;
    for (int ch = 0; ch < n_chunks; ++ch)
      mx = fmaxf(mx, __ldcg(part + (ch * R + r) * (HD + 2) + HD));
    float sum = 0.f, a = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float* pc = part + (ch * R + r) * (HD + 2);
      const float mc = __ldcg(pc + HD);
      const float e = mc == -CUDART_INF_F ? 0.f : expf(mc - mx);
      sum += __ldcg(pc + HD + 1) * e;
      a += __ldcg(pc + d) * e;
    }
    out_at(r, d) = ttd::from_f32<QT>(a / sum);
  }
}

}  // namespace ring

// 1 (ring) where that body applies, 0 (staged) otherwise.
int choose_body(int kv_dtype, int hd, int rows, bool aligned) {
  return aligned && (kv_dtype == ttd::kBF16 || kv_dtype == ttd::kI8) &&
         (hd == 64 || hd == 128) && rows >= 1 && rows <= ring::kMaxRows;
}

template <typename QT, typename KT, int HD, int KR>
int launch_ring(const Params& p, int lanes, cudaStream_t stream) {
  auto kernel = ring::paged_attention_ring_kernel<QT, KT, HD, KR>;
  constexpr int smem = ring::smem_bytes<KT, HD>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(p.kvh, lanes, p.max_chunks), ring::kThreads, smem, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int HD>
int launch_ring_rows(const Params& p, int lanes, int rows,
                     cudaStream_t stream) {
  if (rows <= 1) return launch_ring<QT, KT, HD, 1>(p, lanes, stream);
  if (rows <= 2) return launch_ring<QT, KT, HD, 2>(p, lanes, stream);
  if (rows <= 4) return launch_ring<QT, KT, HD, 4>(p, lanes, stream);
  return launch_ring<QT, KT, HD, 8>(p, lanes, stream);
}

template <typename QT, typename KT>
int launch_ring_hd(const Params& p, int lanes, int rows,
                   cudaStream_t stream) {
  return p.hd == 64 ? launch_ring_rows<QT, KT, 64>(p, lanes, rows, stream)
                    : launch_ring_rows<QT, KT, 128>(p, lanes, rows, stream);
}

}  // namespace

// The least dynamic shared memory one block of the staged body needs
// (bytes; one pool block a tile); the wrapper refuses shapes above the
// card's 227 KB.
extern "C" long long ttd_paged_attention_smem(int rows, int hd, int bs) {
  return smem_bytes(rows, hd, bs);
}

// The body that serves a call: 1 (ring), 0 (staged).  ``rows`` =
// heads / kvh * q_len; ``aligned``: both pools start on 16-byte
// boundaries.
extern "C" int ttd_paged_attention_body(int kv_dtype, int hd, int rows,
                                        int aligned) {
  return choose_body(kv_dtype, hd, rows, aligned != 0);
}

// Rows of a lane one block of the ring body takes.
extern "C" int ttd_paged_attention_chunk_rows() { return ring::kChunkRows; }

// q, out: [lanes, q_len, heads, hd] (q_dtype); k_pool, v_pool:
// [nb, bs, kvh, hd] (kv_dtype; int8 needs k_scales/v_scales [nb, bs, kvh]
// f32); table: [lanes, n_blk] int32; lengths: [lanes] int32.  The ring
// body, where a lane may span more than one chunk (min(cache_len, n_blk *
// bs) > ttd_paged_attention_chunk_rows()), needs ``workspace`` (f32,
// kvh * lanes * chunks * rows * (hd + 2) with chunks that row count's
// chunks) and ``tickets`` (int32 [kvh * lanes], zero; left zero).
// ``body``: -1 the static choice (ttd_paged_attention_body), 0 staged,
// 1 ring (refused where it does not apply).
extern "C" int ttd_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lengths, void* out, void* workspace, void* tickets,
    int lanes, int q_len, int heads, int kvh, int hd, int nb, int bs,
    int n_blk, int cache_len, float scale, int q_dtype, int kv_dtype,
    int body, void* stream) {
  if (lanes <= 0 || q_len <= 0) return 0;
  if (kvh <= 0 || heads % kvh != 0 || lanes > 65535 || cache_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = heads / kvh * q_len;
  const uintptr_t base = reinterpret_cast<uintptr_t>(k_pool) |
                         reinterpret_cast<uintptr_t>(v_pool);
  const int chosen = choose_body(kv_dtype, hd, rows, base % 16 == 0);
  if (body == -1) body = chosen;
  if (body < 0 || body > chosen)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.q_len = q_len;
  p.heads = heads;
  p.kvh = kvh;
  p.hd = hd;
  p.nb = nb;
  p.bs = bs;
  p.n_blk = n_blk;
  p.cache_len = cache_len;
  p.scale = scale;
  p.part = static_cast<float*>(workspace);
  p.tickets = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (body == 1) {
    const int c = cache_len < n_blk * bs ? cache_len : n_blk * bs;
    p.max_chunks = c > 0 ? (c + ring::kChunkRows - 1) / ring::kChunkRows : 1;
    if (p.max_chunks > 65535 ||
        (p.max_chunks > 1 && (workspace == nullptr || tickets == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (q_dtype == ttd::kF32) {
      if (kv_dtype == ttd::kBF16)
        return launch_ring_hd<float, bf16>(p, lanes, rows, st);
      return launch_ring_hd<float, int8_t>(p, lanes, rows, st);
    }
    if (q_dtype == ttd::kBF16) {
      if (kv_dtype == ttd::kBF16)
        return launch_ring_hd<bf16, bf16>(p, lanes, rows, st);
      return launch_ring_hd<bf16, int8_t>(p, lanes, rows, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Staged: the largest tile (in pool blocks) up to kTileRows rows that
  // fits.
  int bpt = kTileRows / bs > 1 ? kTileRows / bs : 1;
  while (bpt > 1 && smem_bytes(rows, hd, bpt * bs) > kSmemLimit) bpt /= 2;
  const long long smem = smem_bytes(rows, hd, bpt * bs);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  p.blocks_per_tile = bpt;
  const size_t sm = static_cast<size_t>(smem);
  if (q_dtype == ttd::kF32) {
    if (kv_dtype == ttd::kF32)
      return launch<float, float, false>(p, lanes, sm, st);
    if (kv_dtype == ttd::kBF16)
      return launch<float, bf16, false>(p, lanes, sm, st);
    if (kv_dtype == ttd::kI8)
      return launch<float, int8_t, true>(p, lanes, sm, st);
  } else if (q_dtype == ttd::kBF16) {
    if (kv_dtype == ttd::kF32)
      return launch<bf16, float, false>(p, lanes, sm, st);
    if (kv_dtype == ttd::kBF16)
      return launch<bf16, bf16, false>(p, lanes, sm, st);
    if (kv_dtype == ttd::kI8)
      return launch<bf16, int8_t, true>(p, lanes, sm, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
