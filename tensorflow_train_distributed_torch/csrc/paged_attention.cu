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
//   flops a byte: 0.5 for Llama-2-7B bf16 decode, far below the ridge.
//
// Design: one 256-thread block per (kv head, lane); the TPU's sequential
//   grid over blocks becomes a loop inside the block over the lane's pool
//   blocks, and nothing carries between blocks of the grid.  The block
//   loads its own length and, per tile, the tile's physical
//   block ids (the TPU kernel's scalar prefetch).
//   A tile spans up to 64 rows (several pool blocks), so each thread has
//   several 16-byte K and V loads in flight at once; the rows are staged in
//   shared memory as f32 (int8 rows dequantised here, rounded through the
//   query dtype as the reference's astype does).  One warp computes each
//   (query row, key) dot product; one warp per query row folds the tile
//   into the row's online softmax with shuffles; each thread updates its
//   own slice of the f32 accumulator.  Tiles wholly past len + q_len - 1
//   (or past cache_len) are skipped: their contribution is exactly zero.
//   Position 0 is visible to every row, so no row ends with an empty
//   softmax.  Simple first: the loads of tile i+1 do not yet overlap the
//   math of tile i (no cp.async/TMA ring), no tensor cores, and a long lane
//   is walked by one block alone (no split-K over its rows).
#include "common.cuh"

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

}  // namespace

// The least dynamic shared memory one block needs (bytes; one pool block a
// tile); the wrapper refuses shapes above the card's 227 KB.
extern "C" long long ttd_paged_attention_smem(int rows, int hd, int bs) {
  return smem_bytes(rows, hd, bs);
}

// q, out: [lanes, q_len, heads, hd] (q_dtype); k_pool, v_pool:
// [nb, bs, kvh, hd] (kv_dtype; int8 needs k_scales/v_scales [nb, bs, kvh]
// f32); table: [lanes, n_blk] int32; lengths: [lanes] int32.
extern "C" int ttd_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lengths, void* out, int lanes, int q_len, int heads,
    int kvh, int hd, int nb, int bs, int n_blk, int cache_len, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (lanes <= 0 || q_len <= 0) return 0;
  if (kvh <= 0 || heads % kvh != 0 || lanes > 65535 || cache_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = heads / kvh * q_len;
  // Largest tile (in pool blocks) up to kTileRows rows that fits.
  int bpt = kTileRows / bs > 1 ? kTileRows / bs : 1;
  while (bpt > 1 && smem_bytes(rows, hd, bpt * bs) > kSmemLimit) bpt /= 2;
  const long long smem = smem_bytes(rows, hd, bpt * bs);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
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
  p.blocks_per_tile = bpt;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
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
