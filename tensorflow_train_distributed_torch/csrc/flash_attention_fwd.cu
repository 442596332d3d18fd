// Flash attention (K2) and splash attention (K7) forward for Hopper
// (sm_90a).
//
// K2 replaces: the Pallas TPU library kernel the JAX package calls from
//   tensorflow_train_distributed_tpu/ops/attention.py:357-367,
//   jax/experimental/pallas/ops/tpu/flash_attention.py
//   _flash_attention_impl: causal or full attention over q, k, v
//   [B, H, S, D] with optional segment ids, saving the row statistics the
//   backward needs.  Its numerics are kept: scores q.k^T accumulated in
//   f32, sm_scale applied in f32 after the product, masked scores get
//   + (-0.7 * f32 max), p rounded to v's dtype before p.v, the output in
//   q's dtype.  The row logsumexp (m + log l) is saved in f32 in place of
//   the library's separate l and m.
//
// Bound on this card: operations for bf16 at S >= a few hundred
//   (4*S*S*D flops a head against 4*S*D elements moved; at the llama_125m
//   shape 51.5 GFLOP against 0.1 GB), bytes only at short S.
//
// Design: one block per (q tile, head, batch); the TPU grid's sequential
//   kv axis becomes a loop inside the block over the kv tiles, stopping at
//   the diagonal tile when causal (the tiles above it are skipped, as the
//   library skips them).  Each warp owns 16 query rows and keeps its
//   running max, sum and output accumulator in registers; K and V tiles
//   are staged in shared memory by the whole block.  bf16 products run on
//   the tensor cores with mma.sync m16n8k16 (f32 accumulate); f32 runs the
//   same layout with FMAs.  GQA reads kv head h / (H / KVH) directly,
//   with no repeated copy.  Simple first: no cp.async/TMA pipelining, no
//   wgmma, one tile in flight.
//
// K7 replaces: the Pallas TPU splash kernel the JAX package calls for
//   sliding-window attention, tensorflow_train_distributed_tpu/ops/
//   attention.py:232-274 (make_splash_mha over a LocalMask per head),
//   jax/experimental/pallas/ops/tpu/splash_attention/
//   splash_attention_kernel.py _splash_attention_forward (:895).  Causal
//   attention of key k by query q when q - window < k <= q or k < sinks,
//   with segment ids.  Splash's numerics, bar one rounding: the caller
//   passes q * sm_scale rounded to q's dtype and the kernel applies a scale
//   of 1; scores in f32; masked scores get -0.7 f32max; the output in q's
//   dtype.  Splash keeps p in f32 for p.v; the bf16 kernel rounds p to bf16
//   to run p.v on the tensor cores, as K2 does.
//   Bound: operations, 4*D flops a visible (query, key) pair.
//   Design: K2's kernel instantiated with BAND = true.  A q tile visits the
//   kv tiles from the one holding its first row's window start to its
//   diagonal, after the tiles holding sinks (KvTiles); the band's edge is
//   masked inside the tiles it cuts (visible<true>).
#include "flash_common.cuh"

namespace ttd_flash {
namespace {

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(Cfg<T>::kThreads)
    flash_fwd_kernel(Params p) {
  constexpr int BT = Cfg<T>::kBt;
  constexpr int NT = Cfg<T>::kNt;
  constexpr int NTHREADS = Cfg<T>::kThreads;
  constexpr int LD = tile_pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BT * LD;
  T* vs = ks + BT * LD;
  int* segq = reinterpret_cast<int*>(vs + BT * LD);
  int* segk = segq + BT;
  float* scratch = reinterpret_cast<float*>(segk + 2 * BT);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool seg = p.seg != nullptr;
  float* wscratch = scratch + warp * 16 * (NT * 8 + 4);

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  load_tile<T, D, BT, NTHREADS>(qs, qg + q0 * p.sq.s, p.sq.s);
  if (seg) {
    for (int i = threadIdx.x; i < BT; i += NTHREADS)
      segq[i] = p.seg[static_cast<long long>(b) * p.seq + q0 + i];
  }
  const int lr0 = warp * 16 + g;        // this thread's rows in the tile
  const int lr1 = lr0 + 8;
  const int r0 = q0 + lr0;
  const int r1 = q0 + lr1;

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kv = p.causal ? qt + 1 : p.seq / BT;
  const KvTiles<BAND, BT> tiles(p.window, p.sinks, q0);
  for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt)) {
    const int k0 = kt * BT;
    __syncthreads();                    // the previous tile is consumed
    load_tile<T, D, BT, NTHREADS>(ks, kg + k0 * p.sk.s, p.sk.s);
    load_tile<T, D, BT, NTHREADS>(vs, vg + k0 * p.sv.s, p.sv.s);
    if (seg) {
      for (int i = threadIdx.x; i < BT; i += NTHREADS)
        segk[i] = p.seg[static_cast<long long>(b) * p.seq + k0 + i];
    }
    __syncthreads();

    float s[NT][4];
    Tile<T>::template abt<D, NT, LD>(qs + warp * 16 * LD, ks, s, wscratch);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = n * 8 + 2 * t + (e & 1);
        const int lr = e < 2 ? lr0 : lr1;
        float x = s[n][e] * p.scale;
        if (!visible<BAND>(q0 + lr, k0 + lc, p.causal, p.window,
                           p.sinks, seg, seg ? segq[lr] : 0,
                           seg ? segk[lc] : 0))
          x += kMaskValue;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0);    // 0 on the first tile (m = -inf)
    const float a1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + quad_sum(ls0);
    l1 = l1 * a1 + quad_sum(ls1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    Tile<T>::template pb<D, NT, LD>(s, vs, acc, wscratch);
  }

  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    og[r0 * p.so.s + c] = ttd::from_f32<T>(acc[n][0] * inv0);
    og[r0 * p.so.s + c + 1] = ttd::from_f32<T>(acc[n][1] * inv0);
    og[r1 * p.so.s + c] = ttd::from_f32<T>(acc[n][2] * inv1);
    og[r1 * p.so.s + c + 1] = ttd::from_f32<T>(acc[n][3] * inv1);
  }
  if (t == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.seq;
    lse[r0] = m0 + logf(l0);
    lse[r1] = m1 + logf(l1);
  }
}

template <typename T, int D, bool BAND>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>(3);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BAND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.seq / Cfg<T>::kBt, p.heads, p.batch);
  flash_fwd_kernel<T, D, BAND><<<grid, Cfg<T>::kThreads, bytes, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BAND>
int launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, BAND>(p, stream);
    case 128: return launch<T, 128, BAND>(p, stream);
    case 256: return launch<T, 256, BAND>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params fwd_params(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* seg, const long long* strides,
                  int batch, int heads, int kv_heads, int seq) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.seg = static_cast<const int*>(seg);
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  return p;
}

template <bool BAND>
int run(const Params& p, int head_dim, int dtype, void* stream) {
  if (p.batch <= 0 || p.seq <= 0) return 0;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads || p.seq % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ttd::kF32) return launch_d<float, BAND>(p, head_dim, st);
  if (dtype == ttd::kBF16) return launch_d<bf16, BAND>(p, head_dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ttd_flash

// q: [B, H, S, D]; k, v: [B, KVH, S, D]; o: [B, H, S, D] (any element
// strides with D contiguous, 16-byte aligned rows); lse: [B, H, S] f32
// contiguous; seg: [B, S] int32 contiguous or null.  ``strides`` holds
// 12 element strides: (b, h, s) of q, k, v, o.  S must be a multiple of
// 64, H a multiple of KVH, D one of 64, 128, 256.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ttd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg, const long long* strides, int batch, int heads,
    int kv_heads, int seq, int head_dim, float scale, int causal, int dtype,
    void* stream) {
  using namespace ttd_flash;
  Params p = fwd_params(q, k, v, o, lse, seg, strides, batch, heads,
                        kv_heads, seq);
  p.scale = scale;
  p.causal = causal;
  return run<false>(p, head_dim, dtype, stream);
}

// K7: operands as ttd_flash_attention_fwd, q already scaled (the kernel's
// scale is 1), causal, keys within ``window`` of their query (the query's
// own included) or among the first ``sinks``; 1 <= window, 0 <= sinks <=
// window.  A window at or past seq is plain causal attention.
extern "C" int ttd_splash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg, const long long* strides, int batch, int heads,
    int kv_heads, int seq, int head_dim, int window, int sinks, int dtype,
    void* stream) {
  using namespace ttd_flash;
  if (window < 1 || sinks < 0 || sinks > window)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = fwd_params(q, k, v, o, lse, seg, strides, batch, heads,
                        kv_heads, seq);
  p.scale = 1.f;
  p.causal = 1;
  p.window = window < seq ? window : seq;
  p.sinks = sinks < seq ? sinks : seq;
  return run<true>(p, head_dim, dtype, stream);
}
