// Flash attention (K2) and splash attention (K7) backward for Hopper
// (sm_90a).
//
// K2 replaces: the Pallas TPU library's backward, reached from
//   tensorflow_train_distributed_tpu/ops/attention.py:357-367:
//   jax/experimental/pallas/ops/tpu/flash_attention.py
//   _flash_attention_bwd_dkv and _flash_attention_bwd_dq, after
//   di = rowsum(dO * O) in f32.  Their numerics are kept: scores
//   recomputed in f32 with sm_scale after the product and the additive
//   mask; p = exp(s - lse); dV += p^T.dO with p rounded to dO's dtype;
//   dS = p * (dP - di) * sm_scale; dK += dS^T.Q and dQ += dS.K with dS
//   rounded to the operands' dtype; f32 accumulation throughout.
//
// Bound on this card: operations for bf16 at the training shapes (10
//   S*S*D flops a head for the causal half, against reading q, k, v, o,
//   dO and writing dq, dk, dv once).
//
// Design: the library's split, so no atomics and a deterministic result.
//   (1) flash_bwd_di: one warp per query row computes di.
//   (2) flash_bwd_dkv: one block per (k tile, kv head, batch); each warp
//       owns 16 key rows and keeps dK and dV in registers while the block
//       loops over the GQA group's heads and, per head, over the q tiles
//       from the diagonal on (causal) -- the TPU's sequential q axis.  The
//       group's contributions are summed in f32 before one rounding, so no
//       repeated K/V copy is needed.
//   (3) flash_bwd_dq: one block per (q tile, head, batch) loops over the kv
//       tiles up to the diagonal, keeping dQ in registers.
//   Tiles and products as in the forward (mma.sync for bf16, FMAs for
//   f32).  Simple first: the probabilities are recomputed in both (2) and
//   (3); no pipelining.
//
// K7 replaces: the splash kernel's backward, splash_attention_kernel.py
//   _splash_attention_bwd_dkv (:1857) and _splash_attention_bwd_dq
//   (:1405), for the sliding-window band of the forward
//   (flash_attention_fwd.cu).  With q pre-scaled and a scale of 1 the K2
//   arithmetic is splash's: p = exp(s - lse), dV += p^T.dO with p rounded
//   to dO's dtype, dS = p * (dP - di), dK += dS^T.Q and dQ += dS.K with dS
//   rounded to the operands' dtype, f32 accumulation.
//   Bound: operations, 10*D flops a visible (query, key) pair.
//   Design: K2's three kernels instantiated with BAND = true.  dq visits
//   the forward's kv tiles (KvTiles); a dk/dv tile visits the q tiles from
//   its diagonal to the last row its window reaches (q_tiles_end), or all
//   of them when it holds a sink.  Still no atomics.
#include "flash_common.cuh"

namespace ttd_flash {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_di_kernel(Params p, int d) {
  const long long rows =
      static_cast<long long>(p.batch) * p.heads * p.seq;
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(row % p.seq);
  const int h = static_cast<int>((row / p.seq) % p.heads);
  const int b = static_cast<int>(row / (static_cast<long long>(p.seq) *
                                        p.heads));
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h +
               s * p.so.s;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h +
               s * p.sdo.s;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) acc += ttd::to_f32(o[i]) * ttd::to_f32(g[i]);
  acc = ttd::warp_sum(acc);
  if (lane == 0) p.di[row] = acc;
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(Cfg<T>::kThreads)
    flash_bwd_dkv_kernel(Params p) {
  constexpr int BT = Cfg<T>::kBt;
  constexpr int NT = Cfg<T>::kNt;
  constexpr int NTHREADS = Cfg<T>::kThreads;
  constexpr int LD = tile_pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BT * LD;
  T* qs = vs + BT * LD;
  T* dos = qs + BT * LD;
  int* segk = reinterpret_cast<int*>(dos + BT * LD);
  int* segq = segk + BT;
  float* lse_s = reinterpret_cast<float*>(segq + BT);
  float* di_s = lse_s + BT;
  float* scratch = di_s + BT;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.heads / p.kv_heads;
  const int k0 = kt * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool seg = p.seg != nullptr;
  float* wscratch = scratch + warp * 16 * (NT * 8 + 4);
  const int n_tiles = p.seq / BT;
  const int q_end = q_tiles_end<BAND, BT>(p.window, p.sinks, k0,
                                             n_tiles);

  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  load_tile<T, D, BT, NTHREADS>(ks, kg + k0 * p.sk.s, p.sk.s);
  load_tile<T, D, BT, NTHREADS>(vs, vg + k0 * p.sv.s, p.sv.s);
  if (seg) {
    for (int i = threadIdx.x; i < BT; i += NTHREADS)
      segk[i] = p.seg[static_cast<long long>(b) * p.seq + k0 + i];
  }
  const int lr0 = warp * 16 + g;      // this thread's key rows in the tile
  const int lr1 = lr0 + 8;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dog = static_cast<const T*>(p.dout) + b * p.sdo.b +
                   h * p.sdo.h;
    const long long stat = (static_cast<long long>(b) * p.heads + h) * p.seq;
    for (int qt = p.causal ? kt : 0; qt < q_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                // the previous q tile is consumed
      load_tile<T, D, BT, NTHREADS>(qs, qg + q0 * p.sq.s, p.sq.s);
      load_tile<T, D, BT, NTHREADS>(dos, dog + q0 * p.sdo.s, p.sdo.s);
      for (int i = threadIdx.x; i < BT; i += NTHREADS) {
        lse_s[i] = p.lse[stat + q0 + i];
        di_s[i] = p.di[stat + q0 + i];
        if (seg) segq[i] = p.seg[static_cast<long long>(b) * p.seq + q0 + i];
      }
      __syncthreads();

      // P^T [16 keys, BT queries] of this warp's keys.
      float pt[NT][4];
      Tile<T>::template abt<D, NT, LD>(ks + warp * 16 * LD, qs, pt,
                                       wscratch);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = n * 8 + 2 * t + (e & 1);   // query in the tile
          const int lr = e < 2 ? lr0 : lr1;          // key in the tile
          float x = pt[n][e] * p.scale;
          if (!visible<BAND>(q0 + lc, k0 + lr, p.causal, p.window,
                             p.sinks, seg, seg ? segq[lc] : 0,
                             seg ? segk[lr] : 0))
            x += kMaskValue;
          pt[n][e] = expf(x - lse_s[lc]);
        }
      }
      Tile<T>::template pb<D, NT, LD>(pt, dos, dv, wscratch);

      // dP^T = V . dO^T, then dS^T.
      float ds[NT][4];
      Tile<T>::template abt<D, NT, LD>(vs + warp * 16 * LD, dos, ds,
                                       wscratch);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = n * 8 + 2 * t + (e & 1);
          ds[n][e] = pt[n][e] * (ds[n][e] - di_s[lc]) * p.scale;
        }
      }
      Tile<T>::template pb<D, NT, LD>(ds, qs, dk, wscratch);
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
  const int r0 = k0 + lr0;
  const int r1 = k0 + lr1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    dkg[r0 * p.sdk.s + c] = ttd::from_f32<T>(dk[n][0]);
    dkg[r0 * p.sdk.s + c + 1] = ttd::from_f32<T>(dk[n][1]);
    dkg[r1 * p.sdk.s + c] = ttd::from_f32<T>(dk[n][2]);
    dkg[r1 * p.sdk.s + c + 1] = ttd::from_f32<T>(dk[n][3]);
    dvg[r0 * p.sdv.s + c] = ttd::from_f32<T>(dv[n][0]);
    dvg[r0 * p.sdv.s + c + 1] = ttd::from_f32<T>(dv[n][1]);
    dvg[r1 * p.sdv.s + c] = ttd::from_f32<T>(dv[n][2]);
    dvg[r1 * p.sdv.s + c + 1] = ttd::from_f32<T>(dv[n][3]);
  }
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(Cfg<T>::kThreads)
    flash_bwd_dq_kernel(Params p) {
  constexpr int BT = Cfg<T>::kBt;
  constexpr int NT = Cfg<T>::kNt;
  constexpr int NTHREADS = Cfg<T>::kThreads;
  constexpr int LD = tile_pitch<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BT * LD;
  T* ks = dos + BT * LD;
  T* vs = ks + BT * LD;
  int* segq = reinterpret_cast<int*>(vs + BT * LD);
  int* segk = segq + BT;
  float* scratch = reinterpret_cast<float*>(segk + 3 * BT);

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
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  load_tile<T, D, BT, NTHREADS>(qs, qg + q0 * p.sq.s, p.sq.s);
  load_tile<T, D, BT, NTHREADS>(dos, dog + q0 * p.sdo.s, p.sdo.s);
  if (seg) {
    for (int i = threadIdx.x; i < BT; i += NTHREADS)
      segq[i] = p.seg[static_cast<long long>(b) * p.seq + q0 + i];
  }
  const int lr0 = warp * 16 + g;
  const int lr1 = lr0 + 8;
  const long long stat = (static_cast<long long>(b) * p.heads + h) * p.seq;
  const float lse0 = p.lse[stat + q0 + lr0];
  const float lse1 = p.lse[stat + q0 + lr1];
  const float di0 = p.di[stat + q0 + lr0];
  const float di1 = p.di[stat + q0 + lr1];

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_kv = p.causal ? qt + 1 : p.seq / BT;
  const KvTiles<BAND, BT> tiles(p.window, p.sinks, q0);
  for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt)) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile<T, D, BT, NTHREADS>(ks, kg + k0 * p.sk.s, p.sk.s);
    load_tile<T, D, BT, NTHREADS>(vs, vg + k0 * p.sv.s, p.sv.s);
    if (seg) {
      for (int i = threadIdx.x; i < BT; i += NTHREADS)
        segk[i] = p.seg[static_cast<long long>(b) * p.seq + k0 + i];
    }
    __syncthreads();

    float pr[NT][4];
    Tile<T>::template abt<D, NT, LD>(qs + warp * 16 * LD, ks, pr, wscratch);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = n * 8 + 2 * t + (e & 1);
        const int lr = e < 2 ? lr0 : lr1;
        float x = pr[n][e] * p.scale;
        if (!visible<BAND>(q0 + lr, k0 + lc, p.causal, p.window,
                           p.sinks, seg, seg ? segq[lr] : 0,
                           seg ? segk[lc] : 0))
          x += kMaskValue;
        pr[n][e] = expf(x - (e < 2 ? lse0 : lse1));
      }
    }
    float ds[NT][4];
    Tile<T>::template abt<D, NT, LD>(dos + warp * 16 * LD, vs, ds, wscratch);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      ds[n][0] = pr[n][0] * (ds[n][0] - di0) * p.scale;
      ds[n][1] = pr[n][1] * (ds[n][1] - di0) * p.scale;
      ds[n][2] = pr[n][2] * (ds[n][2] - di1) * p.scale;
      ds[n][3] = pr[n][3] * (ds[n][3] - di1) * p.scale;
    }
    Tile<T>::template pb<D, NT, LD>(ds, ks, dq, wscratch);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const int r0 = q0 + lr0;
  const int r1 = q0 + lr1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    dqg[r0 * p.sdq.s + c] = ttd::from_f32<T>(dq[n][0]);
    dqg[r0 * p.sdq.s + c + 1] = ttd::from_f32<T>(dq[n][1]);
    dqg[r1 * p.sdq.s + c] = ttd::from_f32<T>(dq[n][2]);
    dqg[r1 * p.sdq.s + c + 1] = ttd::from_f32<T>(dq[n][3]);
  }
}

template <typename T, int D, bool BAND>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>(4);
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.seq;
  flash_bwd_di_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           stream>>>(p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(p.seq / Cfg<T>::kBt, p.kv_heads, p.batch);
  flash_bwd_dkv_kernel<T, D, BAND>
      <<<grid_kv, Cfg<T>::kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(p.seq / Cfg<T>::kBt, p.heads, p.batch);
  flash_bwd_dq_kernel<T, D, BAND>
      <<<grid_q, Cfg<T>::kThreads, bytes, stream>>>(p);
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

Params bwd_params(const void* q, const void* k, const void* v,
                  const void* o, const void* lse, const void* dout, void* dq,
                  void* dk, void* dv, void* di, const void* seg,
                  const long long* strides, int batch, int heads,
                  int kv_heads, int seq) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.di = static_cast<float*>(di);
  p.seg = static_cast<const int*>(seg);
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.sdo = {strides[12], strides[13], strides[14]};
  p.sdq = {strides[15], strides[16], strides[17]};
  p.sdk = {strides[18], strides[19], strides[20]};
  p.sdv = {strides[21], strides[22], strides[23]};
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

// Operands as ttd_flash_attention_fwd, plus dout [B, H, S, D] and the
// gradients dq [B, H, S, D], dk, dv [B, KVH, S, D] (element strides, D
// contiguous, 16-byte aligned rows); lse from the forward; di: [B, H, S]
// f32 scratch.  ``strides`` holds 24 element strides: (b, h, s) of q, k,
// v, o, dout, dq, dk, dv.  Launches three kernels; returns the first
// CUDA error (0 on success).
extern "C" int ttd_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* di, const void* seg, const long long* strides, int batch,
    int heads, int kv_heads, int seq, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  using namespace ttd_flash;
  Params p = bwd_params(q, k, v, o, lse, dout, dq, dk, dv, di, seg, strides,
                        batch, heads, kv_heads, seq);
  p.scale = scale;
  p.causal = causal;
  return run<false>(p, head_dim, dtype, stream);
}

// K7: operands as ttd_flash_attention_bwd (q pre-scaled, dq the gradient
// of that scaled q), the band as ttd_splash_attention_fwd.
extern "C" int ttd_splash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* di, const void* seg, const long long* strides, int batch,
    int heads, int kv_heads, int seq, int head_dim, int window, int sinks,
    int dtype, void* stream) {
  using namespace ttd_flash;
  if (window < 1 || sinks < 0 || sinks > window)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = bwd_params(q, k, v, o, lse, dout, dq, dk, dv, di, seg, strides,
                        batch, heads, kv_heads, seq);
  p.scale = 1.f;
  p.causal = 1;
  p.window = window < seq ? window : seq;
  p.sinks = sinks < seq ? sinks : seq;
  return run<true>(p, head_dim, dtype, stream);
}
