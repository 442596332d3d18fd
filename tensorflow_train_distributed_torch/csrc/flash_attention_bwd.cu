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
//   dO and writing dq, dk, dv once); bytes for f32 at BERT's and
//   Transformer-big's S 128-256, against six bf16 products a product.
//
// Design: the library's split, so no atomics and a deterministic result
//   (two runs give equal gradients bit for bit), in three launches:
//   (1) flash_bwd_di: di = rowsum(dO * O) in f32, 16-byte loads, a group
//       of lanes a row.
//   (2) dk/dv: one block per (kv tile, kv head, batch) keeps dK and dV in
//       f32 registers while it loops over the GQA group's heads and, per
//       head, over the q tiles from the diagonal on (causal) -- the TPU's
//       sequential q axis.  The group's contributions are summed before
//       one rounding, so no repeated K/V copy is needed.  blockIdx.x runs
//       the kv tiles in ascending order: the early tiles (and the sink
//       tiles) walk the most q tiles and start first.
//   (3) dq: one block per (q tile, head, batch) loops over the kv tiles up
//       to the diagonal, keeping dQ in f32 registers; q tiles in reverse
//       when causal, the longest first.
//   The probabilities are recomputed in both (2) and (3): 14 S*S*D units
//   of work against the bound's 10, the price of no atomics.
//
// Bodies, chosen statically as in the forward (``body()``):
// wgmma body (bf16, D 64 and 128; flash_bwd_dkv_wgmma_kernel,
//   flash_bwd_dq_wgmma_kernel), the forward's building blocks
//   (hopper.cuh): 384 threads, a producer warpgroup that feeds a 2-stage
//   TMA ring through tensor maps of q, k, v and dO, two consumer
//   warpgroups of 64 rows on wgmma.  dk/dv: 128 keys a block; K and V
//   loaded once, the ring carries 64-row Q and dO tiles with their lse
//   and di rows (bulk copies); S^T = K.Q^T and dP^T = V.dO^T with both
//   operands K-major, then dV += P^T.dO and dK += dS^T.Q with P^T and
//   dS^T rounded to bf16 in registers and dO, Q read MN-major (transpose
//   bit).  dq: 128 q rows a block, Q and dO loaded once, the ring carries
//   64-row K and V tiles; S = Q.K^T, dP = dO.V^T, dQ += dS.K (K
//   MN-major).  The two score products of a tile are committed as two
//   wgmma groups, so the exponentials run while the second (dP^T or dP)
//   is on the tensor cores, and in dk/dv dS^T is formed while dV is.
//   Masks only on boundary tiles, empty tiles skipped, as in the
//   forward; dK, dV and dQ rounded once and stored through shared memory
//   with 16-byte stores.
//   Left for later: di fused into the dq kernel's prologue, overlap of
//   one tile's elementwise work with the next tile's products, a deeper
//   ring.
// split body (f32, D 64 and 128; flash_bwd_dkv_split_kernel,
//   flash_bwd_dq_split_kernel): the wgmma body's roles on the forward's
//   split (flash_common.cuh: six bf16 term products a product).  The
//   streamed tiles (dk/dv: Q and dO; dq: K and V) arrive as f32 and
//   warps 9-11 split each stage in place into hi, mid and lo planes; the
//   consumer warpgroups split the resident tiles (K and V; Q and dO) once
//   an item.  S^T, dP^T (S, dP) as six products from shared memory; then
//   dS^T, and P^T and dS^T split in registers; dV, dK (dQ) by 64-column
//   halves through a fresh accumulator added with rounded f32 adds, so
//   the tensor core's truncated sums do not pile up over a long sequence.
//   At D 64 a block holds 128 resident rows, 64 for each warpgroup, and
//   the ring two stages.  At D 128 a 128-row resident tile of terms would
//   not fit beside a stage: a block holds 64 resident rows, both
//   warpgroups compute the tile's scores and each owns 64 of the output's
//   128 columns, one stage.  Outputs in f32 straight from registers.  As
//   in the forward, a block an SM walks the work items with the ring
//   running on across them.
// mma.sync body (bf16, D 256) and FMA body (f32 at D 256, or forced):
//   flash_bwd_dkv_kernel, flash_bwd_dq_kernel, 64-row tiles (32 for f32),
//   one warp per 16 rows, tiles staged by the whole block, one tile in
//   flight.
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

// di = rowsum(dO * O) in f32.  A row's 16-byte chunks are read by a
// group of up to 32 lanes, one chunk each a step, and summed by shuffles
// within the group: several rows a warp at D 64 (f32: 16 lanes a row).
template <typename T, int D>
struct DiShape {
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // a chunk's
  static constexpr int kChunks = D / kEpc;                        // a row's
  static constexpr int kLanes = kChunks < 32 ? kChunks : 32;      // a row's
  static constexpr int kRows = 256 / kLanes;                      // a block's
};

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_di_kernel(Params p) {
  constexpr int kEpc = DiShape<T, D>::kEpc;
  constexpr int kChunks = DiShape<T, D>::kChunks;
  constexpr int kLanes = DiShape<T, D>::kLanes;
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.seq;
  const long long row = static_cast<long long>(blockIdx.x) *
                            DiShape<T, D>::kRows + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
    const int s = static_cast<int>(row % p.seq);
    const int h = static_cast<int>((row / p.seq) % p.heads);
    const int b = static_cast<int>(row / (static_cast<long long>(p.seq) *
                                          p.heads));
    const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h +
                 s * p.so.s;
    const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b +
                 h * p.sdo.h + s * p.sdo.s;
    for (int c = lane; c < kChunks; c += kLanes) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c * kEpc);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + c * kEpc);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < kEpc; ++e)
        acc += ttd::to_f32(oe[e]) * ttd::to_f32(ge[e]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) p.di[row] = acc;
}

template <typename T, int D>
cudaError_t launch_di(const Params& p, cudaStream_t stream) {
  constexpr int kRows = DiShape<T, D>::kRows;
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.seq;
  flash_bwd_di_kernel<T, D><<<static_cast<unsigned>((rows + kRows - 1) /
                                                    kRows),
                              256, 0, stream>>>(p);
  return cudaGetLastError();
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

// The wgmma bodies' shapes.  dk/dv: 128 keys a block (two consumer
// warpgroups of 64), q tiles of 64 rows with their lse and di rows in a
// ring.  dq: 128 q rows a block, kv tiles of 64 rows in a ring.  (128-row
// streamed tiles at D 64 measured slower; PERF.md §6.)  S is a
// multiple of 64, so no streamed tile is ragged.
template <int D>
struct BwdWg {
  static constexpr int kBk = 128;
  static constexpr int kBq = 64;
  static constexpr int kDqBq = 128;
  static constexpr int kDqBk = 64;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 384;
  static constexpr int kDkvSmem = 1024 +
      (2 * kBk * D + 2 * kStages * kBq * D) * 2 + 2 * kStages * kBq * 4 +
      (2 * kStages + 1) * 8;
  static constexpr int kDqSmem = 1024 +
      (2 * kDqBq * D + 2 * kStages * kDqBk * D) * 2 + (2 * kStages + 1) * 8;
};

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               Params p) {
  using C = BwdWg<D>;
  namespace hw = ttd_hopper;
  constexpr int kQ = C::kBq * D;           // elements of a Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + C::kBk * D;
  bf16* qdo = vs + C::kBk * D;             // stage s: Q at 2s, dO at 2s + 1
  float* stats = reinterpret_cast<float*>(qdo + 2 * C::kStages * kQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * C::kStages *
                                               C::kBq);
  uint64_t* empty = full + C::kStages;
  uint64_t* kvbar = empty + C::kStages;

  const int k0 = blockIdx.x * C::kBk;      // longest first: the early keys
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.heads / p.kv_heads;
  const int k_last = min(k0 + C::kBk, p.seq) - 1;
  const int n_q = p.seq / C::kBq;
  const int qt_first = p.causal ? k0 / C::kBq : 0;
  const int qt_end = !BAND || k0 < p.sinks
                         ? n_q
                         : min(n_q, (k_last + p.window - 1) / C::kBq + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 256);
    }
    hw::mbar_init(kvbar, 1);
    hw::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: K and V once, then Q, dO, lse and di of each (head of the
    // group, q tile) into the ring.
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      hw::mbar_expect_tx(kvbar, 2 * C::kBk * D * 2);
      hw::tma_load_rows<C::kBk, D>(ks, &tk, kvbar, k0, kvh, b);
      hw::tma_load_rows<C::kBk, D>(vs, &tv, kvbar, k0, kvh, b);
      int i = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int h = kvh * rep + hh;
        const long long stat = (static_cast<long long>(b) * p.heads + h) *
                               p.seq;
        for (int qt = qt_first; qt < qt_end; ++qt, ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
          hw::mbar_expect_tx(&full[s], 2 * kQ * 2 + 2 * C::kBq * 4);
          bf16* qs = qdo + 2 * s * kQ;
          hw::tma_load_rows<C::kBq, D>(qs, &tq, &full[s], qt * C::kBq, h, b);
          hw::tma_load_rows<C::kBq, D>(qs + kQ, &tdo, &full[s], qt * C::kBq,
                                       h, b);
          float* st = stats + 2 * s * C::kBq;
          hw::bulk_load(st, p.lse + stat + qt * C::kBq, C::kBq * 4, &full[s]);
          hw::bulk_load(st + C::kBq, p.di + stat + qt * C::kBq, C::kBq * 4,
                        &full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys [w0, w0 + 64).
  hw::regs_inc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int w0 = k0 + 64 * wg;
  const int kr0 = w0 + 16 * warp + g;      // this thread's keys
  const int kr1 = kr0 + 8;
  const bool seg = p.seg != nullptr;
  const int* segb = p.seg + static_cast<long long>(b) * p.seq;
  const int sk0 = seg ? segb[min(kr0, p.seq - 1)] : 0;
  const int sk1 = seg ? segb[min(kr1, p.seq - 1)] : 0;
  const float sl2 = p.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float pt[C::kBq / 2], dst[C::kBq / 2];   // P^T and dP^T, then dS^T
#pragma unroll
  for (int i = 0; i < C::kBq / 2; ++i) pt[i] = dst[i] = 0.f;

  hw::mbar_wait(kvbar, 0);
  int i = 0;
  for (int hh = 0; hh < rep; ++hh) {
    for (int qt = qt_first; qt < qt_end; ++qt, ++i) {
      const int s = i % C::kStages;
      hw::mbar_wait(&full[s], (i / C::kStages) & 1);
      const int q0 = qt * C::kBq;
      if (!tile_empty<BAND>(p, q0, q0 + C::kBq - 1, w0, w0 + 63)) {
        const bf16* qs = qdo + 2 * s * kQ;
        const bf16* dos = qs + kQ;
        const float* lse_s = stats + 2 * s * C::kBq;
        const float* di_s = lse_s + C::kBq;
        // S^T and dP^T in two groups: P^T (the exponentials) is computed
        // while dP^T is on the tensor cores, and dS^T while dV is.
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss<C::kBq>(pt, hw::desc_k<C::kBk>(ks, 64 * wg, kk),
                               hw::desc_k<C::kBq>(qs, 0, kk), kk > 0);
        hw::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss<C::kBq>(dst, hw::desc_k<C::kBk>(vs, 64 * wg, kk),
                               hw::desc_k<C::kBq>(dos, 0, kk), kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<1>();               // S^T is in
        hw::reg_fence<C::kBq / 2>(pt);
        if (tile_masked<BAND>(p, q0, q0 + C::kBq - 1, w0, w0 + 63)) {
#pragma unroll
          for (int j = 0; j < C::kBq / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t + (e & 1);   // query in the tile
              // An invisible pair's probability is exactly 0 (its score
              // would get + kMaskValue): set, not computed.
              pt[4 * j + e] =
                  visible<BAND>(q0 + qc, e < 2 ? kr0 : kr1, p.causal,
                                p.window, p.sinks, seg,
                                seg ? segb[q0 + qc] : 0, e < 2 ? sk0 : sk1)
                      ? exp2f(pt[4 * j + e] * sl2 - lse_s[qc] * kLog2e)
                      : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < C::kBq / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t + (e & 1);
              pt[4 * j + e] =
                  exp2f(pt[4 * j + e] * sl2 - lse_s[qc] * kLog2e);
            }
          }
        }
        uint32_t pf[C::kBq / 16][4], sf[C::kBq / 16][4];
#pragma unroll
        for (int kk = 0; kk < C::kBq / 16; ++kk) frag_a(pt, kk, pf[kk]);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kBq / 16; ++kk)
          hw::wgmma_rs<D>(dv, pf[kk], hw::desc_mn<C::kBq>(dos, kk));
        hw::wgmma_commit();
        hw::wgmma_wait<1>();               // dP^T is in; dV may still run
        hw::reg_fence<C::kBq / 2>(dst);
#pragma unroll
        for (int j = 0; j < C::kBq / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            dst[4 * j + e] =
                pt[4 * j + e] * (dst[4 * j + e] - di_s[qc]) * p.scale;
          }
        }
#pragma unroll
        for (int kk = 0; kk < C::kBq / 16; ++kk) frag_a(dst, kk, sf[kk]);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kBq / 16; ++kk)
          hw::wgmma_rs<D>(dk, sf[kk], hw::desc_mn<C::kBq>(qs, kk));
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::reg_fence<D / 2>(dk);
        hw::reg_fence<D / 2>(dv);
#pragma unroll
        for (int kk = 0; kk < C::kBq / 16; ++kk)   // live until dV is done
          asm volatile("" : "+r"(pf[kk][0]), "+r"(pf[kk][1]),
                       "+r"(pf[kk][2]), "+r"(pf[kk][3]) :: "memory");
      }
      hw::mbar_arrive(&empty[s]);
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
  store_rows<D>(dk, 1.f, 1.f, ks + 64 * wg * 64, C::kBk * 64, dkg, p.sdk.s,
                w0, p.seq, wg);
  store_rows<D>(dv, 1.f, 1.f, vs + 64 * wg * 64, C::kBk * 64, dvg, p.sdv.s,
                w0, p.seq, wg);
}

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              Params p) {
  using C = BwdWg<D>;
  namespace hw = ttd_hopper;
  constexpr int kQ = C::kDqBq * D;
  constexpr int kKv = C::kDqBk * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* dos = qs + kQ;
  bf16* kvs = dos + kQ;                    // stage s: K at 2s, V at 2s + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + 2 * C::kStages * kKv);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int n_qt = (p.seq + C::kDqBq - 1) / C::kDqBq;
  const int qt = p.causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * C::kDqBq;
  const int q_end = min(q0 + C::kDqBq, p.seq);
  const int n_kv = p.causal ? (q_end - 1) / C::kDqBk + 1 : p.seq / C::kDqBk;
  const KvTiles<BAND, C::kDqBk> tiles(p.window, p.sinks, q0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 256);
    }
    hw::mbar_init(qbar, 1);
    hw::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      hw::mbar_expect_tx(qbar, 2 * kQ * 2);
      hw::tma_load_rows<C::kDqBq, D>(qs, &tq, qbar, q0, h, b);
      hw::tma_load_rows<C::kDqBq, D>(dos, &tdo, qbar, q0, h, b);
      int i = 0;
      for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt), ++i) {
        const int s = i % C::kStages;
        hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], 2 * kKv * 2);
        bf16* ks = kvs + 2 * s * kKv;
        hw::tma_load_rows<C::kDqBk, D>(ks, &tk, &full[s], kt * C::kDqBk, kvh,
                                       b);
        hw::tma_load_rows<C::kDqBk, D>(ks + kKv, &tv, &full[s],
                                       kt * C::kDqBk, kvh, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [w0, w0 + 64).
  hw::regs_inc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int w0 = q0 + 64 * wg;
  const int r0 = w0 + 16 * warp + g;
  const int r1 = r0 + 8;
  const bool seg = p.seg != nullptr;
  const int* segb = p.seg + static_cast<long long>(b) * p.seq;
  const int sq0 = seg ? segb[min(r0, p.seq - 1)] : 0;
  const int sq1 = seg ? segb[min(r1, p.seq - 1)] : 0;
  const long long stat = (static_cast<long long>(b) * p.heads + h) * p.seq;
  const float lse0 = r0 < p.seq ? p.lse[stat + r0] * kLog2e : 0.f;
  const float lse1 = r1 < p.seq ? p.lse[stat + r1] * kLog2e : 0.f;
  const float di0 = r0 < p.seq ? p.di[stat + r0] : 0.f;
  const float di1 = r1 < p.seq ? p.di[stat + r1] : 0.f;
  const float sl2 = p.scale * kLog2e;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[C::kDqBk / 2], dp[C::kDqBk / 2];   // S and dP, then dS
#pragma unroll
  for (int i = 0; i < C::kDqBk / 2; ++i) sc[i] = dp[i] = 0.f;

  hw::mbar_wait(qbar, 0);
  int i = 0;
  for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt), ++i) {
    const int s = i % C::kStages;
    hw::mbar_wait(&full[s], (i / C::kStages) & 1);
    const int k0 = kt * C::kDqBk;
    if (!tile_empty<BAND>(p, w0, w0 + 63, k0, k0 + C::kDqBk - 1)) {
      const bf16* ks = kvs + 2 * s * kKv;
      const bf16* vs = ks + kKv;
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hw::wgmma_ss<C::kDqBk>(sc, hw::desc_k<C::kDqBq>(qs, 64 * wg, kk),
                               hw::desc_k<C::kDqBk>(ks, 0, kk), kk > 0);
      hw::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hw::wgmma_ss<C::kDqBk>(dp, hw::desc_k<C::kDqBq>(dos, 64 * wg, kk),
                               hw::desc_k<C::kDqBk>(vs, 0, kk), kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                 // S is in: P while dP runs
      hw::reg_fence<C::kDqBk / 2>(sc);
      if (tile_masked<BAND>(p, w0, w0 + 63, k0, k0 + C::kDqBk - 1)) {
#pragma unroll
        for (int j = 0; j < C::kDqBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            sc[4 * j + e] =
                visible<BAND>(e < 2 ? r0 : r1, col, p.causal, p.window,
                              p.sinks, seg, e < 2 ? sq0 : sq1,
                              seg ? segb[col] : 0)
                    ? exp2f(sc[4 * j + e] * sl2 - (e < 2 ? lse0 : lse1))
                    : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::kDqBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] =
                exp2f(sc[4 * j + e] * sl2 - (e < 2 ? lse0 : lse1));
        }
      }
      hw::wgmma_wait<0>();                 // dP is in
      hw::reg_fence<C::kDqBk / 2>(dp);
#pragma unroll
      for (int j = 0; j < C::kDqBk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] *
                          (dp[4 * j + e] - (e < 2 ? di0 : di1)) * p.scale;
      }
      uint32_t sf[C::kDqBk / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::kDqBk / 16; ++kk) frag_a(dp, kk, sf[kk]);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kDqBk / 16; ++kk)
        hw::wgmma_rs<D>(dq, sf[kk], hw::desc_mn<C::kDqBk>(ks, kk));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::reg_fence<D / 2>(dq);
    }
    hw::mbar_arrive(&empty[s]);
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  store_rows<D>(dq, 1.f, 1.f, qs + 64 * wg * 64, C::kDqBq * 64, dqg, p.sdq.s,
                w0, p.seq, wg);
}

template <int D, bool BAND>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using C = BwdWg<D>;
  namespace hw = ttd_hopper;
  CUtensorMap tq, tk, tv, tdo;
  if (!hw::make_map(&tq, p.q, p.sq.b, p.sq.h, p.sq.s, p.batch, p.heads,
                    p.seq, D) ||
      !hw::make_map(&tk, p.k, p.sk.b, p.sk.h, p.sk.s, p.batch, p.kv_heads,
                    p.seq, D) ||
      !hw::make_map(&tv, p.v, p.sv.b, p.sv.h, p.sv.s, p.batch, p.kv_heads,
                    p.seq, D) ||
      !hw::make_map(&tdo, p.dout, p.sdo.b, p.sdo.h, p.sdo.s, p.batch,
                    p.heads, p.seq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_di<bf16, D>(p, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((p.seq + C::kBk - 1) / C::kBk, p.kv_heads, p.batch);
  flash_bwd_dkv_wgmma_kernel<D, BAND>
      <<<grid_kv, C::kThreads, C::kDkvSmem, stream>>>(tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((p.seq + C::kDqBq - 1) / C::kDqBq, p.heads, p.batch);
  flash_bwd_dq_wgmma_kernel<D, BAND>
      <<<grid_q, C::kThreads, C::kDqSmem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// The split body's shapes, tiles of bf16 terms (split_bytes: 1.5x the f32
// tile).  dk/dv: K and V resident, 64-row Q and dO tiles with their lse
// and di rows in a ring; dq: Q and dO resident, 64-row K and V tiles in a
// ring.  At D 64 a block holds 128 resident rows, 64 for each consumer
// warpgroup, in two stages.  At D 128 a 128-row resident tile would not
// fit beside a stage: a block holds 64 resident rows, both warpgroups
// compute the tile's scores, and each owns 64 of the outputs' 128 columns
// (kColSplit), in one stage.  A block walks several work items (one an
// SM), the ring running on across them.
template <int D>
struct BwdSplit {
  static constexpr bool kColSplit = D == 128;
  static constexpr int kRows = kColSplit ? 64 : 128;   // resident, a block
  static constexpr int kTile = 64;                      // streamed
  static constexpr int kCols = kColSplit ? 64 : D;      // a warpgroup's
  static constexpr int kStages = kColSplit ? 1 : 2;
  static constexpr int kThreads = 384;
  static constexpr int kResBytes = split_bytes<kRows, D>();
  static constexpr int kTileBytes = split_bytes<kTile, D>();
  static constexpr int kBars = 3 * kStages + 2;
  static constexpr int kDqSmem =
      1024 + 2 * kResBytes + 2 * kStages * kTileBytes + kBars * 8;
  static constexpr int kDkvSmem = kDqSmem + 2 * kStages * kTile * 4;
  // The rows [row0, row0 + 64) of the resident tile warpgroup wg works on,
  // and the first of its output columns.
  static __device__ __forceinline__ int row0(int wg) {
    return kColSplit ? 0 : 64 * wg;
  }
  static __device__ __forceinline__ int col0(int wg) {
    return kColSplit ? 64 * wg : 0;
  }
  // Splits this warpgroup's share of a resident tile that has landed and
  // waits until every warpgroup that reads it has split its share.
  static __device__ __forceinline__ void split_resident(unsigned char* a,
                                                        unsigned char* b,
                                                        int wg, int tid) {
    const int n = kColSplit ? 32 : 64;
    split_rows<kRows, D>(a, n * wg, n, tid, 128);
    split_rows<kRows, D>(b, n * wg, n, tid, 128);
    if constexpr (kColSplit) ttd_hopper::bar_sync(1, 256);
    else ttd_hopper::bar_sync(1 + wg, 128);
  }
};

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               Params p) {
  using C = BwdSplit<D>;
  namespace hw = ttd_hopper;
  constexpr int kBq = C::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = base;                // resident K, then V
  unsigned char* vs = ks + C::kResBytes;
  unsigned char* qdo = vs + C::kResBytes;  // stage s: Q at 2s, dO at 2s + 1
  float* stats = reinterpret_cast<float*>(qdo + 2 * C::kStages *
                                          C::kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * C::kStages * kBq);
  uint64_t* empty = full + C::kStages;
  uint64_t* loaded = empty + C::kStages;   // the f32 stage has landed
  uint64_t* rfull = loaded + C::kStages;   // K and V have landed
  uint64_t* rempty = rfull + 1;            // ... and are free again

  const int rep = p.heads / p.kv_heads;
  const int n_kt = (p.seq + C::kRows - 1) / C::kRows;
  const int n_items = n_kt * p.kv_heads * p.batch;
  const int n_q = p.seq / kBq;
  // Work item idx: kv tile (the early keys, which walk the most q tiles,
  // first), kv head and batch row, and the q tiles it visits.
  struct Work {
    int k0, kvh, b, qt_first, qt_end;
  };
  auto work = [&](int idx) {
    const Item it = item_at(idx, n_kt, p.kv_heads);
    const int k0 = it.x * C::kRows;
    const int k_last = min(k0 + C::kRows, p.seq) - 1;
    return Work{k0, it.y, it.z, p.causal ? k0 / kBq : 0,
                !BAND || k0 < p.sinks
                    ? n_q
                    : min(n_q, (k_last + p.window - 1) / kBq + 1)};
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 96);
      hw::mbar_init(&empty[s], 256);
      hw::mbar_init(&loaded[s], 1);
    }
    hw::mbar_init(rfull, 1);
    hw::mbar_init(rempty, 256);
    hw::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: K and V of each item once, then Q, dO, lse and di of each
    // (head of the group, q tile) into the ring, landing on ``loaded``;
    // warps 9-11 split each stage's Q and dO in place, then arrive on
    // ``full``.
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        hw::mbar_wait(rempty, (n & 1) ^ 1);
        hw::mbar_expect_tx(rfull, 2 * C::kRows * D * 4);
        tma_load_split<C::kRows, D>(ks, &tk, rfull, w.k0, w.kvh, w.b);
        tma_load_split<C::kRows, D>(vs, &tv, rfull, w.k0, w.kvh, w.b);
        for (int hh = 0; hh < rep; ++hh) {
          const int h = w.kvh * rep + hh;
          const long long stat =
              (static_cast<long long>(w.b) * p.heads + h) * p.seq;
          for (int qt = w.qt_first; qt < w.qt_end; ++qt, ++i) {
            const int s = i % C::kStages;
            hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
            hw::mbar_expect_tx(&loaded[s], 2 * kBq * D * 4 + 2 * kBq * 4);
            unsigned char* qs = qdo + 2 * s * C::kTileBytes;
            tma_load_split<kBq, D>(qs, &tq, &loaded[s], qt * kBq, h, w.b);
            tma_load_split<kBq, D>(qs + C::kTileBytes, &tdo, &loaded[s],
                                   qt * kBq, h, w.b);
            float* st = stats + 2 * s * kBq;
            hw::bulk_load(st, p.lse + stat + qt * kBq, kBq * 4, &loaded[s]);
            hw::bulk_load(st + kBq, p.di + stat + qt * kBq, kBq * 4,
                          &loaded[s]);
          }
        }
      }
    } else if (threadIdx.x >= 288) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        const int end = i + rep * (w.qt_end - w.qt_first);
        for (; i < end; ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&loaded[s], (i / C::kStages) & 1);
          unsigned char* qs = qdo + 2 * s * C::kTileBytes;
          split_rows<kBq, D>(qs, 0, kBq, threadIdx.x - 288, 96);
          split_rows<kBq, D>(qs + C::kTileBytes, 0, kBq, threadIdx.x - 288,
                             96);
          hw::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg works on keys [w0, w0 + 64) of each item and
  // owns dK and dV there, in columns [c0, c0 + kCols).
  hw::regs_inc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const bool seg = p.seg != nullptr;
  const float sl2 = p.scale * kLog2e;
  const int c0 = C::col0(wg);

  float dk[C::kCols / 2], dv[C::kCols / 2];
  float pt[kBq / 2], dst[kBq / 2];         // P^T and dP^T, then dS^T
  SplitFrags<kBq / 16> f;                  // P^T's terms, then dS^T's
  float chunk[32];                         // one tile's dV or dK, by half
#pragma unroll
  for (int j = 0; j < kBq / 2; ++j) pt[j] = dst[j] = 0.f;

  int i = 0;
  for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
    const Work w = work(idx);
    const int b = w.b;
    const int w0 = w.k0 + C::row0(wg);
    const int kr0 = w0 + 16 * warp + g;      // this thread's keys
    const int kr1 = kr0 + 8;
    const int* segb = p.seg + static_cast<long long>(b) * p.seq;
    const int sk0 = seg ? segb[min(kr0, p.seq - 1)] : 0;
    const int sk1 = seg ? segb[min(kr1, p.seq - 1)] : 0;
#pragma unroll
    for (int j = 0; j < C::kCols / 2; ++j) dk[j] = dv[j] = 0.f;

    hw::mbar_wait(rfull, n & 1);
    C::split_resident(ks, vs, wg, tid);
    for (int hh = 0; hh < rep; ++hh) {
      for (int qt = w.qt_first; qt < w.qt_end; ++qt, ++i) {
        const int s = i % C::kStages;
        hw::mbar_wait(&full[s], (i / C::kStages) & 1);
        const int q0 = qt * kBq;
        if (!tile_empty<BAND>(p, q0, q0 + kBq - 1, w0, w0 + 63)) {
          const unsigned char* qs = qdo + 2 * s * C::kTileBytes;
          const unsigned char* dos = qs + C::kTileBytes;
          const float* lse_s = stats + 2 * s * kBq;
          const float* di_s = lse_s + kBq;
          // S^T and dP^T in two groups: P^T (the exponentials) is computed
          // while dP^T is on the tensor cores.
          hw::wgmma_fence();
          wgmma_ss_split<kBq, D>(
              pt,
              [&](int pl, int kk) {
                return desc_k_split<C::kRows>(ks, pl, C::row0(wg), kk);
              },
              [&](int pl, int kk) { return desc_k_split<kBq>(qs, pl, 0, kk); },
              0);
          hw::wgmma_commit();
          wgmma_ss_split<kBq, D>(
              dst,
              [&](int pl, int kk) {
                return desc_k_split<C::kRows>(vs, pl, C::row0(wg), kk);
              },
              [&](int pl, int kk) {
                return desc_k_split<kBq>(dos, pl, 0, kk);
              },
              0);
          hw::wgmma_commit();
          hw::wgmma_wait<1>();               // S^T is in
          hw::reg_fence<kBq / 2>(pt);
          if (tile_masked<BAND>(p, q0, q0 + kBq - 1, w0, w0 + 63)) {
#pragma unroll
            for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qc = 8 * j + 2 * t + (e & 1);   // query in the tile
                // An invisible pair's probability is exactly 0 (its score
                // would get + kMaskValue): set, not computed.
                pt[4 * j + e] =
                    visible<BAND>(q0 + qc, e < 2 ? kr0 : kr1, p.causal,
                                  p.window, p.sinks, seg,
                                  seg ? segb[q0 + qc] : 0, e < 2 ? sk0 : sk1)
                        ? exp2f(pt[4 * j + e] * sl2 - lse_s[qc] * kLog2e)
                        : 0.f;
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qc = 8 * j + 2 * t + (e & 1);
                pt[4 * j + e] =
                    exp2f(pt[4 * j + e] * sl2 - lse_s[qc] * kLog2e);
              }
            }
          }
          hw::wgmma_wait<0>();               // dP^T is in
          hw::reg_fence<kBq / 2>(dst);
#pragma unroll
          for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t + (e & 1);
              dst[4 * j + e] =
                  pt[4 * j + e] * (dst[4 * j + e] - di_s[qc]) * p.scale;
            }
          }
          split_frags(pt, f);
          wgmma_rs_split_add<C::kCols>(dv, chunk, f,
                                       [&](int pl, int kk, int hf) {
            return desc_mn_split<kBq>(dos, pl, kk, hf + c0 / 64);
          });
          frag_fence(f);
          split_frags(dst, f);
          wgmma_rs_split_add<C::kCols>(dk, chunk, f,
                                       [&](int pl, int kk, int hf) {
            return desc_mn_split<kBq>(qs, pl, kk, hf + c0 / 64);
          });
          frag_fence(f);
        }
        hw::mbar_arrive(&empty[s]);
      }
    }

    float* dkg = static_cast<float*>(p.dk) + b * p.sdk.b + w.kvh * p.sdk.h;
    float* dvg = static_cast<float*>(p.dv) + b * p.sdv.b + w.kvh * p.sdv.h;
    store_rows_f32<C::kCols>(dk, 1.f, 1.f, dkg + c0, p.sdk.s, w0, p.seq);
    store_rows_f32<C::kCols>(dv, 1.f, 1.f, dvg + c0, p.sdv.s, w0, p.seq);
    hw::mbar_arrive(rempty);
  }
}

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              Params p) {
  using C = BwdSplit<D>;
  namespace hw = ttd_hopper;
  constexpr int kBk = C::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;                // resident Q, then dO
  unsigned char* dos = qs + C::kResBytes;
  unsigned char* kvs = dos + C::kResBytes;   // stage s: K at 2s, V 2s+1
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + 2 * C::kStages *
                                               C::kTileBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* loaded = empty + C::kStages;   // the f32 stage has landed
  uint64_t* rfull = loaded + C::kStages;   // Q and dO have landed
  uint64_t* rempty = rfull + 1;            // ... and are free again

  const int n_qt = (p.seq + C::kRows - 1) / C::kRows;
  const int n_items = n_qt * p.heads * p.batch;
  // Work item idx: q tile (the longest first when causal), head and batch
  // row, its kv tiles.
  struct Work {
    int h, b, kvh, q0, n_kv;
  };
  auto work = [&](int idx) {
    const Item it = item_at(idx, n_qt, p.heads);
    const int qt = p.causal ? n_qt - 1 - it.x : it.x;
    const int q0 = qt * C::kRows;
    const int q_end = min(q0 + C::kRows, p.seq);
    return Work{it.y, it.z, it.y / (p.heads / p.kv_heads), q0,
                p.causal ? (q_end - 1) / kBk + 1 : p.seq / kBk};
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 96);
      hw::mbar_init(&empty[s], 256);
      hw::mbar_init(&loaded[s], 1);
    }
    hw::mbar_init(rfull, 1);
    hw::mbar_init(rempty, 256);
    hw::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        hw::mbar_wait(rempty, (n & 1) ^ 1);
        hw::mbar_expect_tx(rfull, 2 * C::kRows * D * 4);
        tma_load_split<C::kRows, D>(qs, &tq, rfull, w.q0, w.h, w.b);
        tma_load_split<C::kRows, D>(dos, &tdo, rfull, w.q0, w.h, w.b);
        const KvTiles<BAND, kBk> tiles(p.window, p.sinks, w.q0);
        for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
          hw::mbar_expect_tx(&loaded[s], 2 * kBk * D * 4);
          unsigned char* ks = kvs + 2 * s * C::kTileBytes;
          tma_load_split<kBk, D>(ks, &tk, &loaded[s], kt * kBk, w.kvh, w.b);
          tma_load_split<kBk, D>(ks + C::kTileBytes, &tv, &loaded[s],
                                 kt * kBk, w.kvh, w.b);
        }
      }
    } else if (threadIdx.x >= 288) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        const KvTiles<BAND, kBk> tiles(p.window, p.sinks, w.q0);
        for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&loaded[s], (i / C::kStages) & 1);
          unsigned char* ks = kvs + 2 * s * C::kTileBytes;
          split_rows<kBk, D>(ks, 0, kBk, threadIdx.x - 288, 96);
          split_rows<kBk, D>(ks + C::kTileBytes, 0, kBk, threadIdx.x - 288,
                             96);
          hw::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg works on q rows [w0, w0 + 64) of each item and
  // owns dQ there, in columns [c0, c0 + kCols).
  hw::regs_inc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const bool seg = p.seg != nullptr;
  const float sl2 = p.scale * kLog2e;
  const int c0 = C::col0(wg);

  float dq[C::kCols / 2];
  float sc[kBk / 2], dp[kBk / 2];          // S and dP, then dS
  SplitFrags<kBk / 16> f;                  // dS's terms
  float chunk[32];                         // one tile's dQ, by half
#pragma unroll
  for (int j = 0; j < kBk / 2; ++j) sc[j] = dp[j] = 0.f;

  int i = 0;
  for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
    const Work w = work(idx);
    const int w0 = w.q0 + C::row0(wg);
    const int r0 = w0 + 16 * warp + g;
    const int r1 = r0 + 8;
    const int* segb = p.seg + static_cast<long long>(w.b) * p.seq;
    const int sq0 = seg ? segb[min(r0, p.seq - 1)] : 0;
    const int sq1 = seg ? segb[min(r1, p.seq - 1)] : 0;
    const long long stat =
        (static_cast<long long>(w.b) * p.heads + w.h) * p.seq;
    const float lse0 = r0 < p.seq ? p.lse[stat + r0] * kLog2e : 0.f;
    const float lse1 = r1 < p.seq ? p.lse[stat + r1] * kLog2e : 0.f;
    const float di0 = r0 < p.seq ? p.di[stat + r0] : 0.f;
    const float di1 = r1 < p.seq ? p.di[stat + r1] : 0.f;
#pragma unroll
    for (int j = 0; j < C::kCols / 2; ++j) dq[j] = 0.f;

    hw::mbar_wait(rfull, n & 1);
    C::split_resident(qs, dos, wg, tid);
    const KvTiles<BAND, kBk> tiles(p.window, p.sinks, w.q0);
    for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
      const int s = i % C::kStages;
      hw::mbar_wait(&full[s], (i / C::kStages) & 1);
      const int k0 = kt * kBk;
      if (!tile_empty<BAND>(p, w0, w0 + 63, k0, k0 + kBk - 1)) {
        const unsigned char* ks = kvs + 2 * s * C::kTileBytes;
        const unsigned char* vs = ks + C::kTileBytes;
        hw::wgmma_fence();
        wgmma_ss_split<kBk, D>(
            sc,
            [&](int pl, int kk) {
              return desc_k_split<C::kRows>(qs, pl, C::row0(wg), kk);
            },
            [&](int pl, int kk) { return desc_k_split<kBk>(ks, pl, 0, kk); },
            0);
        hw::wgmma_commit();
        wgmma_ss_split<kBk, D>(
            dp,
            [&](int pl, int kk) {
              return desc_k_split<C::kRows>(dos, pl, C::row0(wg), kk);
            },
            [&](int pl, int kk) { return desc_k_split<kBk>(vs, pl, 0, kk); },
            0);
        hw::wgmma_commit();
        hw::wgmma_wait<1>();               // S is in: P while dP runs
        hw::reg_fence<kBk / 2>(sc);
        if (tile_masked<BAND>(p, w0, w0 + 63, k0, k0 + kBk - 1)) {
#pragma unroll
          for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * j + 2 * t + (e & 1);
              sc[4 * j + e] =
                  visible<BAND>(e < 2 ? r0 : r1, col, p.causal, p.window,
                                p.sinks, seg, e < 2 ? sq0 : sq1,
                                seg ? segb[col] : 0)
                      ? exp2f(sc[4 * j + e] * sl2 - (e < 2 ? lse0 : lse1))
                      : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] =
                  exp2f(sc[4 * j + e] * sl2 - (e < 2 ? lse0 : lse1));
          }
        }
        hw::wgmma_wait<0>();               // dP is in
        hw::reg_fence<kBk / 2>(dp);
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = sc[4 * j + e] *
                            (dp[4 * j + e] - (e < 2 ? di0 : di1)) * p.scale;
        }
        split_frags(dp, f);
        wgmma_rs_split_add<C::kCols>(dq, chunk, f,
                                     [&](int pl, int kk, int hf) {
          return desc_mn_split<kBk>(ks, pl, kk, hf + c0 / 64);
        });
        frag_fence(f);
      }
      hw::mbar_arrive(&empty[s]);
    }

    float* dqg = static_cast<float*>(p.dq) + w.b * p.sdq.b + w.h * p.sdq.h;
    store_rows_f32<C::kCols>(dq, 1.f, 1.f, dqg + c0, p.sdq.s, w0, p.seq);
    hw::mbar_arrive(rempty);
  }
}

template <int D, bool BAND>
int launch_split(const Params& p, cudaStream_t stream) {
  using C = BwdSplit<D>;
  namespace hw = ttd_hopper;
  CUtensorMap tq, tk, tv, tdo;
  if (!hw::make_map(&tq, p.q, p.sq.b, p.sq.h, p.sq.s, p.batch, p.heads,
                    p.seq, D, ttd::kF32) ||
      !hw::make_map(&tk, p.k, p.sk.b, p.sk.h, p.sk.s, p.batch, p.kv_heads,
                    p.seq, D, ttd::kF32) ||
      !hw::make_map(&tv, p.v, p.sv.b, p.sv.h, p.sv.s, p.batch, p.kv_heads,
                    p.seq, D, ttd::kF32) ||
      !hw::make_map(&tdo, p.dout, p.sdo.b, p.sdo.h, p.sdo.s, p.batch,
                    p.heads, p.seq, D, ttd::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_di<float, D>(p, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_split_kernel<D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kv_items = static_cast<long long>(
      (p.seq + C::kRows - 1) / C::kRows) * p.kv_heads * p.batch;
  flash_bwd_dkv_split_kernel<D, BAND>
      <<<split_blocks(kv_items), C::kThreads, C::kDkvSmem, stream>>>(
          tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_split_kernel<D, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_items = static_cast<long long>(
      (p.seq + C::kRows - 1) / C::kRows) * p.heads * p.batch;
  flash_bwd_dq_split_kernel<D, BAND>
      <<<split_blocks(q_items), C::kThreads, C::kDqSmem, stream>>>(
          tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool BAND>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>(4);
  cudaError_t err = launch_di<T, D>(p, stream);
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
int run(const Params& p, int head_dim, int dtype, int request,
        void* stream) {
  if (p.batch <= 0 || p.seq <= 0) return 0;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads || p.seq % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chosen(head_dim, dtype, request)) {
    case kWgmma:
      return head_dim == 64 ? launch_wgmma<64, BAND>(p, st)
                            : launch_wgmma<128, BAND>(p, st);
    case kSplit:
      return head_dim == 64 ? launch_split<64, BAND>(p, st)
                            : launch_split<128, BAND>(p, st);
    case kMmaSync: return launch<bf16, 256, BAND>(p, st);
    case kFma: return launch_d<float, BAND>(p, head_dim, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace ttd_flash

// Operands as ttd_flash_attention_fwd, plus dout [B, H, S, D] and the
// gradients dq [B, H, S, D], dk, dv [B, KVH, S, D] (element strides, D
// contiguous, 16-byte aligned rows); lse from the forward; di: [B, H, S]
// f32 scratch.  ``strides`` holds 24 element strides: (b, h, s) of q, k,
// v, o, dout, dq, dk, dv.  ``body`` as ttd_flash_attention_fwd's.
// Launches three kernels; returns the first CUDA error (0 on success).
extern "C" int ttd_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* di, const void* seg, const long long* strides, int batch,
    int heads, int kv_heads, int seq, int head_dim, float scale, int causal,
    int dtype, int body, void* stream) {
  using namespace ttd_flash;
  Params p = bwd_params(q, k, v, o, lse, dout, dq, dk, dv, di, seg, strides,
                        batch, heads, kv_heads, seq);
  p.scale = scale;
  p.causal = causal;
  return run<false>(p, head_dim, dtype, body, stream);
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
  return run<true>(p, head_dim, dtype, -1, stream);
}
