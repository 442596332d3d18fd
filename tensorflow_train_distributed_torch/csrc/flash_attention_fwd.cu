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
//   (4*D flops a visible (query, key) pair against 4*S*D elements moved
//   a head; at the llama_125m shape 51.5 GFLOP against 0.1 GB), bytes
//   only at short S.  Only wgmma reaches the tensor cores' 989 TFLOP/s.
//   f32 (BERT's and Transformer-big's heads, S 128-256): bytes, twice
//   bf16's, against six bf16 products a product on the split body.
//
// Bodies, chosen statically by (dtype, head_dim) in ``body()``
// (flash_common.cuh), the same for K2 and K7 and for the backward:
//
// wgmma body (bf16, D 64 and 128; flash_fwd_wgmma_kernel).  One block
//   of 384 threads per (q tile of 128 rows, head, batch); blockIdx.x runs
//   the q tiles in reverse when causal, so the tiles with the most kv
//   tiles start first.  Warpgroup 2 is the producer: after setmaxnreg
//   gives its registers to the consumers, one thread loads Q once and
//   then K and V of each kv tile (128 rows) with TMA into a ring of 3
//   (D 64) or 2 (D 128) stages, each stage with a full and an empty
//   mbarrier.  The operands are strided [B, S, H, D] storage seen as
//   [B, H, S, D]: each gets a rank-4 tensor map (D, S, H, B) encoded on
//   the host per call (64 x 64 boxes, 128-byte swizzle; rows past S read
//   as zeros), passed as a __grid_constant__ parameter.  Warpgroups 0
//   and 1 each own 64 q rows: S = Q.K^T is wgmma m64n128k16 with both
//   operands K-major in shared memory; the online softmax runs on the
//   accumulator in registers in log2 units (exp2f, log2 e folded into
//   the scale; the saved lse is converted back to natural log); P is
//   rounded to bf16 in registers and O += P.V is wgmma with A from
//   registers and V read MN-major through the descriptor's transpose
//   bit.  At D 64 the tiles are software-pipelined inside a warpgroup:
//   Q.K^T of tile i is issued together with P.V of tile i - 1, and the
//   softmax of tile i runs while P.V of tile i - 1 is on the tensor cores
//   (P of two tiles in registers).  At D 128 a warpgroup takes one tile
//   at a time and the two warpgroups overlap each other (measured faster
//   there), skipping tiles with no visible pair (``tile_empty``).  Masks
//   are computed only on tiles that may hold an invisible pair
//   (``tile_masked``: the diagonal, the band's edge, sink tiles, a
//   ragged last tile, and every tile under segment ids).
//   The epilogue rounds O through the warpgroup's own rows of the Q tile
//   and stores it with 16-byte stores; lse from one lane a row.
//   Left for later: ping-pong ordering of the two warpgroups' products,
//   a persistent grid, TMA stores.
// split body (f32, D 64 and 128; flash_fwd_split_kernel): the wgmma
//   body's roles on exact bf16 terms of the f32 operands (flash_common.cuh:
//   each product a.b as six products of a's and b's hi, mid and lo terms,
//   exact to 2^-27 |a||b|).  TMA loads f32 tiles (32-column panels) into
//   tiles of term planes (1.5x the f32 bytes); warps 9-11 of the producer
//   warpgroup split each landed K and V stage in place into its hi, mid
//   and lo planes and arrive on the stage's full barrier after an
//   async-proxy fence, so the consumers run only products and the
//   softmax; each consumer warpgroup splits its own 64 rows of Q once.
//   Scores: the six products from shared memory; P is split in registers;
//   each tile's P.V goes by 64-column halves into a fresh accumulator
//   added to o with rounded f32 adds (the tensor core truncates its
//   running sum).  One 64-row kv tile at a time; two stages at D 64, one
//   at D 128 (two would not fit); o stored in f32 straight from
//   registers.  At S 128-256 a q tile meets two to four kv tiles, so a
//   block of one tile would wait on its loads: a block an SM walks the q
//   tiles instead (item_index), the ring running on across them, and at
//   D 64 the next tile's Q loads into a second buffer while the current
//   one is worked on.
// mma.sync body (bf16, D 256: its [64, 256] f32 output accumulator alone
//   takes 128 registers a thread and would not fit beside the scores) and
//   FMA body (f32 at D 256, for the same reason; and at D 64 and 128 when
//   a caller forces it, to time it beside the split body):
//   flash_fwd_kernel, one block per (64-row q tile, head, batch), the
//   TPU grid's sequential kv axis a loop inside the block; each warp owns
//   16 rows, K and V tiles staged by the whole block, one tile in flight.
//   GQA reads kv head h / (H / KVH) directly, with no repeated copy, in
//   every body.
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
//   Design: K2's bodies instantiated with BAND = true.  A q tile visits
//   the kv tiles from the one holding its first row's window start to its
//   diagonal, after the tiles holding sinks (KvTiles); the band's edge is
//   masked inside the tiles it cuts (visible<true>).  With a window at or
//   past S nothing else differs from K2 causal, bit for bit.
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

// The wgmma body's shape: 128 q rows a block (two consumer warpgroups of
// 64), kv tiles of 128 rows in a ring of kStages, one producer warpgroup.
template <int D>
struct FwdWg {
  static constexpr int kBm = 128;
  static constexpr int kBn = 128;
  static constexpr int kStages = D == 64 ? 3 : 2;
  // Software-pipelined inside a warpgroup at D 64, where the softmax
  // weighs most against the products; at D 128 the extra P tile in
  // registers cost more than it hid (PERF.md §6).
  static constexpr bool kPipelined = D == 64;
  static constexpr int kThreads = 384;
  static constexpr int kQElems = kBm * D;
  static constexpr int kKvElems = kBn * D;          // one K or V tile
  static constexpr int kSmem = 1024 + (kQElems + 2 * kStages * kKvElems) * 2 +
                               (2 * kStages + 1) * 8;
};

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Params p) {
  using C = FwdWg<D>;
  namespace hw = ttd_hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* kvs = qs + C::kQElems;          // stage s: K at 2s, V at 2s + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + 2 * C::kStages *
                                               C::kKvElems);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int n_qt = (p.seq + C::kBm - 1) / C::kBm;
  // The q tiles with the most kv tiles first: the last ones when causal.
  const int qt = p.causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * C::kBm;
  const int q_end = min(q0 + C::kBm, p.seq);
  const int n_kv = p.causal ? (q_end - 1) / C::kBn + 1
                            : (p.seq + C::kBn - 1) / C::kBn;
  const KvTiles<BAND, C::kBn> tiles(p.window, p.sinks, q0);

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
    // Producer: Q once, then K and V of each kv tile into the ring.
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      hw::mbar_expect_tx(qbar, C::kQElems * 2);
      hw::tma_load_rows<C::kBm, D>(qs, &tq, qbar, q0, h, b);
      int i = 0;
      for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt), ++i) {
        const int s = i % C::kStages;
        hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], 2 * C::kKvElems * 2);
        bf16* ks = kvs + 2 * s * C::kKvElems;
        hw::tma_load_rows<C::kBn, D>(ks, &tk, &full[s], kt * C::kBn, kvh, b);
        hw::tma_load_rows<C::kBn, D>(ks + C::kKvElems, &tv, &full[s],
                                     kt * C::kBn, kvh, b);
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
  const int r0 = w0 + 16 * warp + g;       // this thread's rows
  const int r1 = r0 + 8;
  const bool seg = p.seg != nullptr;
  const int* segb = p.seg + static_cast<long long>(b) * p.seq;
  const int sq0 = seg ? segb[min(r0, p.seq - 1)] : 0;
  const int sq1 = seg ? segb[min(r1, p.seq - 1)] : 0;
  const float sl2 = p.scale * kLog2e;      // scores in log2 units

  float o[D / 2];
  float s[C::kBn / 2];
  uint32_t pf[C::kBn / 16][4];             // P of the tile whose P.V is next
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::kBn / 2; ++i) s[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float a0 = 0.f, a1 = 0.f;                // the last tile's rescale factors

  // The online softmax of the scores of the kv tile at k0 (in ``s``):
  // updates the running max and this thread's share of the row sums,
  // sets the rescale factors of the output so far, and leaves P rounded
  // to bf16 in ``next``.
  auto softmax = [&](int k0, uint32_t (*next)[4]) {
    float mx0 = m0, mx1 = m1;
    if (tile_masked<BAND>(p, w0, w0 + 63, k0, k0 + C::kBn - 1)) {
#pragma unroll
      for (int j = 0; j < C::kBn / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          float x = s[4 * j + e] * sl2;
          if (col >= p.seq ||
              !visible<BAND>(row, col, p.causal, p.window, p.sinks, seg,
                             e < 2 ? sq0 : sq1, seg ? segb[col] : 0))
            x += kMaskValue;
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::kBn / 8; ++j) {
        s[4 * j] *= sl2;
        s[4 * j + 1] *= sl2;
        s[4 * j + 2] *= sl2;
        s[4 * j + 3] *= sl2;
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    a0 = exp2f(m0 - mx0);                  // 0 on the first tile (m = -inf)
    a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < C::kBn / 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - m0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
      ls0 += s[4 * j] + s[4 * j + 1];
      ls1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + ls0;                    // this thread's share of the row
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int kk = 0; kk < C::kBn / 16; ++kk) frag_a(s, kk, next[kk]);
  };
  auto scores = [&](int stage) {           // s = Q . K^T, issued
    const bf16* ks = kvs + 2 * stage * C::kKvElems;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss<C::kBn>(s, hw::desc_k<C::kBm>(qs, 64 * wg, kk),
                           hw::desc_k<C::kBn>(ks, 0, kk), kk > 0);
    hw::wgmma_commit();
  };
  auto pv = [&](int stage) {               // o += P . V, issued
    const bf16* vs = kvs + (2 * stage + 1) * C::kKvElems;
#pragma unroll
    for (int kk = 0; kk < C::kBn / 16; ++kk)
      hw::wgmma_rs<D>(o, pf[kk], hw::desc_mn<C::kBn>(vs, kk));
    hw::wgmma_commit();
  };

  auto rescale = [&]() {                   // o *= the last tile's factors
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  };

  hw::mbar_wait(qbar, 0);
  if constexpr (C::kPipelined) {
    // The scores of kv tile i are issued together with P.V of tile
    // i - 1, and the softmax of tile i runs while P.V of tile i - 1 is on
    // the tensor cores.
    int kt = tiles.first();
    hw::mbar_wait(&full[0], 0);
    hw::wgmma_fence();
    scores(0);
    hw::wgmma_wait<0>();
    hw::reg_fence<C::kBn / 2>(s);
    softmax(kt * C::kBn, pf);
    int i = 0;
    for (kt = tiles.next(kt); kt < n_kv; kt = tiles.next(kt)) {
      ++i;
      const int st = i % C::kStages;
      const int prev = (i - 1) % C::kStages;
      hw::mbar_wait(&full[st], (i / C::kStages) & 1);
      hw::wgmma_fence();
      scores(st);
      pv(prev);
      hw::wgmma_wait<1>();                 // the scores are in
      hw::reg_fence<C::kBn / 2>(s);
      uint32_t next[C::kBn / 16][4];
      softmax(kt * C::kBn, next);
      hw::wgmma_wait<0>();                 // P.V of tile i - 1 is in
      hw::reg_fence<D / 2>(o);
#pragma unroll
      for (int kk = 0; kk < C::kBn / 16; ++kk)
        asm volatile("" : "+r"(pf[kk][0]), "+r"(pf[kk][1]), "+r"(pf[kk][2]),
                     "+r"(pf[kk][3]) :: "memory");
      hw::mbar_arrive(&empty[prev]);
      rescale();
#pragma unroll
      for (int kk = 0; kk < C::kBn / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = next[kk][r];
    }
    hw::wgmma_fence();
    pv(i % C::kStages);
    hw::wgmma_wait<0>();
    hw::reg_fence<D / 2>(o);
    hw::mbar_arrive(&empty[i % C::kStages]);
  } else {
    // One tile at a time; the two warpgroups overlap each other.  Tiles
    // with no visible pair for this warpgroup are skipped (their
    // probabilities would be exactly 0).
    int i = 0;
    for (int kt = tiles.first(); kt < n_kv; kt = tiles.next(kt), ++i) {
      const int st = i % C::kStages;
      hw::mbar_wait(&full[st], (i / C::kStages) & 1);
      const int k0 = kt * C::kBn;
      if (!tile_empty<BAND>(p, w0, w0 + 63, k0, k0 + C::kBn - 1)) {
        hw::wgmma_fence();
        scores(st);
        hw::wgmma_wait<0>();
        hw::reg_fence<C::kBn / 2>(s);
        softmax(k0, pf);
        rescale();
        hw::wgmma_fence();
        pv(st);
        hw::wgmma_wait<0>();
        hw::reg_fence<D / 2>(o);
      }
      hw::mbar_arrive(&empty[st]);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.seq;
    if (r0 < p.seq) lse[r0] = m0 * kLn2 + logf(l0);
    if (r1 < p.seq) lse[r1] = m1 * kLn2 + logf(l1);
  }
  bf16* og = static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h;
  store_rows<D>(o, l0 == 0.f ? 1.f : 1.f / l0, l1 == 0.f ? 1.f : 1.f / l1,
                qs + 64 * wg * 64, C::kBm * 64, og, p.so.s, w0, p.seq, wg);
}

template <int D, bool BAND>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using C = FwdWg<D>;
  CUtensorMap tq, tk, tv;
  if (!ttd_hopper::make_map(&tq, p.q, p.sq.b, p.sq.h, p.sq.s, p.batch,
                            p.heads, p.seq, D) ||
      !ttd_hopper::make_map(&tk, p.k, p.sk.b, p.sk.h, p.sk.s, p.batch,
                            p.kv_heads, p.seq, D) ||
      !ttd_hopper::make_map(&tv, p.v, p.sv.b, p.sv.h, p.sv.s, p.batch,
                            p.kv_heads, p.seq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, BAND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + C::kBm - 1) / C::kBm, p.heads, p.batch);
  flash_fwd_wgmma_kernel<D, BAND><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The split body's shape: 128 q rows a block (two consumer warpgroups of
// 64), 64-row kv tiles, one producer warpgroup, tiles of bf16 terms
// (split_bytes: 1.5x the f32 tile).  At D 64 two stages, and the next
// item's Q loads into a second buffer (kRes) while the block works on the
// current one; at D 128 one of each (two would not fit shared memory).
template <int D>
struct FwdSplit {
  static constexpr int kBm = 128;
  static constexpr int kBn = 64;
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kRes = D == 64 ? 2 : 1;
  static constexpr int kThreads = 384;
  static constexpr int kQBytes = split_bytes<kBm, D>();
  static constexpr int kKvBytes = split_bytes<kBn, D>();   // K or V
  static constexpr int kBars = 3 * kStages + 2 * kRes;
  static constexpr int kSmem = 1024 + kRes * kQBytes +
                               2 * kStages * kKvBytes + kBars * 8;
};

template <int D, bool BAND>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_split_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Params p) {
  using C = FwdSplit<D>;
  namespace hw = ttd_hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* res = base;               // buffer r: Q
  unsigned char* kvs = res + C::kRes * C::kQBytes;   // stage s: K at 2s,
  uint64_t* full = reinterpret_cast<uint64_t*>(      // V at 2s + 1
      kvs + 2 * C::kStages * C::kKvBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* loaded = empty + C::kStages;   // the f32 stage has landed
  uint64_t* rfull = loaded + C::kStages;   // a Q buffer has landed
  uint64_t* rempty = rfull + C::kRes;      // ... and is free again
  auto kv = [&](int stage, int which) {    // K (0) or V (1) of a stage
    return kvs + (2 * stage + which) * C::kKvBytes;
  };

  const int n_qt = (p.seq + C::kBm - 1) / C::kBm;
  const int n_items = n_qt * p.heads * p.batch;
  // Work item idx: q tile (the ones with the most kv tiles first: the
  // last ones when causal), head and batch row.
  struct Work {
    int h, b, kvh, q0, n_kv;
  };
  auto work = [&](int idx) {
    const Item it = item_at(idx, n_qt, p.heads);
    const int qt = p.causal ? n_qt - 1 - it.x : it.x;
    const int q0 = qt * C::kBm;
    const int q_end = min(q0 + C::kBm, p.seq);
    return Work{it.y, it.z, it.y / (p.heads / p.kv_heads), q0,
                p.causal ? (q_end - 1) / C::kBn + 1
                         : (p.seq + C::kBn - 1) / C::kBn};
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 96);
      hw::mbar_init(&empty[s], 256);
      hw::mbar_init(&loaded[s], 1);
    }
    for (int r = 0; r < C::kRes; ++r) {
      hw::mbar_init(&rfull[r], 1);
      hw::mbar_init(&rempty[r], 256);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread loads each item's Q, then K and V of its kv
    // tiles into the ring, landing on ``loaded``; warps 9-11 split each
    // stage in place into its bf16 planes, then arrive on ``full``.
    hw::regs_dec<40>();
    if (threadIdx.x == 256) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        const int r = n % C::kRes;
        hw::mbar_wait(&rempty[r], ((n / C::kRes) & 1) ^ 1);
        hw::mbar_expect_tx(&rfull[r], C::kBm * D * 4);
        tma_load_split<C::kBm, D>(res + r * C::kQBytes, &tq, &rfull[r], w.q0,
                                  w.h, w.b);
        const KvTiles<BAND, C::kBn> tiles(p.window, p.sinks, w.q0);
        for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
          hw::mbar_expect_tx(&loaded[s], 2 * C::kBn * D * 4);
          tma_load_split<C::kBn, D>(kv(s, 0), &tk, &loaded[s], kt * C::kBn,
                                    w.kvh, w.b);
          tma_load_split<C::kBn, D>(kv(s, 1), &tv, &loaded[s], kt * C::kBn,
                                    w.kvh, w.b);
        }
      }
    } else if (threadIdx.x >= 288) {
      int i = 0;
      for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
        const Work w = work(idx);
        const KvTiles<BAND, C::kBn> tiles(p.window, p.sinks, w.q0);
        for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
          const int s = i % C::kStages;
          hw::mbar_wait(&loaded[s], (i / C::kStages) & 1);
          split_rows<C::kBn, D>(kv(s, 0), 0, C::kBn, threadIdx.x - 288, 96);
          split_rows<C::kBn, D>(kv(s, 1), 0, C::kBn, threadIdx.x - 288, 96);
          hw::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [w0, w0 + 64) of each item.
  hw::regs_inc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const bool seg = p.seg != nullptr;
  const float sl2 = p.scale * kLog2e;      // scores in log2 units

  float o[D / 2];
  float s[C::kBn / 2];
  SplitFrags<C::kBn / 16> pf;              // P's terms
  float chunk[32];                         // one tile's P.V, by half
#pragma unroll
  for (int j = 0; j < C::kBn / 2; ++j) s[j] = 0.f;

  int i = 0;                               // the ring's tile
  for (int n = 0, idx; (idx = item_index(n)) < n_items; ++n) {
    const Work w = work(idx);
    const int r = n % C::kRes;
    unsigned char* qs = res + r * C::kQBytes;
    const KvTiles<BAND, C::kBn> tiles(p.window, p.sinks, w.q0);
    const int w0 = w.q0 + 64 * wg;
    const int r0 = w0 + 16 * warp + g;     // this thread's rows
    const int r1 = r0 + 8;
    const int* segb = p.seg + static_cast<long long>(w.b) * p.seq;
    const int sq0 = seg ? segb[min(r0, p.seq - 1)] : 0;
    const int sq1 = seg ? segb[min(r1, p.seq - 1)] : 0;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    hw::mbar_wait(&rfull[r], (n / C::kRes) & 1);
    // This warpgroup's 64 rows of Q into their terms, before its first
    // product reads them.
    split_rows<C::kBm, D>(qs, 64 * wg, 64, tid, 128);
    hw::bar_sync(1 + wg, 128);
    // One tile at a time; the two warpgroups overlap each other.  Tiles
    // with no visible pair for this warpgroup are skipped (their
    // probabilities would be exactly 0).
    for (int kt = tiles.first(); kt < w.n_kv; kt = tiles.next(kt), ++i) {
      const int st = i % C::kStages;
      hw::mbar_wait(&full[st], (i / C::kStages) & 1);
      const int k0 = kt * C::kBn;
      if (!tile_empty<BAND>(p, w0, w0 + 63, k0, k0 + C::kBn - 1)) {
        const unsigned char* ks = kv(st, 0);
        const unsigned char* vs = kv(st, 1);
        hw::wgmma_fence();
        wgmma_ss_split<C::kBn, D>(
            s,
            [&](int pl, int kk) {
              return desc_k_split<C::kBm>(qs, pl, 64 * wg, kk);
            },
            [&](int pl, int kk) {
              return desc_k_split<C::kBn>(ks, pl, 0, kk);
            },
            0);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::reg_fence<C::kBn / 2>(s);
        // The online softmax: the running max, this thread's share of the
        // row sums, the output's rescale, and P's terms.
        float mx0 = m0, mx1 = m1;
        if (tile_masked<BAND>(p, w0, w0 + 63, k0, k0 + C::kBn - 1)) {
#pragma unroll
          for (int j = 0; j < C::kBn / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * j + 2 * t + (e & 1);
              const int row = e < 2 ? r0 : r1;
              float x = s[4 * j + e] * sl2;
              if (col >= p.seq ||
                  !visible<BAND>(row, col, p.causal, p.window, p.sinks, seg,
                                 e < 2 ? sq0 : sq1, seg ? segb[col] : 0))
                x += kMaskValue;
              s[4 * j + e] = x;
              if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < C::kBn / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] *= sl2;
            mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float a0 = exp2f(m0 - mx0);  // 0 on the first tile
        const float a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < C::kBn / 8; ++j) {
          s[4 * j] = exp2f(s[4 * j] - m0);
          s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
          s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
          s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
          ls0 += s[4 * j] + s[4 * j + 1];
          ls1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * a0 + ls0;
        l1 = l1 * a1 + ls1;
        split_frags(s, pf);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        wgmma_rs_split_add<D>(o, chunk, pf, [&](int pl, int kk, int hf) {
          return desc_mn_split<C::kBn>(vs, pl, kk, hf);
        });
        frag_fence(pf);
      }
      hw::mbar_arrive(&empty[st]);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (t == 0) {
      float* lse =
          p.lse + (static_cast<long long>(w.b) * p.heads + w.h) * p.seq;
      if (r0 < p.seq) lse[r0] = m0 * kLn2 + logf(l0);
      if (r1 < p.seq) lse[r1] = m1 * kLn2 + logf(l1);
    }
    float* og = static_cast<float*>(p.out) + w.b * p.so.b + w.h * p.so.h;
    store_rows_f32<D>(o, l0 == 0.f ? 1.f : 1.f / l0,
                      l1 == 0.f ? 1.f : 1.f / l1, og, p.so.s, w0, p.seq);
    hw::mbar_arrive(&rempty[r]);
  }
}

template <int D, bool BAND>
int launch_split(const Params& p, cudaStream_t stream) {
  using C = FwdSplit<D>;
  CUtensorMap tq, tk, tv;
  if (!ttd_hopper::make_map(&tq, p.q, p.sq.b, p.sq.h, p.sq.s, p.batch,
                            p.heads, p.seq, D, ttd::kF32) ||
      !ttd_hopper::make_map(&tk, p.k, p.sk.b, p.sk.h, p.sk.s, p.batch,
                            p.kv_heads, p.seq, D, ttd::kF32) ||
      !ttd_hopper::make_map(&tv, p.v, p.sv.b, p.sv.h, p.sv.s, p.batch,
                            p.kv_heads, p.seq, D, ttd::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_split_kernel<D, BAND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(
      (p.seq + C::kBm - 1) / C::kBm) * p.heads * p.batch;
  flash_fwd_split_kernel<D, BAND>
      <<<split_blocks(items), C::kThreads, C::kSmem, stream>>>(tq, tk, tv,
                                                               p);
  return static_cast<int>(cudaGetLastError());
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

// q: [B, H, S, D]; k, v: [B, KVH, S, D]; o: [B, H, S, D] (any element
// strides with D contiguous, 16-byte aligned rows); lse: [B, H, S] f32
// contiguous; seg: [B, S] int32 contiguous or null.  ``strides`` holds
// 12 element strides: (b, h, s) of q, k, v, o.  S must be a multiple of
// 64, H a multiple of KVH, D one of 64, 128, 256.  ``body``: -1 the
// library's choice (ttd_flash_attention_body), else a Body code that
// ``chosen`` accepts.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ttd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg, const long long* strides, int batch, int heads,
    int kv_heads, int seq, int head_dim, float scale, int causal, int dtype,
    int body, void* stream) {
  using namespace ttd_flash;
  Params p = fwd_params(q, k, v, o, lse, seg, strides, batch, heads,
                        kv_heads, seq);
  p.scale = scale;
  p.causal = causal;
  return run<false>(p, head_dim, dtype, body, stream);
}

// Which body serves (dtype, head_dim) in the forward and the backward,
// K2 and K7 alike: 3 the split body, 2 the wgmma body, 1 the mma.sync
// body, 0 the FMA body, -1 none (the pair is refused).
extern "C" int ttd_flash_attention_body(int head_dim, int dtype) {
  return ttd_flash::body(head_dim, dtype);
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
  return run<true>(p, head_dim, dtype, -1, stream);
}
