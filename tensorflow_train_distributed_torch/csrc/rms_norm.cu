// Fused RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   _rmsnorm_fwd_call (kernel _rmsnorm_fwd_kernel): per row
//   y = x * r * s with r = rsqrt(mean(x^2) + eps), accumulated in f32; it
//   also writes r [N, 1] f32 for the backward (optional here: serving
//   passes null and skips the write).
//   _rms_norm_pallas_bwd: its kernel _rmsnorm_bwd_kernel, per row
//   dx = r * (g * s) - x * r^3 * mean((g * s) * x) in f32, written in x's
//   dtype, and the column reduction dscale = sum_rows g * x * r that the
//   JAX function leaves to an einsum, rounded once to the scale's dtype.
//
// Bound on this card: bytes.  The forward reads x once and writes y (and
//   4 bytes of r a row); the backward reads x and g and writes dx (and
//   d values of dscale).  A few flops an element against the H100's 295
//   flop/byte ridge.
//
// Forward, two bodies, chosen statically (``choose_body``):
//   warp (the rule): one warp per row, four rows in flight a block, the
//     warps striding over rows in a grid of as many blocks as the SMs
//     hold at once.  Each lane loads its share of the row as 16-byte
//     vectors (8 bf16 or 4 f32) and keeps it in registers between the
//     sum of squares and the write, so x is read once, and loads the
//     next row it walks once the current one is written; the sum is a
//     warp shuffle, with no block barrier and no shared memory in the
//     row loop; lane 0 writes r.  The scale's floats are loaded once per warp and held in
//     registers for every row it walks where they fit (at most 32 a lane:
//     d <= 1024); wider rows take them from shared memory, filled once a
//     block (as f32) while each warp's first row is in flight.  It
//     applies where every lane holds whole 16-byte vectors (d * sizeof(x)
//     a multiple of 512 bytes), d <= 4096, x, scale and y are 16-byte
//     aligned and there are at least kMinWarpRows rows: d 768 (llama_125m,
//     moe_370m) and 4096 (Llama-2-7B prefill, mistral_7b_lm).
//   block (every other case: d 1000, a misaligned view, and fewer rows,
//     such as a decode step's 8, which a warp per row puts on too few
//     SMs and which the card ran faster this way): one 256-thread block
//     per row, strided scalar loads, a block_sum through shared memory,
//     the row read twice (the second time from L1/L2).
// Backward, two bodies, chosen statically by the forward's rule
//   (``choose_body``):
//   warp: the forward's warp body with g beside x (8 warps a block).  A
//     lane keeps its vectors of x and g in registers from the row sum
//     c = mean(g s x) to the write of dx (up to 16 vectors each: 8 KB rows;
//     wider f32 rows read them again from L2 for the write).  dscale: a
//     lane owns the same columns in every row its warp walks and adds
//     g (x r) for them in f32, in registers where they fit (d <= 1024)
//     and else in its warp's slice of shared memory.  The block then adds
//     its warps in order into one f32 row of ``partial``; a second kernel
//     of the same call sums the blocks' rows in a fixed order and rounds
//     once to the scale's dtype.  No atomics: dscale is bitwise repeatable
//     on one card (the grid follows the card's SM count).
//   block: one 256-thread block per row, pass 1 sums g*s*x with
//     block_sum, pass 2 re-reads the row and writes dx.  It writes no
//     dscale: the caller takes the column sum (ops/kernels.py).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = 4;                 // warp body: rows a block
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kMaxD = 4096;                  // warp body: widest row
constexpr int kMinWarpRows = 64;             // warp bodies: fewest rows
constexpr int kBwdWarps = 8;                 // backward warp body: rows a block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kKeepVectors = 16;             // backward: x, g vectors kept
constexpr int kSumCols = 32;                 // dscale sum: columns a block
constexpr int kSumSlices = 32;               //   and slices of the blocks' rows

// Block-wide sum of one float per thread; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kWarps];
  __shared__ float total;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = ttd::warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? partial[lane] : 0.f;
    s = ttd::warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ y, float* __restrict__ r_out, int d,
                        float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = ttd::to_f32(xr[i]);
    acc += v * v;
  }
  const float r = rsqrtf(block_sum(acc) / static_cast<float>(d) + eps);
  if (r_out != nullptr && threadIdx.x == 0) r_out[row] = r;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = ttd::from_f32<T>(ttd::to_f32(xr[i]) * r * ttd::to_f32(scale[i]));
  }
}

// 16 bytes of T as E floats, and back (rounded to nearest even).
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static uint4 pack(const float* f) {
    const float4 v = make_float4(f[0], f[1], f[2], f[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(b[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
};

// E consecutive values of S at ``p`` (aligned to E * sizeof(S) bytes) as
// floats, through the read-only cache.
template <typename S, int E>
__device__ __forceinline__ void load_floats(const S* __restrict__ p,
                                            float* f) {
  constexpr int kBytes = E * static_cast<int>(sizeof(S));
  if constexpr (kBytes % 16 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w)
      Pack<S>::unpack(__ldg(v + w), f + w * Pack<S>::E);
  } else {  // four bf16 (an f32 row's vector of scale)
    static_assert(kBytes == 8, "4 bf16 or whole 16-byte vectors");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(b[0]);
    const float2 hi = __bfloat1622float2(b[1]);
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  }
}

// Warp body: lane l holds vectors l, l + 32, ... (nv of them, nv <= NV)
// of each row it walks.  The scale's floats sit in registers where they
// fit (kHold), else in ``staged`` (shared memory, [d] f32, filled once a
// block while the warps' first rows are in flight).
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kRowThreads)
    rms_norm_fwd_warp_kernel(const T* __restrict__ x,
                             const S* __restrict__ scale, T* __restrict__ y,
                             float* __restrict__ r_out, long long n_rows,
                             int d, float eps) {
  constexpr int E = Pack<T>::E;
  constexpr bool kHold = NV * E <= 32;
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  const int lane = threadIdx.x & 31;
  const int nv = d / (32 * E);
  const long long stride = static_cast<long long>(gridDim.x) * kRowWarps;
  long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);

  uint4 v[NV];
  auto load_row = [&v, x, d, nv, lane](long long rw) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + rw * d);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) v[i] = xr[i * 32 + lane];
  };
  if (row < n_rows) load_row(row);

  float held[kHold ? NV * E : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) load_floats<S, E>(scale + (i * 32 + lane) * E, held + i * E);
  } else {
    for (int i = threadIdx.x; i < d / E; i += kRowThreads)
      load_floats<S, E>(scale + i * E, staged + i * E);
    __syncthreads();
  }

  for (; row < n_rows; row += stride) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv) {
        float f[E];
        Pack<T>::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) acc += f[e] * f[e];
      }
    }
    const float r = rsqrtf(ttd::warp_sum(acc) / static_cast<float>(d) + eps);
    if (r_out != nullptr && lane == 0) r_out[row] = r;
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv) {
        float f[E], sf[E];
        Pack<T>::unpack(v[i], f);
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < E; ++e) sf[e] = held[i * E + e];
        } else {
          const float4* s4 = staged4 + (i * 32 + lane) * E / 4;
#pragma unroll
          for (int w = 0; w < E / 4; ++w) {
            const float4 q = s4[w];
            sf[4 * w] = q.x;
            sf[4 * w + 1] = q.y;
            sf[4 * w + 2] = q.z;
            sf[4 * w + 3] = q.w;
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = f[e] * r * sf[e];
        yr[i * 32 + lane] = Pack<T>::pack(f);
      }
    }
    if (row + stride < n_rows) load_row(row + stride);
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rms_norm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const float* __restrict__ r_in,
                        const T* __restrict__ g, T* __restrict__ dx, int d) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const T* gr = g + row * d;
  T* dxr = dx + row * d;

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    acc += ttd::to_f32(gr[i]) * ttd::to_f32(scale[i]) * ttd::to_f32(xr[i]);
  }
  const float c = block_sum(acc) / static_cast<float>(d);
  const float r = r_in[row];
  const float r3 = r * r * r;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float gs = ttd::to_f32(gr[i]) * ttd::to_f32(scale[i]);
    dxr[i] = ttd::from_f32<T>(r * gs - ttd::to_f32(xr[i]) * r3 * c);
  }
}

// Backward warp body: lane l holds vectors l, l + 32, ... (nv of them,
// nv <= NV) of x and g of each row it walks.  Shared memory holds
// [kBwdWarps][d] f32 dscale sums (each warp's slice; with kHold only for
// the block's final merge), then, for d > 1024, the scale as f32.  Both
// are laid out in planes: float w (of E / 4) of vector v at float4
// w * (d / E) + v, so a warp's 32 lanes touch 32 consecutive float4.
// ``partial`` ([gridDim.x, d] f32) gets the block's sums; null: no dscale.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kBwdThreads)
    rms_norm_bwd_warp_kernel(const T* __restrict__ x,
                             const S* __restrict__ scale,
                             const float* __restrict__ r_in,
                             const T* __restrict__ g, T* __restrict__ dx,
                             float* __restrict__ partial, long long n_rows,
                             int d) {
  constexpr int E = Pack<T>::E;
  constexpr int W = E / 4;                    // float4 a vector
  constexpr bool kHold = NV * E <= 32;        // scale and sums in registers
  constexpr bool kKeep = NV <= kKeepVectors;  // x and g in registers
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / E;
  const int nv = nvec / 32;
  const int d4 = d / 4;
  float4* sums = smem4 + warp * d4;
  const float4* staged = smem4 + kBwdWarps * d4;
  const bool want_ds = partial != nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * kBwdWarps;
  long long row =
      static_cast<long long>(blockIdx.x) * kBwdWarps + warp;

  uint4 xv[kKeep ? NV : 1], gv[kKeep ? NV : 1];
  float rr = 0.f;
  auto load_row = [&](long long rw) {
    if constexpr (kKeep) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + rw * d);
      const uint4* gr = reinterpret_cast<const uint4*>(g + rw * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i < nv) {
          xv[i] = xr[i * 32 + lane];
          gv[i] = gr[i * 32 + lane];
        }
      }
    }
    rr = r_in[rw];
  };
  if (row < n_rows) load_row(row);

  float held[kHold ? NV * E : 1];
  float acc[kHold ? NV * E : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) load_floats<S, E>(scale + (i * 32 + lane) * E, held + i * E);
#pragma unroll
    for (int k = 0; k < NV * E; ++k) acc[k] = 0.f;
  } else {
    float4* fill = smem4 + kBwdWarps * d4;
    for (int v = threadIdx.x; v < nvec; v += kBwdThreads) {
      float f[E];
      load_floats<S, E>(scale + v * E, f);
#pragma unroll
      for (int w = 0; w < W; ++w)
        fill[w * nvec + v] =
            make_float4(f[4 * w], f[4 * w + 1], f[4 * w + 2], f[4 * w + 3]);
    }
    if (want_ds)
      for (int q = lane; q < d4; q += 32) sums[q] = make_float4(0, 0, 0, 0);
    __syncthreads();
  }

  // Vector i of this lane in the current row as floats: x, g and the scale.
  auto operands = [&](long long rw, int i, float* xf, float* gf, float* sf) {
    const int v = i * 32 + lane;
    if constexpr (kKeep) {
      Pack<T>::unpack(xv[i], xf);
      Pack<T>::unpack(gv[i], gf);
    } else {
      Pack<T>::unpack(reinterpret_cast<const uint4*>(x + rw * d)[v], xf);
      Pack<T>::unpack(reinterpret_cast<const uint4*>(g + rw * d)[v], gf);
    }
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < E; ++e) sf[e] = held[i * E + e];
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float4 q = staged[w * nvec + v];
        sf[4 * w] = q.x;
        sf[4 * w + 1] = q.y;
        sf[4 * w + 2] = q.z;
        sf[4 * w + 3] = q.w;
      }
    }
  };

  for (; row < n_rows; row += stride) {
    const float r = rr;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv) {
        float xf[E], gf[E], sf[E];
        operands(row, i, xf, gf, sf);
#pragma unroll
        for (int e = 0; e < E; ++e) part += gf[e] * sf[e] * xf[e];
        if (want_ds) {
          if constexpr (kHold) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i * E + e] += gf[e] * (xf[e] * r);
          } else {
            const int v = i * 32 + lane;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              float4 a = sums[w * nvec + v];
              a.x += gf[4 * w] * (xf[4 * w] * r);
              a.y += gf[4 * w + 1] * (xf[4 * w + 1] * r);
              a.z += gf[4 * w + 2] * (xf[4 * w + 2] * r);
              a.w += gf[4 * w + 3] * (xf[4 * w + 3] * r);
              sums[w * nvec + v] = a;
            }
          }
        }
      }
    }
    const float c = ttd::warp_sum(part) / static_cast<float>(d);
    const float r3 = r * r * r;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv) {
        float xf[E], gf[E], sf[E];
        operands(row, i, xf, gf, sf);
#pragma unroll
        for (int e = 0; e < E; ++e)
          xf[e] = r * (gf[e] * sf[e]) - xf[e] * r3 * c;
        dxr[i * 32 + lane] = Pack<T>::pack(xf);
      }
    }
    if (row + stride < n_rows) load_row(row + stride);
  }

  if (!want_ds) return;
  if constexpr (kHold) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv) {
        const int v = i * 32 + lane;
#pragma unroll
        for (int w = 0; w < W; ++w)
          sums[w * nvec + v] =
              make_float4(acc[i * E + 4 * w], acc[i * E + 4 * w + 1],
                          acc[i * E + 4 * w + 2], acc[i * E + 4 * w + 3]);
      }
    }
  }
  __syncthreads();
  // The block's row of partial sums: its warps added in order, written
  // in column order (float4 q of the planes is columns v * E + 4 w ...).
  float4* out4 = reinterpret_cast<float4*>(
      partial + static_cast<long long>(blockIdx.x) * d);
  for (int q = threadIdx.x; q < d4; q += kBwdThreads) {
    float4 t = smem4[q];
    for (int w = 1; w < kBwdWarps; ++w) {
      const float4 u = smem4[w * d4 + q];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    const int plane = q / nvec, v = q - plane * nvec;
    out4[v * W + plane] = t;
  }
}

// dscale[c] = the sum over the n_part rows of ``partial`` [n_part, d] at
// column c, in a fixed order (slice k adds rows [k * per, (k + 1) * per)
// in order, then the slices are added in order), rounded once to S.
template <typename S>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
    rms_norm_dscale_kernel(const float* __restrict__ partial,
                           S* __restrict__ ds, int n_part, int d) {
  __shared__ float slice[kSumSlices][kSumCols + 1];
  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int col = blockIdx.x * kSumCols + lane;
  const int per = (n_part + kSumSlices - 1) / kSumSlices;
  float t = 0.f;
  if (col < d) {
    const int end = min(n_part, (k + 1) * per);
    for (int b = k * per; b < end; ++b)
      t += partial[static_cast<long long>(b) * d + col];
  }
  slice[k][lane] = t;
  __syncthreads();
  if (k == 0 && col < d) {
    float sum = slice[0][lane];
    for (int j = 1; j < kSumSlices; ++j) sum += slice[j][lane];
    ds[col] = ttd::from_f32<S>(sum);
  }
}

// Element size of a dtype code (0 for an unknown code).
int dtype_bytes(int code) {
  return code == ttd::kF32 ? 4 : code == ttd::kBF16 ? 2 : 0;
}

// Whether the warp body can run: every lane holds whole 16-byte vectors
// of a row no wider than kMaxD, and the pointers are 16-byte aligned
// (``aligned``).
bool warp_runs(int d, int x_dtype, int s_dtype, bool aligned) {
  const int xb = dtype_bytes(x_dtype);
  return aligned && xb != 0 && dtype_bytes(s_dtype) != 0 && d > 0 &&
         d <= kMaxD && (d * xb) % (32 * 16) == 0;
}

// The body of either pass: 1 (warp) where it runs and there are at least
// kMinWarpRows rows, 0 (block) otherwise.
int choose_body(int n_rows, int d, int x_dtype, int s_dtype, bool aligned) {
  return n_rows >= kMinWarpRows && warp_runs(d, x_dtype, s_dtype, aligned);
}

// The backward warp body's grid for these rows (as many blocks as the SMs
// hold at once, at most one a kBwdWarps rows) in ``grid`` and its dynamic
// shared memory in ``smem``; returns a cudaError_t.
template <typename T, typename S, int NV>
int bwd_warp_grid(long long n_rows, int d, int* grid, size_t* smem) {
  auto kernel = rms_norm_bwd_warp_kernel<T, S, NV>;
  const bool hold = NV * Pack<T>::E <= 32;
  *smem = (kBwdWarps + (hold ? 0 : 1)) * static_cast<size_t>(d) * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBwdThreads, *smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (n_rows + kBwdWarps - 1) / kBwdWarps;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  *grid = static_cast<int>(need < resident ? need : resident);
  return 0;
}

// Calls ``f(T(), S(), Vectors<NV>())`` for the dtype codes and the
// vectors a lane holds of a d-wide row (NV = 4, 8, 16 or 32).
template <int NV>
using Vectors = std::integral_constant<int, NV>;

template <typename F>
int with_types(int x_dtype, int s_dtype, int d, F&& f) {
  using bf16 = __nv_bfloat16;
  auto by_nv = [&](auto xt, auto st) {
    const int nv = d * static_cast<int>(sizeof(xt)) / (32 * 16);
    if (nv <= 4) return f(xt, st, Vectors<4>());
    if (nv <= 8) return f(xt, st, Vectors<8>());
    if (nv <= 16) return f(xt, st, Vectors<16>());
    return f(xt, st, Vectors<32>());
  };
  if (x_dtype == ttd::kF32 && s_dtype == ttd::kF32) return by_nv(0.f, 0.f);
  if (x_dtype == ttd::kF32 && s_dtype == ttd::kBF16)
    return by_nv(0.f, bf16());
  if (x_dtype == ttd::kBF16 && s_dtype == ttd::kF32)
    return by_nv(bf16(), 0.f);
  if (x_dtype == ttd::kBF16 && s_dtype == ttd::kBF16)
    return by_nv(bf16(), bf16());
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename S, int NV>
int launch_fwd_warp(const void* x, const void* scale, void* y, float* r,
                    long long n_rows, int d, float eps,
                    cudaStream_t stream) {
  auto kernel = rms_norm_fwd_warp_kernel<T, S, NV>;
  const size_t smem = NV * Pack<T>::E <= 32 ? 0 : d * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kRowThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (n_rows + kRowWarps - 1) / kRowWarps;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(need < resident ? need : resident),
           kRowThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), r, n_rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_bwd_block(const void* x, const void* scale, const float* r,
                     const void* g, void* dx, int n_rows, int d,
                     cudaStream_t stream) {
  rms_norm_bwd_kernel<T, S><<<n_rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), r,
      static_cast<const T*>(g), static_cast<T*>(dx), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, int NV>
int launch_bwd_warp(const void* x, const void* scale, const float* r,
                    const void* g, void* dx, void* ds, float* partial,
                    int n_rows, int d, cudaStream_t stream) {
  int grid = 0;
  size_t smem = 0;
  const int e = bwd_warp_grid<T, S, NV>(n_rows, d, &grid, &smem);
  if (e) return e;
  rms_norm_bwd_warp_kernel<T, S, NV><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), r,
      static_cast<const T*>(g), static_cast<T*>(dx),
      ds != nullptr ? partial : nullptr, n_rows, d);
  if (ds == nullptr) return static_cast<int>(cudaGetLastError());
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return static_cast<int>(le);
  rms_norm_dscale_kernel<S><<<(d + kSumCols - 1) / kSumCols,
                              kSumCols * kSumSlices, 0, stream>>>(
      partial, static_cast<S*>(ds), grid, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The body of either pass for ``n_rows`` rows of ``d`` at these dtypes:
// 1 (warp), 0 (block); ``aligned``: the pass's pointers (forward: x,
// scale, y; backward: x, scale, g, dx) start on 16-byte boundaries.
extern "C" int ttd_rms_norm_body(int n_rows, int d, int x_dtype,
                                 int s_dtype, int aligned) {
  return choose_body(n_rows, d, x_dtype, s_dtype, aligned != 0);
}

// x, y: [n_rows, d] contiguous, dtype x_dtype; scale: [d], dtype s_dtype;
// r: [n_rows] f32 or null (not written).  ``body``: -1 the static choice
// (ttd_rms_norm_body), 0 block, 1 warp (refused where it cannot run).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ttd_rms_norm_fwd(const void* x, const void* scale, void* y,
                                void* r, int n_rows, int d, float eps,
                                int x_dtype, int s_dtype, int body,
                                void* stream) {
  if (n_rows <= 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(y);
  const bool aligned = addr % 16 == 0;
  if (body == -1) body = choose_body(n_rows, d, x_dtype, s_dtype, aligned);
  if (body < 0 || body > 1 ||
      (body == 1 && !warp_runs(d, x_dtype, s_dtype, aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rf = static_cast<float*>(r);
  return with_types(x_dtype, s_dtype, d, [&](auto xt, auto s_t, auto nv) {
    using T = decltype(xt);
    using S = decltype(s_t);
    if (body == 1)
      return launch_fwd_warp<T, S, decltype(nv)::value>(x, scale, y, rf,
                                                        n_rows, d, eps, st);
    rms_norm_fwd_kernel<T, S><<<n_rows, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(y), rf, d, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

// Rows of the f32 ``partial`` workspace [rows, d] the warp body takes for
// these rows (its grid); 0 where the warp body cannot run or on a CUDA
// error.
extern "C" int ttd_rms_norm_bwd_partials(int n_rows, int d, int x_dtype,
                                         int s_dtype) {
  if (n_rows <= 0 || !warp_runs(d, x_dtype, s_dtype, true)) return 0;
  int grid = 0;
  size_t smem = 0;
  const int e = with_types(x_dtype, s_dtype, d, [&](auto xt, auto st,
                                                    auto nv) {
    return bwd_warp_grid<decltype(xt), decltype(st), decltype(nv)::value>(
        n_rows, d, &grid, &smem);
  });
  return e ? 0 : grid;
}

// x, g, dx: [n_rows, d] contiguous, dtype x_dtype; scale and ds: [d],
// dtype s_dtype; r: [n_rows] f32 from the forward.  ``ds`` null: no
// dscale.  ``partial``: the warp body's f32 workspace
// [ttd_rms_norm_bwd_partials(...), d] (needed with ds).  ``body``: -1 the
// static choice (ttd_rms_norm_body), 0 block (dx only: ds must be
// null), 1 warp (refused where it cannot run).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ttd_rms_norm_bwd(const void* x, const void* scale,
                                const void* r, const void* g, void* dx,
                                void* ds, void* partial, int n_rows, int d,
                                int x_dtype, int s_dtype, int body,
                                void* stream) {
  if (n_rows <= 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  const bool aligned = addr % 16 == 0;
  if (body == -1) body = choose_body(n_rows, d, x_dtype, s_dtype, aligned);
  if (body < 0 || body > 1 || (body == 0 && ds != nullptr) ||
      (body == 1 && (!warp_runs(d, x_dtype, s_dtype, aligned) ||
                     (ds != nullptr && partial == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  float* pf = static_cast<float*>(partial);
  return with_types(x_dtype, s_dtype, d, [&](auto xt, auto s_t, auto nv) {
    using T = decltype(xt);
    using S = decltype(s_t);
    if (body == 0)
      return launch_bwd_block<T, S>(x, scale, rf, g, dx, n_rows, d, st);
    return launch_bwd_warp<T, S, decltype(nv)::value>(x, scale, rf, g, dx, ds,
                                                      pf, n_rows, d, st);
  });
}
