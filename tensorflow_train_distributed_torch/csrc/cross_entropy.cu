// Fused softmax cross-entropy (integer labels), forward and backward, for
// Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   _ce_fwd (kernel _ce_fwd_kernel): an online logsumexp over 2048-column
//   vocab blocks, loss = lse - logit[label], writing loss and lse [N, 1]
//   f32 (pad columns of the ragged last block at _NEG = -1e30);
//   _cross_entropy_pallas_bwd (kernel _ce_bwd_kernel):
//   dlogits = (exp(logit - lse) - onehot(label)) * g, in logits' dtype.
//
// Bound on this card: bytes.  The forward reads the [N, V] logits once and
//   writes 8 bytes a row; the backward reads them again and writes dlogits
//   of the same size.  One exp an element is far below the SFUs' rate.
//
// Design: one 256-thread block per row; the TPU's sequential vocab-block
//   axis becomes each thread's strided walk over the row, with the running
//   (max, sum) kept per thread from _NEG / 0 exactly like the TPU kernel's
//   scratch, then merged across the block.  Each row of at least four
//   elements a thread is split where it lies: a scalar prologue of 0-3
//   elements up to its first 16-byte (f32) or 8-byte (bf16) boundary, the
//   vector loop, then a scalar tail; so a vocabulary whose rows are not
//   all aligned (BERT's 30,522 f32: every other row starts 8 bytes off)
//   still streams at vector width; shorter rows stay scalar.  The
//   backward vectorises a row where dlogits' row has logits' offset from a
//   boundary, and walks a long row with 1024 threads.  There is no
//   padding here: columns past V are simply not visited, which is what
//   masking them to _NEG amounts to.  Labels are int32 in [0, V).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The backward walks a row of 4096 elements or more with 1024 threads: at
// [32768, 30522] f32 it measured 2,737 us (1.15x its byte bound) against
// 2,897 with 256 threads keeping two loads in flight each (chip_smoke.py
// phase 12; PERF.md §6).  Shorter rows keep 256.
constexpr int kWideThreads = 1024;
constexpr int kWideRow = 4096;
constexpr float kNeg = -1e30f;

struct MaxSum {
  float m, l;
};

__device__ __forceinline__ void absorb(MaxSum& a, float v) {
  if (v > a.m) {
    a.l = a.l * expf(a.m - v) + 1.f;
    a.m = v;
  } else {
    a.l += expf(v - a.m);
  }
}

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.l * expf(a.m - m) + b.l * expf(b.m - m)};
}

// Loads 4 consecutive elements as f32 (16-byte f32 or 8-byte bf16 loads).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(b); out[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0],
                                                                     v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2],
                                                                     v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The first element of a row at which its vector loads may start: 0 to 3
// scalar elements reach the next multiple of a vector's bytes (16 for
// f32, 8 for bf16).  Capped at v.
template <typename T>
__device__ __forceinline__ int prologue(const T* row, int v) {
  constexpr unsigned kVec = 4 * sizeof(T);
  const unsigned off = reinterpret_cast<uintptr_t>(row) % kVec;
  return min(v, static_cast<int>((kVec - off) % kVec / sizeof(T)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ logits,
                  const int* __restrict__ labels, float* __restrict__ loss,
                  float* __restrict__ lse_out, int v) {
  const long long row = blockIdx.x;
  const T* xr = logits + row * v;
  MaxSum acc{kNeg, 0.f};
  // A scalar prologue up to the row's first vector boundary, the vector
  // loop, then a scalar tail; a row too short to give every thread a
  // vector stays scalar (the split cost LeNet's 10 classes 0.5 us a call).
  const int pre = v < 4 * kThreads ? v : prologue(xr, v);
  const int nvec = (v - pre) / 4;
  const T* xs = xr + pre;
  for (int i = threadIdx.x; i < pre; i += kThreads)
    absorb(acc, ttd::to_f32(xr[i]));
  for (int j = threadIdx.x; j < nvec; j += kThreads) {
    float e[4];
    load4(xs + 4 * j, e);
#pragma unroll
    for (int k = 0; k < 4; ++k) absorb(acc, e[k]);
  }
  for (int i = pre + 4 * nvec + threadIdx.x; i < v; i += kThreads)
    absorb(acc, ttd::to_f32(xr[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    MaxSum other{__shfl_xor_sync(0xffffffffu, acc.m, o),
                 __shfl_xor_sync(0xffffffffu, acc.l, o)};
    acc = merge(acc, other);
  }
  __shared__ MaxSum partial[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    MaxSum total = partial[0];
    for (int w = 1; w < kWarps; ++w) total = merge(total, partial[w]);
    const float lse = total.m + logf(total.l);
    const int label = labels[row];
    const float ll =
        (label >= 0 && label < v) ? ttd::to_f32(xr[label]) : 0.f;
    lse_out[row] = lse;
    loss[row] = lse - ll;
  }
}

__device__ __forceinline__ float dlogit(float x, int i, int label, float lse,
                                        float gr) {
  return (expf(x - lse) - (i == label ? 1.f : 0.f)) * gr;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ce_bwd_kernel(const T* __restrict__ logits,
                  const int* __restrict__ labels,
                  const float* __restrict__ lse_in,
                  const float* __restrict__ g, T* __restrict__ dlogits,
                  int v) {
  const long long row = blockIdx.x;
  const T* xr = logits + row * v;
  T* dr = dlogits + row * v;
  const float lse = lse_in[row];
  const float gr = g[row];
  const int label = labels[row];
  // The forward's split of the row where dlogits' row lies as far from a
  // vector boundary as logits' (always, for rows of one allocation's
  // layout) and the row gives every thread a vector; else the whole row
  // scalar.
  constexpr unsigned kVec = 4 * sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(xr) % kVec ==
                   reinterpret_cast<uintptr_t>(dr) % kVec;
  const int pre = vec && v >= 4 * THREADS ? prologue(xr, v) : v;
  const int nvec = (v - pre) / 4;
  for (int i = threadIdx.x; i < pre; i += THREADS)
    dr[i] = ttd::from_f32<T>(dlogit(ttd::to_f32(xr[i]), i, label, lse,
                                    gr));
  const T* xs = xr + pre;
  T* ds = dr + pre;
  for (int j = threadIdx.x; j < nvec; j += THREADS) {
    float e[4];
    load4(xs + 4 * j, e);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[k] = dlogit(e[k], pre + 4 * j + k, label, lse, gr);
    store4(ds + 4 * j, e);
  }
  for (int i = pre + 4 * nvec + threadIdx.x; i < v; i += THREADS)
    dr[i] = ttd::from_f32<T>(dlogit(ttd::to_f32(xr[i]), i, label, lse,
                                       gr));
}

template <typename T>
void launch_bwd(const T* logits, const int* labels, const float* lse,
                const float* g, T* dlogits, int n_rows, int v,
                cudaStream_t st) {
  if (v >= kWideRow)
    ce_bwd_kernel<T, kWideThreads><<<n_rows, kWideThreads, 0, st>>>(
        logits, labels, lse, g, dlogits, v);
  else
    ce_bwd_kernel<T, kThreads><<<n_rows, kThreads, 0, st>>>(
        logits, labels, lse, g, dlogits, v);
}

}  // namespace

// logits: [n_rows, v] contiguous (f32 or bf16); labels: [n_rows] int32;
// loss, lse: [n_rows] f32.  Returns cudaGetLastError() after the launch.
extern "C" int ttd_cross_entropy_fwd(const void* logits, const void* labels,
                                     void* loss, void* lse, int n_rows,
                                     int v, int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == ttd::kF32) {
    ce_fwd_kernel<float><<<n_rows, kThreads, 0, st>>>(
        static_cast<const float*>(logits), lab, lo, ls, v);
  } else if (dtype == ttd::kBF16) {
    ce_fwd_kernel<__nv_bfloat16><<<n_rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, lo, ls, v);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, dlogits: [n_rows, v] contiguous, same dtype; labels [n_rows]
// int32; lse, g: [n_rows] f32.
extern "C" int ttd_cross_entropy_bwd(const void* logits, const void* labels,
                                     const void* lse, const void* g,
                                     void* dlogits, int n_rows, int v,
                                     int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  if (dtype == ttd::kF32) {
    launch_bwd(static_cast<const float*>(logits), lab, ls, gf,
               static_cast<float*>(dlogits), n_rows, v, st);
  } else if (dtype == ttd::kBF16) {
    launch_bwd(static_cast<const __nv_bfloat16*>(logits), lab, ls, gf,
               static_cast<__nv_bfloat16*>(dlogits), n_rows, v, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
