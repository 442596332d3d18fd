// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   _rmsnorm_fwd_call (kernel _rmsnorm_fwd_kernel): per row
//   y = x * rsqrt(mean(x^2) + eps) * s, accumulated in f32.  The TPU kernel
//   also writes r for its backward; serving needs no backward, so this one
//   writes y only (the backward comes with the training slice).
//
// Bound on this card: bytes.  Each row is read, reduced and written once:
//   N*D elements in, N*D out, D scale values, against ~4 flops an element,
//   far below the 295 flop/byte ridge of the H100.
//
// Design: one 256-thread block per row.  Pass 1 accumulates the squares in
//   f32 (strided, coalesced loads) and reduces with warp shuffles plus one
//   shared-memory step; pass 2 re-reads the row (it is still in L1/L2 at
//   D = 4096) and writes y in x's dtype.  Simple first: no vector loads
//   and no multi-row blocks yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ y, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = ttd::to_f32(xr[i]);
    acc += v * v;
  }
  __shared__ float partial[kWarps];
  __shared__ float r_shared;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  acc = ttd::warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? partial[lane] : 0.f;
    s = ttd::warp_sum(s);
    if (lane == 0) r_shared = rsqrtf(s / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = r_shared;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = ttd::from_f32<T>(ttd::to_f32(xr[i]) * r * ttd::to_f32(scale[i]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int n_rows, int d,
           float eps, cudaStream_t stream) {
  rms_norm_fwd_kernel<T, S><<<n_rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [n_rows, d] contiguous, dtype x_dtype; scale: [d], dtype s_dtype.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ttd_rms_norm_fwd(const void* x, const void* scale, void* y,
                                int n_rows, int d, float eps, int x_dtype,
                                int s_dtype, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == ttd::kF32 && s_dtype == ttd::kF32)
    return launch<float, float>(x, scale, y, n_rows, d, eps, st);
  if (x_dtype == ttd::kF32 && s_dtype == ttd::kBF16)
    return launch<float, bf16>(x, scale, y, n_rows, d, eps, st);
  if (x_dtype == ttd::kBF16 && s_dtype == ttd::kF32)
    return launch<bf16, float>(x, scale, y, n_rows, d, eps, st);
  if (x_dtype == ttd::kBF16 && s_dtype == ttd::kBF16)
    return launch<bf16, bf16>(x, scale, y, n_rows, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
