// Paged KV gather for Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   paged_kv_gather (kernel _paged_gather_kernel): a block copy
//   out[lane, j*bs:(j+1)*bs] = pool[table[lane, j]], cut to cache_len.
//   The serving engine runs it where a radix-prefix hit reads a lane's
//   shared rows out of the block pool into a batch-1 prefill cache.
//
// Bound on this card: bytes (a copy: every output byte is read once and
//   written once; no arithmetic).
//
// Design: grid (logical block j, lane); each 256-thread block copies one
//   block's rows, whose bytes are contiguous in both the pool and the
//   output.  The TPU kernel's scalar prefetch becomes one table load per
//   block.  Bytes move as 16-byte vectors when source and destination are
//   16-byte aligned, with a byte tail for rows that are not a multiple of
//   16 bytes (the int8 engine's f32 scale pool viewed as [nb, bs, kvh, 1]
//   has 4*kvh-byte rows); otherwise byte by byte.  A copy: the output is
//   bit-identical to the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    paged_kv_gather_kernel(const uint8_t* __restrict__ pool,
                           const int* __restrict__ table,
                           uint8_t* __restrict__ out, int n_blk, int nb,
                           int bs, long long row_bytes, int cache_len) {
  const int j = blockIdx.x;
  const int lane = blockIdx.y;
  const int rows = min(bs, cache_len - j * bs);
  if (rows <= 0) return;
  int phys = table[static_cast<long long>(lane) * n_blk + j];
  phys = min(max(phys, 0), nb - 1);  // never read outside the pool
  const uint8_t* src = pool + static_cast<long long>(phys) * bs * row_bytes;
  uint8_t* dst = out + (static_cast<long long>(lane) * cache_len +
                        static_cast<long long>(j) * bs) *
                           row_bytes;
  const long long nbytes = rows * row_bytes;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const long long n16 = nbytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < n16; i += kThreads) d4[i] = s4[i];
    done = n16 << 4;
  }
  for (long long i = done + threadIdx.x; i < nbytes; i += kThreads)
    dst[i] = src[i];
}

}  // namespace

// pool: [nb, bs, row_bytes] bytes; table: [lanes, n_blk] int32;
// out: [lanes, cache_len, row_bytes] bytes with cache_len <= n_blk * bs.
extern "C" int ttd_paged_kv_gather(const void* pool, const void* table,
                                   void* out, int lanes, int n_blk, int nb,
                                   int bs, long long row_bytes, int cache_len,
                                   void* stream) {
  if (lanes <= 0 || cache_len <= 0 || row_bytes <= 0) return 0;
  if (cache_len > n_blk * bs || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cache_len + bs - 1) / bs, lanes);
  paged_kv_gather_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int*>(table),
      static_cast<uint8_t*>(out), n_blk, nb, bs, row_bytes, cache_len);
  return static_cast<int>(cudaGetLastError());
}
