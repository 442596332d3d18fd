// Paged KV gather for Hopper (sm_90a).
//
// Replaces: tensorflow_train_distributed_tpu/ops/pallas_kernels.py
//   paged_kv_gather (kernel _paged_gather_kernel): a block copy
//   out[lane, j*bs:(j+1)*bs] = pool[table[lane, j]], cut to cache_len.
//   The serving engine runs it where a radix-prefix hit reads a lane's
//   shared rows out of the block pool into a batch-1 prefill cache: one
//   lane, 64 blocks of 16 rows at cache_len 1,024, 32 layers x K and V.
//
// Bound on this card: bytes (a copy: every output byte is read once and
//   written once; no arithmetic).
//
// Two bodies, chosen statically (``choose_body``); each is a copy, so
//   the output is bit-identical to the reference whichever runs.  The
//   table's physical ids are clamped into the pool.
//   bulk (the rule where every copy is whole 16-byte vectors and pool and
//     output are 16-byte aligned): the copies (lane, logical block j) are
//     cut into 8 KiB chunks, numbered lane-major, and a grid of as many
//     blocks as the SMs hold at once walks them, so that one lane's 64
//     blocks cover the whole card.  The Tensor Memory Accelerator moves
//     them: one thread a block issues cp.async.bulk loads into a ring of
//     kStages shared-memory stages, each completing on its mbarrier,
//     stores each stage with a bulk store in its own bulk group, and loads
//     the stage again once that store has read it; loads and stores carry
//     an L2 evict-first policy (every byte is touched once).  On an H100
//     80GB HBM3 at 700 W both the engine's one lane and eight lanes copy
//     at ~2.7 TB/s of the 3.35; a body of 16-byte vector copies, 256
//     threads a chunk, ran ~3% faster on one lane and ~1% slower on eight
//     (PERF.md).
//   block (every other copy: rows that are not whole 16-byte vectors,
//     such as the int8 engine's f32 scale pool viewed as [nb, bs, kvh, 1]
//     when kvh is not a multiple of 4, or a misaligned pool): grid
//     (logical block j, lane); each 256-thread block copies one block's
//     rows, 16-byte vectors where source and destination allow them, with
//     a byte tail; otherwise byte by byte.
#include "hopper.cuh"

namespace {

namespace hw = ttd_hopper;

constexpr int kThreads = 256;   // block body
constexpr int kStages = 8;      // bulk body: ring stages of kStageBytes
constexpr int kStageBytes = 8192;

struct Gather {
  const uint8_t* pool;
  const int* table;
  uint8_t* out;
  int n_blk, nb, bs, cache_len;
  long long row_bytes;
  int used;              // logical blocks a lane copies: ceil(cache_len / bs)
  int pieces;            // chunks of kStageBytes a logical block
  long long total;       // chunks in all: lanes * used * pieces
};

// Chunk t: where it reads, where it writes and how many bytes (<= 0: a
// piece past the end of a short last block).
struct Piece {
  const uint8_t* src;
  uint8_t* dst;
  long long bytes;
};

__device__ __forceinline__ Piece piece_at(const Gather& a, long long t) {
  const long long per_lane = static_cast<long long>(a.used) * a.pieces;
  const int lane = static_cast<int>(t / per_lane);
  const long long rest = t - lane * per_lane;
  const int j = static_cast<int>(rest / a.pieces);
  const int k = static_cast<int>(rest - static_cast<long long>(j) * a.pieces);
  const int rows = min(a.bs, a.cache_len - j * a.bs);
  int phys = __ldg(a.table + static_cast<long long>(lane) * a.n_blk + j);
  phys = min(max(phys, 0), a.nb - 1);  // never read outside the pool
  const long long off = static_cast<long long>(k) * kStageBytes;
  Piece p;
  p.bytes = min(static_cast<long long>(kStageBytes),
                rows * a.row_bytes - off);
  p.src = a.pool + static_cast<long long>(phys) * a.bs * a.row_bytes + off;
  p.dst = a.out + (static_cast<long long>(lane) * a.cache_len +
                   static_cast<long long>(j) * a.bs) * a.row_bytes + off;
  return p;
}

// One warp a block; lane 0 runs the ring.  Shared memory: kStages stages
// of kStageBytes, then one mbarrier a stage.
__global__ void __launch_bounds__(32) gather_bulk_kernel(const Gather a) {
  extern __shared__ __align__(128) uint8_t ring[];
  if (threadIdx.x != 0) return;
  const uint64_t policy = hw::evict_first_policy();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  for (int s = 0; s < kStages; ++s) hw::mbar_init(&full[s], 1);
  hw::mbar_init_fence();
  // This block's chunks: blockIdx.x + k * gridDim.x for k < n.
  const long long n = (a.total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto load = [&](long long k) {
    const Piece p = piece_at(a, blockIdx.x + k * gridDim.x);
    const int s = static_cast<int>(k % kStages);
    const uint32_t bytes = p.bytes > 0 ? static_cast<uint32_t>(p.bytes) : 0;
    hw::mbar_expect_tx(&full[s], bytes);
    if (bytes)
      hw::bulk_load(ring + s * kStageBytes, p.src, bytes, &full[s], policy);
  };
  for (long long k = 0; k < n && k < kStages; ++k) load(k);
  for (long long k = 0; k < n; ++k) {
    const int s = static_cast<int>(k % kStages);
    hw::mbar_wait(&full[s], static_cast<int>((k / kStages) & 1));
    const Piece p = piece_at(a, blockIdx.x + k * gridDim.x);
    if (p.bytes > 0) {
      hw::fence_proxy_async();
      hw::bulk_store(p.dst, ring + s * kStageBytes,
                     static_cast<uint32_t>(p.bytes), policy);
    }
    hw::bulk_commit();
    // The previous chunk's stage, once its store has read it, takes the
    // chunk kStages - 1 further on; kStages - 1 loads stay in flight.
    if (k >= 1 && k - 1 + kStages < n) {
      hw::bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  hw::bulk_wait_all();
}

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

// The body for rows of ``row_bytes`` with pool and output ``aligned`` to
// 16 bytes: 1 (bulk) where every copy is whole 16-byte vectors, else 0
// (block).
int choose_body(long long row_bytes, bool aligned) {
  return aligned && row_bytes % 16 == 0 ? 1 : 0;
}

}  // namespace

// The body for these rows: 0 block, 1 bulk; ``aligned``: pool and output
// start on 16-byte boundaries.
extern "C" int ttd_paged_kv_gather_body(long long row_bytes, int aligned) {
  return choose_body(row_bytes, aligned != 0);
}

// pool: [nb, bs, row_bytes] bytes; table: [lanes, n_blk] int32;
// out: [lanes, cache_len, row_bytes] bytes with cache_len <= n_blk * bs.
// ``body``: -1 the static choice (ttd_paged_kv_gather_body), 0 block,
// 1 bulk (refused where it cannot run).
extern "C" int ttd_paged_kv_gather(const void* pool, const void* table,
                                   void* out, int lanes, int n_blk, int nb,
                                   int bs, long long row_bytes, int cache_len,
                                   int body, void* stream) {
  if (lanes <= 0 || cache_len <= 0 || row_bytes <= 0) return 0;
  if (cache_len > n_blk * bs) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(pool) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int runs = choose_body(row_bytes, aligned);
  if (body == -1) body = runs;
  if (body < 0 || body > runs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    if (lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((cache_len + bs - 1) / bs, lanes);
    paged_kv_gather_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(pool), static_cast<const int*>(table),
        static_cast<uint8_t*>(out), n_blk, nb, bs, row_bytes, cache_len);
    return static_cast<int>(cudaGetLastError());
  }
  Gather a;
  a.pool = static_cast<const uint8_t*>(pool);
  a.table = static_cast<const int*>(table);
  a.out = static_cast<uint8_t*>(out);
  a.n_blk = n_blk;
  a.nb = nb;
  a.bs = bs;
  a.cache_len = cache_len;
  a.row_bytes = row_bytes;
  a.used = (cache_len + bs - 1) / bs;
  a.pieces =
      static_cast<int>((bs * row_bytes + kStageBytes - 1) / kStageBytes);
  a.total = static_cast<long long>(lanes) * a.used * a.pieces;
  // As many blocks as the SMs hold at once, at most one a chunk.
  const size_t smem = kStages * (kStageBytes + sizeof(uint64_t));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_bulk_kernel, 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  const int grid = static_cast<int>(a.total < resident ? a.total : resident);
  gather_bulk_kernel<<<grid, 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
