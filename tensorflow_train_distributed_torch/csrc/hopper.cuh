// Hopper (sm_90a) building blocks of the attention kernels and the
// grouped matmuls: mbarriers, cp.async copies in commit groups (paged
// attention's ring), TMA tile loads through a tensor map, bulk copies
// between global and shared memory (the paged KV gather's ring), wgmma
// over 128-byte-swizzled shared-memory tiles, register rebalancing
// between warpgroups, and the host-side encoding of tensor maps for a
// strided [B, H, S, D] operand and for a row-major [rows, cols] one.
//
// An f32 tile (the grouped matmuls' f32 operand, the split attention
// body's operands) sits as TMA writes it with the same swizzle: panels of
// 32 columns (128 bytes), the 16-byte chunk c of row r at chunk c ^ (r %
// 8); it is read by threads, not by wgmma.
//
// Tile layout.  A tile of R rows x D bf16 columns sits in shared memory
// as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B: D / 64 panels, one
// after the other, each R rows of 128 bytes (64 columns), the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8).  Every panel starts on a
// 1024-byte boundary.  wgmma reads such a tile through a descriptor
// (layout type 1, 128-byte swizzle):
//   K-major (the tile's columns are the product's depth):  16 columns
//     further is 32 bytes further inside the panel, 64 columns one panel
//     further; SBO = 1024 bytes (8 rows), LBO unused.
//   MN-major (the tile's rows are the depth, its columns the product's
//     N; the transpose bit set):  16 rows further is 2048 bytes further;
//     LBO = the panel's bytes (the next 64 columns), SBO = 1024 bytes
//     (the next 8 rows).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached
                    // through the runtime, so no -lcuda link is needed
#include "common.cuh"

namespace ttd_hopper {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds ``bytes`` to the transaction count the phase
// waits for (the TMA loads issued after it complete them).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity ``parity`` has completed (a fresh
// barrier counts the phase before its first, of parity 1, as complete).
// A phase that never completes (a fault in the ring's bookkeeping) traps
// after about 2^34 cycles (~9 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// -- cp.async ------------------------------------------------------------------

// 16 bytes from global memory (through L2 only) into shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 4 bytes from global into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Closes this thread's group of cp.async copies issued since the last
// commit (an empty group where there were none).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- TMA -----------------------------------------------------------------------

// One box of the rank-4 map (D, S, H, B) at coordinates (c0, c1, c2, c3)
// into shared memory at ``dst``, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Rows [row0, row0 + R) of head ``h``, batch row ``b`` of a map with
// 64 x 64 boxes into an R-row swizzled tile (R a multiple of 64); rows
// at or past S arrive as zeros.  Adds R * D * 2 bytes to ``bar``'s
// transaction count.
template <int R, int D>
__device__ __forceinline__ void tma_load_rows(bf16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row0, int h,
                                              int b) {
#pragma unroll
  for (int panel = 0; panel < D / 64; ++panel)
#pragma unroll
    for (int c = 0; c < R / 64; ++c)
      tma_load_4d(dst + (panel * R + c * 64) * 64, map, bar, panel * 64,
                  row0 + c * 64, h, b);
}

// One box of a rank-2 map (cols, rows) at (c0, c1), or of a rank-3 map
// (cols, rows, batch) at (c0, c1, c2), into shared memory at ``dst``,
// completing on ``bar`` (maps from ``make_map_rows``).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// ``bytes`` contiguous bytes (16-byte aligned, a multiple of 16) from
// global memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An L2 cache policy that makes the lines an access touches the first to
// be evicted (data read or written once, as a copy's).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// bulk_load under the L2 cache policy ``policy``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy)
      : "memory");
}

// ``bytes`` contiguous bytes (16-byte aligned, a multiple of 16) from
// shared memory to global memory under the L2 cache policy ``policy``, in
// this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes), "l"(policy) : "memory");
}

// Closes this thread's bulk group of stores issued since the last commit.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared memory (the stages of the older ones may be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Waits until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before later ones
// of the async proxy (bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- warpgroups ------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Named barrier ``id`` (1..15) over ``n`` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Depth step ``kk`` (16 columns) of rows [row0, row0 + 64) of an R-row
// tile read K-major.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0,
                                           int kk) {
  return sw128_desc(tile + (kk / 4) * R * 64 + row0 * 64 + (kk % 4) * 16, 16,
                    1024);
}

// Depth step ``kk`` (16 rows) of an R-row tile read MN-major.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return sw128_desc(tile + kk * 16 * 64, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Orders the compiler's uses of accumulator registers around the
// asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64, 64] (+)= A[64, 16] . B[16, 64], A and B in shared memory
// (descriptors), K-major unless TA / TB set the operand's transpose bit
// (MN-major); ``accumulate`` = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// d[64, 128] (+)= A[64, 16] . B[16, 128], as wgmma_ss_n64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// d[64, 64] (+)= A[64, 16] . B[16, 64], A in registers (four bf16x2
// fragments, the layout of mma.sync m16n8k16's A), B in shared memory,
// MN-major (TB = 1, the transpose bit set) or K-major; ``accumulate`` = 0
// overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TB)
      : "memory");
}

// d[64, 128] (+)= A[64, 16] . B[16, 128], as wgmma_rs_n64.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TB)
      : "memory");
}

// Both forms at N 64 or 128; the defaults are the attention kernels'
// (K-major A and B for wgmma_ss, MN-major B accumulating for wgmma_rs).
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, accumulate);
  else wgmma_ss_n128<TA, TB>(d, da, db, accumulate);
}

template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int accumulate = 1) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, accumulate);
  else wgmma_rs_n128<TB>(d, a, db, accumulate);
}

// -- host: tensor maps ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The encoder, with a context current on the calling thread: the driver's
// encoder needs one, and a thread whose first CUDA call this is (autograd's
// backward thread) has none until the runtime binds the device's primary
// context, which setting the device does.
inline EncodeTiled encoder() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  return encode_tiled();
}

// A rank-4 map (D, S, H, B) of a bf16 or f32 (``dtype``: ttd::DType)
// [B, H, S, D] operand with element strides (sb, sh, ss) and D
// contiguous: boxes of 128 bytes (64 bf16 or 32 f32 columns) x 64 rows,
// 128-byte swizzle, rows past S read as zeros.  Returns false where the
// driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, long long sb,
                     long long sh, long long ss, int b, int h, int s, int d,
                     int dtype = ttd::kBF16) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || (dtype != ttd::kF32 && dtype != ttd::kBF16))
    return false;
  const int bytes = dtype == ttd::kF32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * bytes,
                                 static_cast<cuuint64_t>(sh) * bytes,
                                 static_cast<cuuint64_t>(sb) * bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / bytes), 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, dtype == ttd::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a row-major [rows, cols] operand (rank 2: (cols, rows)) or,
// when ``batches`` > 0, of [batches, rows, cols] (rank 3: (cols, rows,
// batch)), of f32 or bf16
// (``dtype``: ttd::DType), cols contiguous: boxes of ``box_cols`` x
// ``box_rows`` (box_cols * element bytes <= 128), 128-byte swizzle;
// elements past any edge read as zeros.  Needs a 16-byte aligned base
// and a row of a multiple of 16 bytes.  Returns false where the driver
// refuses it.
inline bool make_map_rows(CUtensorMap* map, const void* base, int dtype,
                          long long batches, long long rows, long long cols,
                          int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || (dtype != ttd::kF32 && dtype != ttd::kBF16))
    return false;
  const int bytes = dtype == ttd::kF32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * bytes,
                                 static_cast<cuuint64_t>(rows * cols) * bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, dtype == ttd::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                batches > 0 ? 3 : 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ttd_hopper
