// PTX helpers shared by the tensor-core matvecs (q4_matmul.cu, q8_matmul.cu,
// int_dot.cu): streaming 16-byte weight loads (with or without a 256-byte L2
// fetch), 16-byte shared-memory reads, cp.async staging, one
// mma.sync.m16n8k16 (bf16 -> f32) and one mma.sync.m16n8k32 (s8 -> s32), the
// card's SM count, and the rule that sizes the int4 matvecs' blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The same load, asking L2 to fetch the whole 256-byte block around it from
// device memory.  A warp's load takes 64 bytes of each of 8 rows, and the
// next chunks of those rows follow; on an H100 the larger fetch moved the
// int8 matvec's weight stream from ~1.9 to ~2.4 TB/s.
__device__ __forceinline__ uint4 ldg_stream256(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16x8] += a[16x32] . b[32x8], s8 operands, s32 accumulators: exact
// integer sums.  a0 / a1 hold rows g / g + 8 at k = 4t..4t+3, a2 / a3 the
// same rows at k = 16+4t..16+4t+3; b0 / b1 column g at those k; d as
// mma_bf16's (row g, columns 2t / 2t+1 in 0 / 1, row g + 8 in 2 / 3).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

int num_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

// How a matvec's 16-row tiles go to blocks of warps, on the host.  With one
// n-tile a pass (`warp_a_tile`) and enough tiles (at least `base_warps` a
// SM), a warp a tile, whole K, in blocks of base_warps to max_warps warps:
// the size that puts the fewest tiles on the busiest SM (blocks go round the
// SMs in turn), and of equals the largest, which stages x the fewest times.
// Otherwise blocks of base_warps warps split K the fewest ways (at most
// base_warps: a warp each) that give every SM two blocks.
void block_shape(bool warp_a_tile, int tiles, int passes, int batches, int base_warps,
                 int max_warps, int& warps, int& splits) {
  const int sms = num_sms();
  warps = base_warps, splits = 1;
  if (warp_a_tile && tiles * batches >= base_warps * sms) {
    int best = 0;
    for (int w = base_warps; w <= max_warps; ++w) {
      const int busiest = (((tiles + w - 1) / w * batches + sms - 1) / sms) * w;
      if (best == 0 || busiest <= best) best = busiest, warps = w;
    }
  } else {
    while (splits < base_warps &&
           (tiles + base_warps / splits - 1) / (base_warps / splits) * passes * batches < 2 * sms)
      splits *= 2;
  }
}

}  // namespace
