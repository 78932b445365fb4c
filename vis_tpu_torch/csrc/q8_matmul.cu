// Int8 weight-only matmul for Hopper (sm_90a): y[B, O] f32 = (x[B, I] . q[O, I]^T) * scale[O]
//
// Replaces the Pallas TPU kernel D of the JAX package:
//   vis_tpu/ops/quantized.py:_q8_matmul_kernel (driver quantized_matmul) ->
//   entry vt_q8_matmul.  On the port's main path it is the explainer's int8
//   vocab head, [128512, 4096] (128256 rows padded to a 512 multiple), at
//   B = 3 in batched decode and B = 1 at the end of each prefill.
//
// Semantics are the TPU kernel's, not the JAX CPU fallback's: x is rounded to
// bf16, each int8 weight converts to float exactly, the products are summed
// in f32, and the sum is multiplied by scale[o] once, after the sum.  Rows
// padded with q = 0 and scale = 0 therefore give exactly 0.
//
// What bounds it: at B = 3 the head streams 526 MB of int8 weight a step for
// ~1.6 GFLOP, about 3 flops a byte, far below the ~295 flop/byte where an
// H100 turns compute-bound; the floor is the weight read, ~0.16 ms at
// 3.35 TB/s.  The design therefore reads each weight byte exactly once, 16
// bytes a lane and 512 contiguous bytes a warp, and keeps x off the weight
// stream's way: a block stages x for up to 8 batch rows in shared memory, in
// chunks of 2048 columns (32 KB of bf16; at B = 3 and I = 4096 all of x is
// 24 KB), and every warp reads it from there for 4 output rows at once.
// (Kernel A reads all of x again through L1/L2 for each output row, which is
// 30x its weight bytes at B = 8; D does not.)  Each lane keeps f32 partial
// sums for its 4 rows x 8 batch rows in registers, and one warp reduction
// per (row, batch row) finishes the sum.  A simple, correct first version:
// no tensor cores, no TMA, no cp.async pipelining between chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;                       // output rows a warp owns
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kBatchPerPass = 8;                      // batch rows per x stage
constexpr int kChunk = 2048;                          // x columns per stage

// 8 bf16 values (16 bytes) of shared memory -> 8 floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(pairs[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// 16 int8 values (one 16-byte load) -> 16 floats, exactly.
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int8_t v = static_cast<int8_t>((words[k >> 2] >> (8 * (k & 3))) & 0xffu);
    out[k] = static_cast<float>(v);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    q8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int B, int O, int I) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBatchPerPass * kChunk];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp;

  for (int b0 = 0; b0 < B; b0 += kBatchPerPass) {
    const int nb = min(kBatchPerPass, B - b0);
    float acc[kRowsPerWarp][kBatchPerPass];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int r = 0; r < kBatchPerPass; ++r) acc[j][r] = 0.f;

    for (int k0 = 0; k0 < I; k0 += kChunk) {
      const int kc = min(kChunk, I - k0);
      // Stage x[b0:b0+nb, k0:k0+kc]; the barrier before it waits for the
      // previous stage's readers.
      __syncthreads();
      const int vecs = kc / 8;
      for (int v = threadIdx.x; v < nb * vecs; v += blockDim.x) {
        const int r = v / vecs;
        const int c = (v - r * vecs) * 8;
        *reinterpret_cast<uint4*>(xs + r * kChunk + c) =
            *reinterpret_cast<const uint4*>(x + static_cast<size_t>(b0 + r) * I + k0 + c);
      }
      __syncthreads();

      for (int c = 16 * lane; c < kc; c += 512) {
        uint4 raw[kRowsPerWarp];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          raw[j] = make_uint4(0u, 0u, 0u, 0u);
          if (row0 + j < O)
            raw[j] = *reinterpret_cast<const uint4*>(
                q + static_cast<size_t>(row0 + j) * I + k0 + c);
        }
        float w[kRowsPerWarp][16];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) unpack16(raw[j], w[j]);
#pragma unroll
        for (int r = 0; r < kBatchPerPass; ++r) {
          if (r < nb) {
            float xv[16];
            load8(xs + r * kChunk + c, xv);
            load8(xs + r * kChunk + c + 8, xv + 8);
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) {
              float sum = acc[j][r];
#pragma unroll
              for (int k = 0; k < 16; ++k) sum = fmaf(xv[k], w[j][k], sum);
              acc[j][r] = sum;
            }
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int r = 0; r < kBatchPerPass; ++r) {
        float v = acc[j][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        const int o = row0 + j;
        if (lane == 0 && r < nb && o < O)
          y[static_cast<size_t>(b0 + r) * O + o] = v * scale[o];
      }
    }
  }
}

}  // namespace

// x: [B, I] bf16, q: [O, I] int8, scale: [O] f32, y: [B, O] f32.  Every
// pointer 16-byte aligned, every array contiguous, I % 16 == 0 (the wrapper
// checks).
extern "C" int vt_q8_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int I, void* stream) {
  if (B < 1 || O < 1 || I < 16 || I % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kRowsPerBlock - 1) / kRowsPerBlock);
  q8_matmul_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, I);
  return static_cast<int>(cudaGetLastError());
}
