// Int4 weight-only matmul for Hopper (sm_90a): y[B, O] f32 = x[B, I] . W[O, I]^T
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B: vis_tpu/ops/quantized.py:_q4_matmul_kernel  (one [O, I/2] weight; the
//      int4 vocab head)                          -> entry vt_q4_matmul
//   A: vis_tpu/ops/quantized.py:_q4_stacked_kernel (layer `idx` of a stacked
//      [L, O, I/2] weight; every decoder projection of a lookahead window)
//                                                 -> entry vt_q4_matmul_stacked
// Both share q4_rows() below and differ only in their kernel symbol, so a
// profiler and the launch counters can tell them apart.  The stacked entry is
// handed the picked layer's pointer: in torch `stack.q[idx]` is a view.
//
// Weight layout (same bytes as the JAX package): q[o, j] packs input j in the
// low nibble and input j + I/2 in the high nibble, both stored as value + 8;
// scale[o] = {s_lo, s_hi}.  The weight a product sees is
//     w = bf16((nibble - 8) * s)
// i.e. the JAX package's dequantized bf16 weight (unpack_int4), so this kernel
// and its plain PyTorch version agree up to the order of f32 accumulation.
// (The TPU kernel folded the -8 into a -8*sum(x) correction, a lane-op trick
// for the TPU's vector unit; a per-nibble subtract is cheap here.)
//
// What bounds it: at the decode shapes (B = 1 or 8 rows) the kernel streams
// O * I/2 bytes of packed weight plus 8 bytes of scale per row and does
// 2 * B * O * I flops, far below the ~295 flop/byte where an H100 turns
// compute-bound, so it is bound by weight bytes.  The design therefore reads
// each weight byte exactly once, 16 bytes per lane and 512 contiguous bytes
// per warp, keeps all B rows' partial sums in registers, and reads x (at most
// 8 x 18944 bf16 = 303 KB for down_proj, above the 227 KB of shared memory a
// block may have) through L1/L2 instead of staging it.  One warp owns one
// output row; a block holds 8 warps.  A simple, correct first version: no
// tensor cores, no cp.async pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerPass = 8;  // batch rows whose sums live in registers

__device__ __forceinline__ float dequant(uint32_t nibble, float s) {
  return __bfloat162float(
      __float2bfloat16_rn(static_cast<float>(static_cast<int>(nibble) - 8) * s));
}

// 8 bf16 values (16 bytes) -> 8 floats.
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

__device__ __forceinline__ void q4_rows(const __nv_bfloat16* __restrict__ x,
                                        const uint8_t* __restrict__ q,
                                        const float* __restrict__ scale,
                                        float* __restrict__ y, int B, int O,
                                        int half) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (o >= O) return;
  const uint8_t* qrow = q + static_cast<size_t>(o) * half;
  const float s_lo = scale[2 * o];
  const float s_hi = scale[2 * o + 1];
  const int in_dim = 2 * half;
  const int chunks = half / 16;

  for (int b0 = 0; b0 < B; b0 += kRowsPerPass) {
    const int nb = min(kRowsPerPass, B - b0);
    float acc[kRowsPerPass];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) acc[r] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
      const uint4 packed = *reinterpret_cast<const uint4*>(qrow + 16 * c);
      const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
      float w_lo[16], w_hi[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t byte = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
        w_lo[k] = dequant(byte & 15u, s_lo);
        w_hi[k] = dequant(byte >> 4, s_hi);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr =
              x + static_cast<size_t>(b0 + r) * in_dim + 16 * c;
          float xv[16];
          float sum = 0.f;
          load8(xr, xv);
          load8(xr + 8, xv + 8);
#pragma unroll
          for (int k = 0; k < 16; ++k) sum = fmaf(xv[k], w_lo[k], sum);
          load8(xr + half, xv);
          load8(xr + half + 8, xv + 8);
#pragma unroll
          for (int k = 0; k < 16; ++k) sum = fmaf(xv[k], w_hi[k], sum);
          acc[r] += sum;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) {
      float v = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && r < nb) y[static_cast<size_t>(b0 + r) * O + o] = v;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_kernel(const __nv_bfloat16* x, const uint8_t* q,
                     const float* scale, float* y, int B, int O, int half) {
  q4_rows(x, q, scale, y, B, O, half);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_stacked_kernel(const __nv_bfloat16* x, const uint8_t* q,
                             const float* scale, float* y, int B, int O,
                             int half) {
  q4_rows(x, q, scale, y, B, O, half);
}

int check_args(int B, int O, int half) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x: [B, 2*half] bf16, q: [O, half] u8, scale: [O, 2] f32, y: [B, O] f32.
// Every pointer 16-byte aligned, every array contiguous (the wrapper checks).
extern "C" int vt_q4_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int half, void* stream) {
  if (int err = check_args(B, O, half)) return err;
  const dim3 grid((O + kWarpsPerBlock - 1) / kWarpsPerBlock);
  q4_matmul_kernel<<<grid, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half);
  return static_cast<int>(cudaGetLastError());
}

// Same contract; q / scale point at the picked layer of a stacked weight.
extern "C" int vt_q4_matmul_stacked(const void* x, const void* q,
                                    const void* scale, void* y, int B, int O,
                                    int half, void* stream) {
  if (int err = check_args(B, O, half)) return err;
  const dim3 grid((O + kWarpsPerBlock - 1) / kWarpsPerBlock);
  q4_matmul_stacked_kernel<<<grid, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half);
  return static_cast<int>(cudaGetLastError());
}
