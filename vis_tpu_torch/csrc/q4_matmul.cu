// Int4 weight-only matmul for Hopper (sm_90a): y[B, O] f32 = x[B, I] . W[O, I]^T
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B: vis_tpu/ops/quantized.py:_q4_matmul_kernel  (one [O, I/2] weight; the
//      int4 vocab head)                          -> entry vt_q4_matmul
//   A: vis_tpu/ops/quantized.py:_q4_stacked_kernel (layer `idx` of a stacked
//      [L, O, I/2] weight; every decoder projection of a lookahead window)
//                                                 -> entry vt_q4_matmul_stacked
// and, through a second row function (q4_row_folded), three kernels of the
// int4 probe tools, which compute the TPU kernels' own folded arithmetic:
//   J: tools/probe_unpack.py:_q4_matmul_kernel_folded (one weight), and
//   I: tools/probe_stacked_fused.py:flat_folded (the padded vocab head sweep)
//                                                 -> entry vt_q4_matmul_folded
//   F: tools/probe_stacked_fused.py:_q4_stacked_folded_kernel (layer `idx`)
//                                                 -> entry vt_q4_matmul_stacked_folded
// A and B share q4_row_rounded(), F, I and J q4_row_folded(); the entries
// differ only in their kernel symbol, so a profiler and the launch counters
// can tell them apart.  The stacked entries are handed the picked layer's
// pointer: in torch `stack.q[idx]` is a view.
//
// Weight layout (same bytes as the JAX package): q[o, j] packs input j in the
// low nibble and input j + I/2 in the high nibble, both stored as value + 8.
// A and B take scale [O, 2] = {s_lo, s_hi} per row, and the weight a
// product sees is
//     w = bf16((nibble - 8) * s)
// i.e. the JAX package's dequantized bf16 weight (unpack_int4), so this kernel
// and its plain PyTorch version agree up to the order of f32 accumulation.
// (The TPU kernel folded the -8 into a -8*sum(x) correction, a lane-op trick
// for the TPU's vector unit; a per-nibble subtract is cheap here.)
// F, I and J take the probes' kernel layout [2, O] (row 0 s_lo, row 1
// s_hi), and the arithmetic is the TPU kernels' exactly: the
// unsigned nibble n in [0, 15] times bf16 x, summed in f32, the -8 bias
// folded into a sum of x, and the scale applied once after the sum,
//     y = (sum x_lo n_lo - 8 sum x_lo) s_lo + (sum x_hi n_hi - 8 sum x_hi) s_hi.
// Each lane keeps four partial sums per batch row for it.  A's and B's loop
// is the one they had before the folded kernels were added (same output bits).
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp's output row, or -1 past the last one.
__device__ __forceinline__ int warp_row(int O) {
  const int o = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return o < O ? o : -1;
}

// A, B: each weight rounded to bf16 before the product (the JAX package's
// dequantized weight), one f32 sum per batch row.
__device__ __forceinline__ void q4_row_rounded(const __nv_bfloat16* __restrict__ x,
                                               const uint8_t* __restrict__ qrow,
                                               float s_lo, float s_hi,
                                               float* __restrict__ y, int B, int O,
                                               int o, int half) {
  const int lane = threadIdx.x & 31;
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
          const __nv_bfloat16* xr = x + static_cast<size_t>(b0 + r) * in_dim + 16 * c;
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
      const float v = warp_sum(acc[r]);
      if (lane == 0 && r < nb) y[static_cast<size_t>(b0 + r) * O + o] = v;
    }
  }
}

// F, I, J: the TPU kernels' folded arithmetic, four f32 sums per batch row
// (dot_lo, dot_hi, sum x_lo, sum x_hi) and the scales after the sum.
__device__ __forceinline__ void q4_row_folded(const __nv_bfloat16* __restrict__ x,
                                              const uint8_t* __restrict__ qrow,
                                              float s_lo, float s_hi,
                                              float* __restrict__ y, int B, int O,
                                              int o, int half) {
  const int lane = threadIdx.x & 31;
  const int in_dim = 2 * half;
  const int chunks = half / 16;
  for (int b0 = 0; b0 < B; b0 += kRowsPerPass) {
    const int nb = min(kRowsPerPass, B - b0);
    float acc[kRowsPerPass][4];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
      const uint4 packed = *reinterpret_cast<const uint4*>(qrow + 16 * c);
      const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
      float n_lo[16], n_hi[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t byte = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
        n_lo[k] = static_cast<float>(byte & 15u);
        n_hi[k] = static_cast<float>(byte >> 4);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr = x + static_cast<size_t>(b0 + r) * in_dim + 16 * c;
          float xv[16];
          load8(xr, xv);
          load8(xr + 8, xv + 8);
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            acc[r][0] = fmaf(xv[k], n_lo[k], acc[r][0]);
            acc[r][2] += xv[k];
          }
          load8(xr + half, xv);
          load8(xr + half + 8, xv + 8);
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            acc[r][1] = fmaf(xv[k], n_hi[k], acc[r][1]);
            acc[r][3] += xv[k];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) {
      const float dot_lo = warp_sum(acc[r][0]);
      const float dot_hi = warp_sum(acc[r][1]);
      const float sum_lo = warp_sum(acc[r][2]);
      const float sum_hi = warp_sum(acc[r][3]);
      if (lane == 0 && r < nb)
        y[static_cast<size_t>(b0 + r) * O + o] =
            (dot_lo - 8.f * sum_lo) * s_lo + (dot_hi - 8.f * sum_hi) * s_hi;
    }
  }
}

// A and B take scale [O, 2] = {s_lo, s_hi} per row.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_kernel(const __nv_bfloat16* x, const uint8_t* q,
                     const float* scale, float* y, int B, int O, int half) {
  const int o = warp_row(O);
  if (o < 0) return;
  q4_row_rounded(x, q + static_cast<size_t>(o) * half, scale[2 * o], scale[2 * o + 1],
                 y, B, O, o, half);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_stacked_kernel(const __nv_bfloat16* x, const uint8_t* q,
                             const float* scale, float* y, int B, int O,
                             int half) {
  const int o = warp_row(O);
  if (o < 0) return;
  q4_row_rounded(x, q + static_cast<size_t>(o) * half, scale[2 * o], scale[2 * o + 1],
                 y, B, O, o, half);
}

// F, I and J take the probes' scale layout [2, O] (the s_lo row, then s_hi).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_folded_kernel(const __nv_bfloat16* x, const uint8_t* q,
                            const float* scale, float* y, int B, int O, int half) {
  const int o = warp_row(O);
  if (o < 0) return;
  q4_row_folded(x, q + static_cast<size_t>(o) * half, scale[o], scale[O + o],
                y, B, O, o, half);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    q4_matmul_stacked_folded_kernel(const __nv_bfloat16* x, const uint8_t* q,
                                    const float* scale, float* y, int B, int O,
                                    int half) {
  const int o = warp_row(O);
  if (o < 0) return;
  q4_row_folded(x, q + static_cast<size_t>(o) * half, scale[o], scale[O + o],
                y, B, O, o, half);
}

using Kernel = void (*)(const __nv_bfloat16*, const uint8_t*, const float*, float*,
                        int, int, int);

int launch(Kernel kernel, const void* x, const void* q, const void* scale, void* y,
           int B, int O, int half, void* stream) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, 2*half] bf16, q: [O, half] u8, scale: [O, 2] f32, y: [B, O] f32.
// Every pointer 16-byte aligned, every array contiguous (the wrapper checks).
extern "C" int vt_q4_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int half, void* stream) {
  return launch(q4_matmul_kernel, x, q, scale, y, B, O, half, stream);
}

// Same contract; q / scale point at the picked layer of a stacked weight.
extern "C" int vt_q4_matmul_stacked(const void* x, const void* q,
                                    const void* scale, void* y, int B, int O,
                                    int half, void* stream) {
  return launch(q4_matmul_stacked_kernel, x, q, scale, y, B, O, half, stream);
}

// The folded arithmetic; scale is [2, O] f32 (the s_lo row, then the s_hi row).
extern "C" int vt_q4_matmul_folded(const void* x, const void* q, const void* scale,
                                   void* y, int B, int O, int half, void* stream) {
  return launch(q4_matmul_folded_kernel, x, q, scale, y, B, O, half, stream);
}

// Same contract; q / scale point at the picked layer ([O, half], [2, O]) of a
// stacked [L, O, half] weight and [L, 2, O] scale.
extern "C" int vt_q4_matmul_stacked_folded(const void* x, const void* q,
                                           const void* scale, void* y, int B, int O,
                                           int half, void* stream) {
  return launch(q4_matmul_stacked_folded_kernel, x, q, scale, y, B, O, half, stream);
}
