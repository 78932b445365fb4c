// Fused int8 SwiGLU MLP for Hopper (sm_90a):
//   y[B, H] f32 = (h . down[H, I]^T) * down_scale[H],
//   h[B, I] bf16 = bf16(silu(g) * u),
//   g = (x . gate[I, H]^T) * gate_scale,  u = (x . up[I, H]^T) * up_scale.
//
// Replaces the Pallas TPU kernel E of the JAX package:
//   vis_tpu/ops/quantized.py:_fused_mlp_kernel (launched by fused_swiglu_mlp) ->
//   entry vt_q8_swiglu.  On the port's main path under QUANTIZATION=int8 it
//   is every decoder MLP of every decode step: Qwen2.5-VL-7B (H 3584, I 18944)
//   at B = 8 (lookahead windows) and Llama-3.1-8B (H 4096, I 14336) at B = 3
//   (scheduler slots).  The fused gate+up weight is [2I, H] int8 with gate
//   rows first and one f32 scale per row ([2I]); down is [H, I] int8 with
//   scales [H].
//
// Semantics are the TPU kernel's: x is bf16, every int8 weight converts to
// float exactly, sums are f32 and the row scale multiplies the sum once;
// h is rounded to bf16 before the down product, as the TPU kernel feeds h to
// the MXU in bf16.
//
// What bounds it: the weight bytes.  One call reads 3 * H * I int8 bytes
// plus the scales: 203.9 MB at the Qwen shape and 176.3 MB at the Llama
// shape, 60.9 us and 52.6 us at 3.35 TB/s.  At B <= 8 the products are
// about 2 * 3 * H * I * B flops, some 20x below what would make it
// compute-bound, so the design reads each weight byte once, 16 bytes a lane,
// and keeps x and h off the weight stream's way.
//
// The TPU kernel walks the intermediate dimension I in grid order and
// carries the down product's partial sum in its output block from step to
// step.  Blocks on Hopper run in no order, and a float atomicAdd would make
// the sum's order, and so the token stream, change from run to run.  This
// kernel therefore splits the work in two stages with a fixed reduction
// order, launched on one stream:
//
//   stage 1 (q8_gateup_kernel, here): each warp owns kCols intermediate
//     columns j and reads their gate rows j and up rows I + j, 16 bytes a
//     lane (512 contiguous bytes a warp per row), against x staged once per
//     block in shared memory (up to 8 batch rows of 2048 columns, 32 KB);
//     it finishes g and u with one warp reduction each and writes
//     h = bf16(silu(g) * u) to the [B, I] scratch the wrapper allocated;
//   stage 2: the down product on (h, down), which is exactly kernel D's
//     function, so it runs D's own kernel (vt_q8_matmul, q8_matmul.cu).
//
// Every output element is summed by one warp in a fixed order, so results
// are bitwise reproducible.  The [B, I] bf16 round trip through device
// memory is B * I * 4 bytes (0.6 MB at the Qwen shape, B = 8), under 0.3% of
// the weight bytes.  A simple, correct first version: no tensor cores, no
// TMA, no cp.async pipelining, and stage 2 inherits D's grid of H / 32
// blocks (112 at H 3584, fewer than the card's 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int vt_q8_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int I, void* stream);

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 2;                        // intermediate columns a warp owns
constexpr int kColsPerBlock = kWarps * kCols;   // 16
constexpr int kRows = 2 * kCols;                // weight rows a warp reads: gate, up
constexpr int kBatchPerPass = 8;                // batch rows per x stage
constexpr int kChunk = 2048;                    // x columns per stage

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

// Stage 1: h[b, j] = bf16(silu(g) * u) for this warp's columns j.
// Weight row r of the warp: r < kCols is gate row j0 + r, else up row
// I + j0 + (r - kCols).
__global__ void __launch_bounds__(kWarps * 32)
    q8_gateup_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ gateup,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ h, int B, int H, int I) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBatchPerPass * kChunk];
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5) * kCols;

  const int8_t* rows[kRows];
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + (r % kCols);
    live[r] = j < I;
    const int row = (r < kCols ? 0 : I) + j;
    rows[r] = gateup + static_cast<size_t>(live[r] ? row : 0) * H;
  }

  for (int b0 = 0; b0 < B; b0 += kBatchPerPass) {
    const int nb = min(kBatchPerPass, B - b0);
    float acc[kRows][kBatchPerPass];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int b = 0; b < kBatchPerPass; ++b) acc[r][b] = 0.f;

    for (int k0 = 0; k0 < H; k0 += kChunk) {
      const int kc = min(kChunk, H - k0);
      // Stage x[b0:b0+nb, k0:k0+kc]; the barrier before it waits for the
      // previous stage's readers.
      __syncthreads();
      const int vecs = kc / 8;
      for (int v = threadIdx.x; v < nb * vecs; v += blockDim.x) {
        const int r = v / vecs;
        const int c = (v - r * vecs) * 8;
        *reinterpret_cast<uint4*>(xs + r * kChunk + c) =
            *reinterpret_cast<const uint4*>(x + static_cast<size_t>(b0 + r) * H + k0 + c);
      }
      __syncthreads();

      for (int c = 16 * lane; c < kc; c += 512) {
        uint4 raw[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          raw[r] = make_uint4(0u, 0u, 0u, 0u);
          if (live[r]) raw[r] = *reinterpret_cast<const uint4*>(rows[r] + k0 + c);
        }
        float w[kRows][16];
#pragma unroll
        for (int r = 0; r < kRows; ++r) unpack16(raw[r], w[r]);
#pragma unroll
        for (int b = 0; b < kBatchPerPass; ++b) {
          if (b < nb) {
            float xv[16];
            load8(xs + b * kChunk + c, xv);
            load8(xs + b * kChunk + c + 8, xv + 8);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float sum = acc[r][b];
#pragma unroll
              for (int k = 0; k < 16; ++k) sum = fmaf(xv[k], w[r][k], sum);
              acc[r][b] = sum;
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int b = 0; b < kBatchPerPass; ++b) {
        float v = acc[r][b];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][b] = v;
      }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c;
        if (j >= I) continue;
        const float gs = scale[j];
        const float us = scale[I + j];
#pragma unroll
        for (int b = 0; b < kBatchPerPass; ++b) {
          if (b < nb) {
            const float g = acc[c][b] * gs;
            const float u = acc[kCols + c][b] * us;
            const float sigmoid = 1.f / (1.f + expf(-g));
            h[static_cast<size_t>(b0 + b) * I + j] = __float2bfloat16(g * sigmoid * u);
          }
        }
      }
    }
  }
}

}  // namespace

// x: [B, H] bf16, gateup: [2I, H] int8 (gate rows first), gateup_scale: [2I]
// f32, down: [H, I] int8, down_scale: [H] f32, h: [B, I] bf16 scratch,
// y: [B, H] f32.  Every pointer 16-byte aligned, every array contiguous,
// H % 16 == 0 and I % 16 == 0 (the wrapper checks).  Two launches on
// `stream`; returns the first error.
extern "C" int vt_q8_swiglu(const void* x, const void* gateup, const void* gateup_scale,
                            const void* down, const void* down_scale, void* h, void* y,
                            int B, int H, int I, void* stream) {
  if (B < 1 || H < 16 || I < 16 || H % 16 != 0 || I % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((I + kColsPerBlock - 1) / kColsPerBlock);
  q8_gateup_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(gateup),
      static_cast<const float*>(gateup_scale), static_cast<__nv_bfloat16*>(h), B, H, I);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return vt_q8_matmul(h, down, down_scale, y, B, H, I, stream);
}
