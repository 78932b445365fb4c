// Fused int4 SwiGLU MLP over per-slab repacked weights, for Hopper (sm_90a):
//   y[B, H] f32 = sum over slabs j = 0..n-1, in that order, of down_j(act_j),
//   act_j[B, bi] bf16 = bf16(g * sigmoid(g) * u) for slab j's gate / up rows.
//
// Replaces the Pallas TPU kernel H of the probe tools:
//   tools/probe_stacked_fused.py:_q4_fused_mlp_kernel (launched by q4_fused_mlp,
//   variant F) -> entry vt_q4_fused_mlp.
// Layout (one layer; the wrapper hands the picked layer's views of the
// probe's [L, ...] stacks, built by vis_tpu_torch.ops.quantized.repack_slabs):
//   gq [n, 2*bi, H/2] u8  slab j: gate rows 0..bi-1, then up rows bi..2bi-1,
//                         split-half packed (input k low, k + H/2 high, +8);
//   gs [n, 2, 2*bi]  f32  slab j: s_lo row, then s_hi row, per gate/up row;
//   dq [n, H, bi/2]  u8   slab j, output o: act_j column c low, c + bi/2 high;
//   ds [n, 2, H]     f32  slab j: s_lo row, then s_hi row, per output.
// Every product has the TPU kernel's folded arithmetic, exactly: the unsigned
// nibble n in [0, 15] times bf16 input, summed in f32, the -8 bias folded into
// a sum of the input, the scale applied once after the sum; act is rounded
// to bf16 before the down product, as the TPU feeds it to the MXU.
//
// What bounds it: the weight bytes.  One layer of the 7B MLP reads 3 * H * I
// / 2 = 101.8 MB of nibbles plus 0.8 MB of scales, 0.031 ms at 3.35 TB/s;
// at B = 1 it does about 1 flop a byte.  So each weight byte is read once,
// 16 bytes a lane.
//
// The TPU kernel walks the slabs in grid order and carries the output block
// from step to step (o_ref += d).  Blocks on Hopper run in no order, and a
// float atomicAdd would make the sum's order change from run to run.  So the
// kernel runs in two stages on one stream:
//   stage 1 (q4_slab_act_kernel): one warp per intermediate column; it reads
//     the column's gate and up rows, finishes g and u with warp reductions
//     and writes act to a [B, I] bf16 scratch (0.04 MB at B = 1, I = 18944);
//   stage 2 (q4_slab_down_kernel): one warp per output element row o; it walks
//     the slabs j = 0..n-1, takes slab j's folded down product from its
//     [bi/2] bytes of row o, and adds it to the running sum, starting from 0:
//     the TPU's order of additions at slab granularity.
// Every output is summed by one warp in a fixed order, so two runs agree bit
// for bit.  A simple, correct first version: x and act are read through
// L1/L2, no tensor cores, no TMA; at bi = 1184 a slab row is 37 chunks of
// 16 bytes, so stage 2's second pass over a row keeps 5 of 32 lanes busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerPass = 8;  // batch rows whose sums live in registers

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

// Nibble k (0..15) of a 16-byte chunk: the low (kHigh = false) or high one.
template <bool kHigh>
__device__ __forceinline__ float nibble(const uint32_t* words, int k) {
  const uint32_t byte = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
  return static_cast<float>(kHigh ? byte >> 4 : byte & 15u);
}

// Adds 16 inputs times the low or high nibbles of two weight chunks into the
// two dots, and the inputs into their sum.
template <bool kHigh>
__device__ __forceinline__ void fold16(const float* xv, const uint32_t* wa,
                                       const uint32_t* wb, float& dot_a,
                                       float& dot_b, float& sum) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    dot_a = fmaf(xv[k], nibble<kHigh>(wa, k), dot_a);
    dot_b = fmaf(xv[k], nibble<kHigh>(wb, k), dot_b);
    sum += xv[k];
  }
}

// Stage 1: act[b, t] for intermediate column t = j * bi + c of slab j.
__global__ void __launch_bounds__(kWarps * 32)
    q4_slab_act_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ gq, const float* __restrict__ gs,
                       __nv_bfloat16* __restrict__ act, int B, int H, int n, int bi) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int inter = n * bi;
  if (t >= inter) return;
  const int j = t / bi, c = t - j * bi;
  const int halfh = H / 2;
  const uint8_t* gate = gq + (static_cast<size_t>(j) * 2 * bi + c) * halfh;
  const uint8_t* up = gate + static_cast<size_t>(bi) * halfh;
  const float* scales = gs + static_cast<size_t>(j) * 4 * bi;
  const float g_lo = scales[c], u_lo = scales[bi + c];
  const float g_hi = scales[2 * bi + c], u_hi = scales[3 * bi + c];
  const int chunks = halfh / 16;

  for (int b0 = 0; b0 < B; b0 += kRowsPerPass) {
    const int nb = min(kRowsPerPass, B - b0);
    // gate lo, gate hi, up lo, up hi, sum x_lo, sum x_hi
    float acc[kRowsPerPass][6];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r)
#pragma unroll
      for (int v = 0; v < 6; ++v) acc[r][v] = 0.f;

    for (int k0 = lane; k0 < chunks; k0 += 32) {
      const uint4 pg = *reinterpret_cast<const uint4*>(gate + 16 * k0);
      const uint4 pu = *reinterpret_cast<const uint4*>(up + 16 * k0);
      const uint32_t wg[4] = {pg.x, pg.y, pg.z, pg.w};
      const uint32_t wu[4] = {pu.x, pu.y, pu.z, pu.w};
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr = x + static_cast<size_t>(b0 + r) * H + 16 * k0;
          float xv[16];
          load8(xr, xv);
          load8(xr + 8, xv + 8);
          fold16<false>(xv, wg, wu, acc[r][0], acc[r][2], acc[r][4]);
          load8(xr + halfh, xv);
          load8(xr + halfh + 8, xv + 8);
          fold16<true>(xv, wg, wu, acc[r][1], acc[r][3], acc[r][5]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) {
      float s[6];
#pragma unroll
      for (int v = 0; v < 6; ++v) s[v] = warp_sum(acc[r][v]);
      if (lane == 0 && r < nb) {
        const float g = (s[0] - 8.f * s[4]) * g_lo + (s[1] - 8.f * s[5]) * g_hi;
        const float u = (s[2] - 8.f * s[4]) * u_lo + (s[3] - 8.f * s[5]) * u_hi;
        const float sigmoid = 1.f / (1.f + expf(-g));
        act[static_cast<size_t>(b0 + r) * inter + t] = __float2bfloat16(g * sigmoid * u);
      }
    }
  }
}

// Stage 2: y[b, o] = sum over slabs j, in order, of slab j's down product.
__global__ void __launch_bounds__(kWarps * 32)
    q4_slab_down_kernel(const __nv_bfloat16* __restrict__ act,
                        const uint8_t* __restrict__ dq, const float* __restrict__ ds,
                        float* __restrict__ y, int B, int H, int n, int bi) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (o >= H) return;
  const int inter = n * bi;
  const int halfb = bi / 2;
  const int chunks = halfb / 16;

  for (int b0 = 0; b0 < B; b0 += kRowsPerPass) {
    const int nb = min(kRowsPerPass, B - b0);
    float total[kRowsPerPass];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) total[r] = 0.f;

    for (int j = 0; j < n; ++j) {
      const uint8_t* row = dq + (static_cast<size_t>(j) * H + o) * halfb;
      const float s_lo = ds[static_cast<size_t>(j) * 2 * H + o];
      const float s_hi = ds[static_cast<size_t>(j) * 2 * H + H + o];
      // dot lo, dot hi, sum act_lo, sum act_hi
      float acc[kRowsPerPass][4];
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;

      for (int k0 = lane; k0 < chunks; k0 += 32) {
        const uint4 packed = *reinterpret_cast<const uint4*>(row + 16 * k0);
        const uint32_t w[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r) {
          if (r < nb) {
            const __nv_bfloat16* ar =
                act + static_cast<size_t>(b0 + r) * inter + static_cast<size_t>(j) * bi + 16 * k0;
            float av[16];
            load8(ar, av);
            load8(ar + 8, av + 8);
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              acc[r][0] = fmaf(av[k], nibble<false>(w, k), acc[r][0]);
              acc[r][2] += av[k];
            }
            load8(ar + halfb, av);
            load8(ar + halfb + 8, av + 8);
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              acc[r][1] = fmaf(av[k], nibble<true>(w, k), acc[r][1]);
              acc[r][3] += av[k];
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
        total[r] += (dot_lo - 8.f * sum_lo) * s_lo + (dot_hi - 8.f * sum_hi) * s_hi;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r)
      if (lane == 0 && r < nb) y[static_cast<size_t>(b0 + r) * H + o] = total[r];
  }
}

}  // namespace

// x: [B, H] bf16, gq: [n, 2*bi, H/2] u8, gs: [n, 2, 2*bi] f32, dq: [n, H, bi/2]
// u8, ds: [n, 2, H] f32 (one layer of each stack), act: [B, n*bi] bf16
// scratch, y: [B, H] f32.  Every pointer 16-byte aligned, every array
// contiguous, H % 32 == 0 and bi % 32 == 0 (the wrapper checks).  Two
// launches on `stream`; returns the first error.
extern "C" int vt_q4_fused_mlp(const void* x, const void* gq, const void* gs, const void* dq,
                               const void* ds, void* act, void* y, int B, int H, int n,
                               int bi, void* stream) {
  if (B < 1 || n < 1 || H < 32 || H % 32 != 0 || bi < 32 || bi % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inter = n * bi;
  q4_slab_act_kernel<<<(inter + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(gq),
      static_cast<const float*>(gs), static_cast<__nv_bfloat16*>(act), B, H, n, bi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  q4_slab_down_kernel<<<(H + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(act), static_cast<const uint8_t*>(dq),
      static_cast<const float*>(ds), static_cast<float*>(y), B, H, n, bi);
  return static_cast<int>(cudaGetLastError());
}
