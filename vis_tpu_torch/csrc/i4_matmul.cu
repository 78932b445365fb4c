// Signed int4 matvec for Hopper (sm_90a): y[B, O] f32 = (x[B, I] . w[O, I]^T) * scale[O]
//
// Replaces the Pallas TPU kernel K of the probe tools:
//   tools/probe_unpack.py:_i4_matmul_kernel (launched by i4_matmul, variant C,
//   "native int4") -> entry vt_i4_matmul.
// The TPU kernel reads a native jnp.int4 weight, converts it to bf16 and
// takes an f32-accumulated dot with bf16 x, then multiplies the sum by one
// scale per output row ([1, O]).  Torch has no arithmetic int4 type, so the
// port stores the same signed values as two's-complement nibbles packed in
// adjacent pairs: q[o, k] holds w[o, 2k] in the low nibble and w[o, 2k + 1]
// in the high nibble (vis_tpu_torch.ops.quantized.pack_int4_adjacent).  No
// +8 offset and no split-half packing: each nibble is sign-extended and
// converted to float exactly, the products with bf16 x are summed in f32, and
// the row scale multiplies the sum once, as on the TPU.
//
// What bounds it: at B = 1 a [37888, 3584] weight is 67.9 MB of packed
// nibbles for 0.27 GFLOP, about 4 flops a byte, far below the ~295 flop/byte
// where an H100 turns compute-bound: the floor is the weight read, 0.020 ms
// at 3.35 TB/s.  So, as in q4_matmul.cu, one warp owns one output row, each
// lane reads 16 bytes (32 consecutive inputs) of it per step, 512 contiguous
// bytes a warp, the batch rows' partial sums stay in registers and x is read
// through L1/L2.  A simple, correct first version: no tensor cores, no
// cp.async pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

// A two's-complement nibble (the low 4 bits of v) -> its value as a float.
__device__ __forceinline__ float sext4(uint32_t v) {
  return static_cast<float>(static_cast<int32_t>(v << 28) >> 28);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    i4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int B, int O, int half) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (o >= O) return;
  const uint8_t* qrow = q + static_cast<size_t>(o) * half;
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
      float w[32];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t byte = words[k >> 2] >> (8 * (k & 3));
        w[2 * k] = sext4(byte);
        w[2 * k + 1] = sext4(byte >> 4);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r < nb) {
          const __nv_bfloat16* xr = x + static_cast<size_t>(b0 + r) * in_dim + 32 * c;
          float sum = 0.f;
#pragma unroll
          for (int part = 0; part < 4; ++part) {
            float xv[8];
            load8(xr + 8 * part, xv);
#pragma unroll
            for (int k = 0; k < 8; ++k) sum = fmaf(xv[k], w[8 * part + k], sum);
          }
          acc[r] += sum;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) {
      float v = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && r < nb) y[static_cast<size_t>(b0 + r) * O + o] = v * scale[o];
    }
  }
}

}  // namespace

// x: [B, 2*half] bf16, q: [O, half] u8 (adjacent signed nibbles), scale: [O]
// f32, y: [B, O] f32.  Every pointer 16-byte aligned, every array contiguous,
// half % 16 == 0 (the wrapper checks).
extern "C" int vt_i4_matmul(const void* x, const void* q, const void* scale, void* y,
                            int B, int O, int half, void* stream) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kWarpsPerBlock - 1) / kWarpsPerBlock);
  i4_matmul_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half);
  return static_cast<int>(cudaGetLastError());
}
