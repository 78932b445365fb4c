// The hybrid decoders' two normalisations, one launch each, bf16 rows with
// f32 statistics (sm_90a).
//
// Replace no TPU kernel: the JAX package runs no hybrid stack.  Added for
// Nemotron-H's decode, whose 98 blocks each begin with a residual add and an
// RMSNorm (ten PyTorch launches a block) and whose 45 Mamba2 mixers end in a
// grouped gated RMSNorm (eleven): at three rows the work is tiny and the
// launches are what a step costs, so each becomes one launch.  ops/norms.py
// holds the plain versions, the same arithmetic in torch operations.
//
//   vt_add_rms_norm:  x_out = bf16(x + delta) (delta may be null: x_out = x),
//                     h = bf16((x_out * rsqrt(mean(x_out^2) + eps)) * w)
//   vt_gated_group_norm: g = y * silu(z) (y f32, z bf16), per group of
//                     n / groups columns g * rsqrt(mean(g^2) + eps), times w,
//                     rounded to bf16
//
// What bounds them: bytes (a row read and written once, 16 bytes a lane a
// load), and at decode sizes the launch.  One block of 256 threads a row
// (a row and group for the gated norm); the sum of squares is a tree
// (warp shuffles, then one value a warp in shared memory), the only order
// that differs from the plain versions; products and sums elsewhere round
// as theirs do (__fmul_rn / __fadd_rn, no contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 a 16-byte load

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  return total;
}

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = __bfloat162float(v[i]);
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  uint4 raw;
  bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __float2bfloat16_rn(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__global__ void __launch_bounds__(kThreads) add_rms_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ delta, const bf16* __restrict__ w,
    bf16* __restrict__ x_out, bf16* __restrict__ h, int n, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  float sq = 0.0f;
  for (int i = threadIdx.x * kVec; i < n; i += kThreads * kVec) {
    float a[kVec];
    load8(x + base + i, a);
    if (delta != nullptr) {
      float b[kVec];
      load8(delta + base + i, b);
#pragma unroll
      for (int k = 0; k < kVec; ++k) a[k] = __bfloat162float(__float2bfloat16_rn(__fadd_rn(a[k], b[k])));
    }
    store8(x_out + base + i, a);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sq = __fadd_rn(sq, __fmul_rn(a[k], a[k]));
  }
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(sq), static_cast<float>(n)), eps));
  for (int i = threadIdx.x * kVec; i < n; i += kThreads * kVec) {
    float a[kVec], g[kVec];
    load8(x_out + base + i, a);
    load8(w + i, g);
#pragma unroll
    for (int k = 0; k < kVec; ++k) a[k] = __fmul_rn(__fmul_rn(a[k], inv), g[k]);
    store8(h + base + i, a);
  }
}

__global__ void __launch_bounds__(kThreads) gated_group_norm_kernel(
    const float* __restrict__ y, const bf16* __restrict__ z, int ldz, const bf16* __restrict__ w,
    bf16* __restrict__ out, int n, int group, float eps) {
  const int row = blockIdx.y, g0 = blockIdx.x * group;
  const float* yr = y + static_cast<size_t>(row) * n + g0;
  const bf16* zr = z + static_cast<size_t>(row) * ldz + g0;
  auto gate = [&](int i, float* v) {
    float zz[kVec];
    load8(zr + i, zz);
    const float4 y0 = *reinterpret_cast<const float4*>(yr + i);
    const float4 y1 = *reinterpret_cast<const float4*>(yr + i + 4);
    const float yy[kVec] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = __fmul_rn(yy[k], __fdiv_rn(zz[k], __fadd_rn(1.0f, expf(-zz[k]))));
  };
  float sq = 0.0f;
  for (int i = threadIdx.x * kVec; i < group; i += kThreads * kVec) {
    float v[kVec];
    gate(i, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sq = __fadd_rn(sq, __fmul_rn(v[k], v[k]));
  }
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(sq), static_cast<float>(group)), eps));
  bf16* orow = out + static_cast<size_t>(row) * n + g0;
  for (int i = threadIdx.x * kVec; i < group; i += kThreads * kVec) {
    float v[kVec], ww[kVec];
    gate(i, v);
    load8(w + g0 + i, ww);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = __fmul_rn(__fmul_rn(v[k], inv), ww[k]);
    store8(orow + i, v);
  }
}

}  // namespace

extern "C" int vt_add_rms_norm(const void* x, const void* delta, const void* w, void* x_out,
                               void* h, int rows, int n, float eps, void* stream) {
  if (rows < 1 || n < kVec || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  add_rms_norm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(delta), static_cast<const bf16*>(w),
      static_cast<bf16*>(x_out), static_cast<bf16*>(h), n, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vt_gated_group_norm(const void* y, const void* z, int ldz, const void* w,
                                   void* out, int rows, int n, int groups, float eps,
                                   void* stream) {
  if (rows < 1 || groups < 1 || n % groups || (n / groups) % kVec || ldz % kVec || ldz < n ||
      rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  gated_group_norm_kernel<<<dim3(groups, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const bf16*>(z), ldz,
      static_cast<const bf16*>(w), static_cast<bf16*>(out), n, n / groups, eps);
  return static_cast<int>(cudaGetLastError());
}
