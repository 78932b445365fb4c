// Mamba2 decode state step for Hopper (sm_90a): one token of every row of a
// batch through one Mamba2 mixer's convolution and state-space recurrence.
//
// Replaces no TPU kernel: the JAX package runs no state-space layer.  It was
// added for the hybrid decoders (Nemotron-H: 45 Mamba2 mixers among 98
// blocks), whose decode carries a fixed recurrent state per sequence beside
// the KV cache, and no other kernel computes its step.  ``ssm_step_plain``
// in ops/ssm.py is the same function in torch operations.
//
// Contract, for each row r (a sequence) and head h of group g = h / (H / G):
//   zxbcdt [B, ld] bf16    in_proj's output: z [d_inner] | xBC [conv_dim] | dt [H]
//   conv   [B, conv_dim, 4] bf16, a ring: token t's pre-conv xBC in slot t % 4
//   cursor [B] int32       t, the index of this token (tokens already folded in)
//   conv_w [conv_dim, 4] bf16, conv_b [conv_dim] bf16 (w[k] multiplies token t - 3 + k)
//   dt_bias, a_log, d_skip [H] f32
//   ssm    [B, H, P, N] f32, updated in place
//   y      [B, H * P] f32
//   u = silu(b + w0 x[t-3] + w1 x[t-2] + w2 x[t-1] + w3 x[t]) per channel; x, B, C
//   its slices [hP, hP + P), [d_inner + gN, +N), [d_inner + GN + gN, +N);
//   dt = softplus(dt_raw + dt_bias), a = exp(dt * -exp(a_log));
//   S[p, n] = a S[p, n] + (dt x[p]) B[n];  y[p] = sum_n S[p, n] C[n] + D x[p].
// Token t's xBC goes into ring slot t % 4, which no one reads at step t (the
// window reads slots t - 3 .. t - 1): so the 32 heads of a group, which all
// convolve its B and C channels from the ring, never see each other's write,
// and one launch does the shift, without a second buffer.  The group's first
// head writes the B and C channels, each head its x channels.
//
// What bounds it: bytes.  Each (row, head) reads and writes its f32 state,
// P * N * 4 bytes each way (64 KiB at P = 64, N = 256): 100.7 MB a layer at
// three rows and 256 heads, against 2 flops and a multiply-add per entry.
// The design is one block of 8 warps per (head, row), 768 blocks at the
// bundle cell's three slots.  A lane owns N / 32 adjacent state columns
// (two 16-byte loads a row at N = 256), a warp four rows at a time (loaded
// together: 32 floats of state in flight per lane), and the readout y[p] is
// one warp reduction per row.  The convolution's P + 2N channels of a head
// are computed by the block's threads into shared memory first.  Sums round
// as the plain version's operations do (products and sums by __fmul_rn /
// __fadd_rn, no contraction), except the readout's sum over n, which is a
// tree here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // state rows a warp holds at once

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

template <int NV>  // state columns a lane owns: N / 32
__global__ void __launch_bounds__(kThreads) ssm_step_kernel(
    const bf16* __restrict__ zxbcdt, int ld, bf16* __restrict__ conv,
    const int* __restrict__ cursor, const bf16* __restrict__ conv_w,
    const bf16* __restrict__ conv_b, const float* __restrict__ dt_bias,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    float* __restrict__ ssm, float* __restrict__ y, int heads, int P, int groups,
    int d_inner) {
  constexpr int N = NV * 32;
  const int h = blockIdx.x, row = blockIdx.y;
  const int per_group = heads / groups, g = h / per_group;
  const int conv_dim = d_inner + 2 * groups * N;
  extern __shared__ float smem[];  // x [P], B [N], C [N]
  float* xs = smem;
  float* bs = smem + P;
  float* cs = bs + N;
  __shared__ float s_dt, s_a;

  const bf16* in = zxbcdt + static_cast<size_t>(row) * ld;
  const int t = cursor[row];
  bf16* ring = conv + static_cast<size_t>(row) * conv_dim * 4;
  const bool writes_bc = (h % per_group) == 0;

  if (threadIdx.x == 0) {
    const float dt = softplus(__fadd_rn(__bfloat162float(in[d_inner + conv_dim + h]),
                                        dt_bias[h]));
    s_dt = dt;
    s_a = expf(__fmul_rn(dt, -expf(a_log[h])));
  }
  for (int i = threadIdx.x; i < P + 2 * N; i += kThreads) {
    int c;
    float* dst;
    bool owner;
    if (i < P) {
      c = h * P + i, dst = xs + i, owner = true;
    } else if (i < P + N) {
      c = d_inner + g * N + (i - P), dst = bs + (i - P), owner = writes_bc;
    } else {
      c = d_inner + groups * N + g * N + (i - P - N), dst = cs + (i - P - N),
      owner = writes_bc;
    }
    const bf16 cur = in[d_inner + c];
    const bf16* r = ring + static_cast<size_t>(c) * 4;
    const bf16* w = conv_w + static_cast<size_t>(c) * 4;
    float acc = __bfloat162float(conv_b[c]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(w[k]),
                                     __bfloat162float(r[(t - 3 + k) & 3])));
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(w[3]), __bfloat162float(cur)));
    *dst = silu(acc);
    if (owner) ring[static_cast<size_t>(c) * 4 + (t & 3)] = cur;
  }
  __syncthreads();

  const float dt = s_dt, a = s_a, skip = d_skip[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float bl[NV], cl[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) bl[j] = bs[lane * NV + j], cl[j] = cs[lane * NV + j];
  float* state = ssm + (static_cast<size_t>(row) * heads + h) * P * N + lane * NV;
  float* out = y + static_cast<size_t>(row) * heads * P + static_cast<size_t>(h) * P;
  for (int p0 = warp; p0 < P; p0 += kWarps * kRows) {
    float4 v[kRows][NV / 4];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float4* src =
          reinterpret_cast<const float4*>(state + static_cast<size_t>(p0 + u * kWarps) * N);
#pragma unroll
      for (int q = 0; q < NV / 4; ++q) v[u][q] = src[q];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int p = p0 + u * kWarps;
      const float xd = __fmul_rn(xs[p], dt);
      float* s = reinterpret_cast<float*>(v[u]);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        s[j] = __fadd_rn(__fmul_rn(s[j], a), __fmul_rn(xd, bl[j]));
        acc = __fadd_rn(acc, __fmul_rn(s[j], cl[j]));
      }
      float4* dstp = reinterpret_cast<float4*>(state + static_cast<size_t>(p) * N);
#pragma unroll
      for (int q = 0; q < NV / 4; ++q) dstp[q] = v[u][q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[p] = __fadd_rn(acc, __fmul_rn(skip, xs[p]));
    }
  }
}

template <int NV>
int launch(const void* zxbcdt, int ld, void* conv, const void* cursor, const void* conv_w,
           const void* conv_b, const void* dt_bias, const void* a_log, const void* d_skip,
           void* ssm, void* y, int batch, int heads, int P, int groups, cudaStream_t s) {
  const int d_inner = heads * P;
  const size_t shared = static_cast<size_t>(P + 2 * NV * 32) * sizeof(float);
  ssm_step_kernel<NV><<<dim3(heads, batch), kThreads, shared, s>>>(
      static_cast<const bf16*>(zxbcdt), ld, static_cast<bf16*>(conv),
      static_cast<const int*>(cursor), static_cast<const bf16*>(conv_w),
      static_cast<const bf16*>(conv_b), static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<float*>(ssm), static_cast<float*>(y), heads, P, groups, d_inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vt_ssm_step(const void* zxbcdt, int ld, void* conv, const void* cursor,
                           const void* conv_w, const void* conv_b, const void* dt_bias,
                           const void* a_log, const void* d_skip, void* ssm, void* y,
                           int batch, int heads, int head_dim, int state, int groups,
                           void* stream) {
  if (batch < 1 || heads < 1 || groups < 1 || heads % groups || head_dim < 1 ||
      head_dim % (kWarps * kRows) || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int conv_dim = heads * head_dim + 2 * groups * state;
  if (ld < conv_dim + heads * head_dim + heads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (state) {
    case 128:
      return launch<4>(zxbcdt, ld, conv, cursor, conv_w, conv_b, dt_bias, a_log, d_skip, ssm,
                       y, batch, heads, head_dim, groups, s);
    case 256:
      return launch<8>(zxbcdt, ld, conv, cursor, conv_w, conv_b, dt_bias, a_log, d_skip, ssm,
                       y, batch, heads, head_dim, groups, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
