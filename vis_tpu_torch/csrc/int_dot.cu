// Integer dot products for Hopper (sm_90a): the int8 probe's kernels.
//
// Replaces four Pallas TPU kernels of tools/probe_unpack2.py:
//   L _stream_kernel (stream_pass, variant S)   -> vt_u8_sum
//   M _i8dot_kernel  (i8_dot, variant F)        -> vt_i8_matmul
//   O _q4i8_kernel   (q4_i8dot, variant H)      -> vt_q4_i8_matmul
//   P _q4i8s_kernel  (q4_i8s_dot, variant I)    -> vt_q4_i8s_matmul
// (N, _mixdot_kernel, bf16 x times int8 w with f32 sums, is kernel D's
// function and runs on q8_matmul.cu.)
//
// L sums every byte of a u8 tensor into one int32, wrapping mod 2^32 as the
// TPU kernel's int32 accumulator does across its grid (the 7B gate_up
// weight sums to about 8.7e9, so the wrap is part of the function).  Integer
// addition mod 2^32 does not depend on order, so per-thread sums, a warp
// reduction and one atomicAdd a block give the same bits whatever order the
// blocks run in.  It is bound by the read: 67.9 MB at 3.35 TB/s is 0.020 ms.
//
// M, O and P are matvecs of int8 activations (the probe's quant_act codes)
// against int8 weights (M) or split-half int4 weights (O, P: byte j of a row
// holds input j in its low nibble and input j + K/2 in its high nibble), with
// exact int32 sums (|y| <= 127 * 128 * 18944 < 2^31) and an f32 epilogue:
//   M: y = f32(x . w) * scale[o]                                  scale [1, O]
//   O, P: y = f32(x_lo . w_lo) * scale[0][o] + f32(x_hi . w_hi) * scale[1][o]
// O reads a nibble n as n - 8 (the probe's offset storage), P as the
// two's-complement value of its four bits (the probe's int8 shifts).  The
// epilogue is written with __fmul_rn / __fadd_rn so that nvcc contracts
// nothing into an FMA: the result then equals the plain PyTorch version
// (separate convert, multiply and add) bit for bit.
//
// What bounds them: at B = 1 the weight is read once for 2 integer
// operations a weight value, far below what makes Hopper compute-bound, so
// the floor is the weight read (135.8 MB of int8 gate_up, 0.041 ms; 67.9 MB
// of int4, 0.020 ms).  As in the port's other matvecs, one warp owns one
// output row and each lane reads 16 bytes of it a step, 512 contiguous bytes
// a warp; x (int8) is staged in shared memory, 8 batch rows by 2048 weight
// columns at a time, and every warp of the block reads it from there; the
// products go through __dp4a (four int8 products and an int32 add an
// instruction).  A simple, correct first version: no tensor cores (mma.sync
// s8, wgmma), no TMA, no cp.async pipelining between stages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- L: wrapping byte sum ----------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumBlocks = 1056;  // 8 blocks on each of 132 SMs

__global__ void __launch_bounds__(kSumThreads)
    u8_sum_kernel(const uint4* __restrict__ q, size_t n16, unsigned int* __restrict__ out) {
  unsigned int sum = 0u;
  const size_t stride = static_cast<size_t>(gridDim.x) * kSumThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x; i < n16;
       i += stride) {
    const uint4 v = q[i];
    // Each __dp4a adds the four bytes of a word (times 1) to the sum.
    sum = __dp4a(v.x, 0x01010101u, sum);
    sum = __dp4a(v.y, 0x01010101u, sum);
    sum = __dp4a(v.z, 0x01010101u, sum);
    sum = __dp4a(v.w, 0x01010101u, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __shared__ unsigned int warp_sums[kSumThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < kSumThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) atomicAdd(out, sum);
  }
}

// --- M, O, P: int8 activations, dp4a matvecs ---------------------------------

constexpr int kWarps = 8;      // output rows a block, one a warp
constexpr int kBatch = 8;      // batch rows a pass over the weight
constexpr int kChunk = 2048;   // weight columns (bytes) a stage of x

__device__ __forceinline__ int dot16(const uint4& w, const uint4& x, int acc) {
  acc = __dp4a(static_cast<int>(w.x), static_cast<int>(x.x), acc);
  acc = __dp4a(static_cast<int>(w.y), static_cast<int>(x.y), acc);
  acc = __dp4a(static_cast<int>(w.z), static_cast<int>(x.z), acc);
  return __dp4a(static_cast<int>(w.w), static_cast<int>(x.w), acc);
}

__device__ __forceinline__ void warp_sum(int& v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
}

// Copies x[b0 : b0 + nb, col0 + k0 : col0 + k0 + kc] (row stride K) into xs
// (row stride kChunk), 16 bytes a thread; the barriers around it are the
// caller's.
__device__ __forceinline__ void stage_x(int8_t* xs, const int8_t* __restrict__ x, int K,
                                        int b0, int nb, int col0, int kc) {
  const int vecs = kc / 16;
  for (int v = threadIdx.x; v < nb * vecs; v += blockDim.x) {
    const int r = v / vecs;
    const int c = (v - r * vecs) * 16;
    *reinterpret_cast<uint4*>(xs + r * kChunk + c) =
        *reinterpret_cast<const uint4*>(x + static_cast<size_t>(b0 + r) * K + col0 + c);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    i8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int B, int O, int K) {
  __shared__ __align__(16) int8_t xs[kBatch * kChunk];
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int8_t* qrow = q + static_cast<size_t>(o) * K;

  for (int b0 = 0; b0 < B; b0 += kBatch) {
    const int nb = min(kBatch, B - b0);
    int acc[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) acc[r] = 0;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      __syncthreads();  // the previous stage's readers are done
      stage_x(xs, x, K, b0, nb, k0, kc);
      __syncthreads();
      if (o < O) {
#pragma unroll 4
        for (int c = 16 * lane; c < kc; c += 512) {
          const uint4 w = *reinterpret_cast<const uint4*>(qrow + k0 + c);
#pragma unroll
          for (int r = 0; r < kBatch; ++r)
            if (r < nb)
              acc[r] = dot16(w, *reinterpret_cast<const uint4*>(xs + r * kChunk + c), acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      warp_sum(acc[r]);
      if (lane == 0 && r < nb && o < O)
        y[static_cast<size_t>(b0 + r) * O + o] = __fmul_rn(__int2float_rn(acc[r]), scale[o]);
    }
  }
}

// The two readings of a word of four packed bytes: its four low nibbles and
// its four high nibbles, each as a signed int8 lane of the result (the byte
// order kept, so lane k of ``lo`` is input c + k and of ``hi`` input
// K/2 + c + k).

// Kernel O: the nibble holds w + 8 (the probe's (b & 15) - 8, (b >> 4) - 8).
struct OffsetNibbles {
  __device__ __forceinline__ static void decode(uint32_t b, int& lo, int& hi) {
    lo = static_cast<int>(__vsub4(b & 0x0F0F0F0Fu, 0x08080808u));
    hi = static_cast<int>(__vsub4((b >> 4) & 0x0F0F0F0Fu, 0x08080808u));
  }
};

// Kernel P: the nibble is a two's-complement int4 (the probe's
// (int8(b) << 4) >> 4 and int8(b) >> 4): sign-extended as (n ^ 8) - 8.
struct SignedNibbles {
  __device__ __forceinline__ static void decode(uint32_t b, int& lo, int& hi) {
    lo = static_cast<int>(__vsub4((b & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
    hi = static_cast<int>(__vsub4(((b >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
  }
};

template <typename Nibbles>
__global__ void __launch_bounds__(kWarps * 32)
    q4_i8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ y,
                 int B, int O, int half) {
  __shared__ __align__(16) int8_t xs_lo[kBatch * kChunk];
  __shared__ __align__(16) int8_t xs_hi[kBatch * kChunk];
  const int K = 2 * half;
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const uint8_t* qrow = q + static_cast<size_t>(o) * half;

  for (int b0 = 0; b0 < B; b0 += kBatch) {
    const int nb = min(kBatch, B - b0);
    int acc_lo[kBatch], acc_hi[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) acc_lo[r] = acc_hi[r] = 0;
    for (int k0 = 0; k0 < half; k0 += kChunk) {
      const int kc = min(kChunk, half - k0);
      __syncthreads();
      stage_x(xs_lo, x, K, b0, nb, k0, kc);
      stage_x(xs_hi, x, K, b0, nb, half + k0, kc);
      __syncthreads();
      if (o < O) {
#pragma unroll 2
        for (int c = 16 * lane; c < kc; c += 512) {
          const uint4 packed = *reinterpret_cast<const uint4*>(qrow + k0 + c);
          uint4 lo, hi;
          int l, h;
          Nibbles::decode(packed.x, l, h); lo.x = l; hi.x = h;
          Nibbles::decode(packed.y, l, h); lo.y = l; hi.y = h;
          Nibbles::decode(packed.z, l, h); lo.z = l; hi.z = h;
          Nibbles::decode(packed.w, l, h); lo.w = l; hi.w = h;
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            if (r < nb) {
              acc_lo[r] = dot16(lo, *reinterpret_cast<const uint4*>(xs_lo + r * kChunk + c),
                                acc_lo[r]);
              acc_hi[r] = dot16(hi, *reinterpret_cast<const uint4*>(xs_hi + r * kChunk + c),
                                acc_hi[r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      warp_sum(acc_lo[r]);
      warp_sum(acc_hi[r]);
      if (lane == 0 && r < nb && o < O)
        y[static_cast<size_t>(b0 + r) * O + o] =
            __fadd_rn(__fmul_rn(__int2float_rn(acc_lo[r]), scale[o]),
                      __fmul_rn(__int2float_rn(acc_hi[r]), scale[O + o]));
    }
  }
}

template <typename Nibbles>
int launch_q4_i8(const void* x, const void* q, const void* scale, void* y, int B, int O,
                 int half, void* stream) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kWarps - 1) / kWarps);
  q4_i8_kernel<Nibbles><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: n bytes (n % 16 == 0, 16-byte aligned), out: one int32, set to the
// wrapped sum (zeroed first on the same stream).
extern "C" int vt_u8_sum(const void* q, long long n, void* out, void* stream) {
  if (n < 16 || n % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n16 = n / 16;
  const int blocks = static_cast<int>(
      n16 / kSumThreads + 1 < kSumBlocks ? n16 / kSumThreads + 1 : kSumBlocks);
  u8_sum_kernel<<<blocks, kSumThreads, 0, s>>>(static_cast<const uint4*>(q),
                                                static_cast<size_t>(n16),
                                                static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: [B, K] int8, q: [O, K] int8, scale: [O] f32 (the probe's [1, O]),
// y: [B, O] f32.  Every pointer 16-byte aligned, every array contiguous,
// K % 16 == 0 (the wrapper checks).
extern "C" int vt_i8_matmul(const void* x, const void* q, const void* scale, void* y,
                            int B, int O, int K, void* stream) {
  if (B < 1 || O < 1 || K < 16 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kWarps - 1) / kWarps);
  i8_matmul_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, K);
  return static_cast<int>(cudaGetLastError());
}

// x: [B, 2*half] int8, q: [O, half] u8 split-half packed, scale: [2, O] f32
// (the s_lo row, then the s_hi row), y: [B, O] f32.  Alignment and
// contiguity as above, half % 16 == 0.
extern "C" int vt_q4_i8_matmul(const void* x, const void* q, const void* scale, void* y,
                               int B, int O, int half, void* stream) {
  return launch_q4_i8<OffsetNibbles>(x, q, scale, y, B, O, half, stream);
}

extern "C" int vt_q4_i8s_matmul(const void* x, const void* q, const void* scale, void* y,
                                int B, int O, int half, void* stream) {
  return launch_q4_i8<SignedNibbles>(x, q, scale, y, B, O, half, stream);
}
