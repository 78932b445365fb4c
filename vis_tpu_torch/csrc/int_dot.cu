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
// M: at B = 1 the weight is read once for 2 integer operations a weight
// value, far below what makes Hopper compute-bound, so the floor is the
// weight read (135.8 MB of int8 gate_up, 0.041 ms).  One warp owns one
// output row and each lane reads 16 bytes of it a step, 512 contiguous bytes
// a warp; x (int8) is staged in shared memory, 8 batch rows by 2048 weight
// columns at a time, and every warp of the block reads it from there; the
// products go through __dp4a (four int8 products and an int32 add an
// instruction).
//
// O and P (q4_i8_mma_kernel, below) are bound the same way by their weight
// bytes, half a byte a value: the probe's int4 gate_up [37888, 1792 B] is
// 67.9 MB, 0.0204 ms at 3.35 TB/s, and down [3584, 9472 B] 33.9 MB, 0.0102
// ms.  A warp a row on __dp4a reached 42% of that at gate_up on an H100:
// 3.5 steps of 512 bytes a row, half the lanes idle on the last, two loads
// in flight a lane, two 5-step shuffle reductions an output and batch row,
// 32 KB of x staged behind two barriers per 2048 bytes, and no K split at
// down.  So they are kernel A's tensor-core matvec (q4_matmul.cu) in an
// integer form, on mma.sync.m16n8k32 (s8 x s8 -> s32):
//   - The weight is the M operand (a warp's 16 output rows) and up to 8
//     batch rows of x the N operand.  Lane (g, t) loads 16 contiguous bytes
//     of rows g and g + 8 at byte 16t of the warp's 64-byte chunk; word m of
//     them holds inputs j..j+3 (j = chunk + 16t + 4m) in its low nibbles and
//     K/2 + j.. in its high ones.  A dot product does not care about the
//     order of k, so the fragments' k positions are permuted to the bytes a
//     lane holds: the low product p (p = 0, 1) takes low words 2p and 2p + 1
//     of rows g (a0, a2) and g + 8 (a1, a3), and x's B fragment is words 2p
//     and 2p + 1 of the 16 contiguous int8 of batch row g at input chunk +
//     16t (one 16-byte read); the high products read the same
//     way at K/2 + chunk + 16t.  A 64-byte chunk is 4 mma.m16n8k32 a lane
//     (2 low, 2 high) into two int32 accumulators, which stay apart until
//     the epilogue.
//   - Each word's four nibbles expand to four int8 in three integer
//     operations, no byte-wise borrow: O's stored n = v + 8 gives
//     ((w & 0x0F0F0F0F) + 0x78787878) ^ 0x80808080 = n - 8 (the add never
//     carries out of a byte: 15 + 0x78 = 0x87), the same on w >> 4 for the
//     high nibbles; P's two's-complement v becomes offset binary v + 8 by an
//     XOR of 0x08 a byte first (folded into the mask's LOP3).  The kernel's
//     one template parameter, Flip, is that XOR constant.
//   - At B <= 8 each lane reads its x from global memory with the weights,
//     two chunks ahead: batch row g's 16 low-half and 16 high-half inputs of
//     the chunk (L2 serves every block; L1 the block's other warps).  Above
//     8 rows x is staged once per block in shared memory by cp.async, in
//     K-slabs of at most kQSlabBudget bytes, a row [low inputs | high inputs
//     | 64 bytes of pad]: lanes 0-7 of a 16-byte read are rows g and g + 1
//     at 16t, and the pad puts the second row's 64 bytes in the other half
//     of the 128-byte bank cycle.  Staged at B <= 8 too (A's way), down at
//     B = 8 (151 KB of x, three slabs) took 0.0263 ms against 0.0198 read
//     from L2, on an H100 (700 W); gate_up and down at B = 1 moved by 2% or
//     less.
//   - Each weight load asks L2 for the whole 256-byte block around it
//     (ldg_stream256): a warp's load takes 64 bytes of each of 16 rows, and
//     the fetch brings the next chunks of those rows.  On the same card it
//     took gate_up at B = 1 / 8 from 0.0366 / 0.0367 to 0.0283 / 0.0302 ms,
//     and down from 0.0209 / 0.0211 to 0.0175 / 0.0174.
//   - With enough 16-row tiles (at least 8 a SM: gate_up's 2368) each warp
//     takes a tile and its whole K, in blocks of 8 to 20 warps sized so that
//     the busiest SM gets the fewest tiles (block_shape, mma.cuh, kernel A's
//     rule).  With fewer (down's 224) 8-warp blocks split K between their
//     warps (2, 4 or 8 ways) and add the int32 partial sums in shared memory
//     in warp order: exact in any order, but the same order every run and
//     no atomics.  At B <= 8 a split streams one contiguous range of chunks
//     (its next chunks are in the 256-byte blocks it fetched): down took
//     0.0175 ms at B = 1 and 8 against 0.0193-0.0196 with A's interleaved
//     chunks.  Staged x keeps the interleave, so that every warp works on
//     every slab.
//   - Each lane keeps the next two chunks' weight loads in flight while it
//     computes the current one.
//   - B > 8 runs 2 or 4 n-tiles a block (up to 32 batch rows) and more rows
//     in blocks of their own (grid y).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

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

// --- M: int8 weights, a dp4a matvec ------------------------------------------

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

// --- O, P: int4 weights, int8 x, on mma.sync.m16n8k32 s8 ----------------------

constexpr int kQWarps = 8;               // warps a block when K is split or B > 8
constexpr int kQMaxWarps = 20;           // a block's warps at most (one a tile, B <= 8)
constexpr int kQChunk = 64;              // packed bytes of a row per warp step
constexpr int kQSlabBudget = 72 * 1024;  // bytes of x a block stages at once
constexpr int kQMaxPassRows = 32;        // batch rows a block takes (4 n-tiles)
constexpr int kQPad = 64;                // bytes after each staged x row
constexpr int kQSmemMax = kQSlabBudget + kQMaxPassRows * kQPad;

// The four low (Shift 0) or high (Shift 4) nibbles of a word w of packed
// bytes as four int8, byte order kept.  Flip 0 reads a nibble n as n - 8
// (kernel O), Flip 0x08080808 as its two's-complement value (kernel P: bit 3
// flipped, which is offset binary v + 8, then the same).  n + 0x78 stays
// inside its byte (at most 0x87), and XOR 0x80 of 0x78 + n is n - 8 as int8.
template <uint32_t Flip, int Shift>
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t w) {
  return ((((w >> Shift) & 0x0F0F0F0Fu) ^ Flip) + 0x78787878u) ^ 0x80808080u;
}

// y[B, O] f32 = f32(x_lo . w_lo) * scale[0] + f32(x_hi . w_hi) * scale[1]
// for x [B, 2*half] int8, q [O, half] u8 split-half packed, scale [2, O].
// Grid: (blocks of warps / splits 16-row tiles, passes of NT * 8 batch
// rows).  Warp w takes tile w % tiles_per_block and split s = w /
// tiles_per_block of its chunks: the s-th of `splits` contiguous ranges
// when NT == 1, which reads x from global memory; every splits-th chunk
// from s when NT > 1, which stages the pass's x rows in shared memory, one
// slab of `slab` packed bytes at a time: [lo inputs | hi inputs | kQPad
// bytes] per row.
template <int NT, uint32_t Flip>
__global__ void __launch_bounds__(NT == 1 ? kQMaxWarps * 32 : kQWarps * 32, NT == 1 ? 1 : 2)
    q4_i8_mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y, int B, int O,
                     int half, int splits, int slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int tiles_per_block = warps / splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x * tiles_per_block + warp % tiles_per_block;
  const int split = warp / tiles_per_block;
  const int b0 = blockIdx.y * NT * 8;  // this pass's first batch row
  const int nb = min(NT * 8, B - b0);
  const int n_chunks = (half + kQChunk - 1) / kQChunk;

  const int o_lo = tile * 16 + g, o_hi = o_lo + 8;
  const bool tile_ok = tile * 16 < O;
  const bool ok_lo = o_lo < O, ok_hi = o_hi < O;
  const uint8_t* q_lo = q + static_cast<size_t>(ok_lo ? o_lo : 0) * half + 16 * t4;
  const uint8_t* q_hi = q + static_cast<size_t>(ok_hi ? o_hi : 0) * half + 16 * t4;

  // Chunk c's 16 bytes of rows g (w0) and g + 8 (w1); zeros from chunk
  // c_end on, past the row or past O (whose products x zeroes, below, or
  // nobody writes).
  auto load_w = [&](int c, int c_end, uint4& w0, uint4& w1) {
    w0 = w1 = make_uint4(0u, 0u, 0u, 0u);
    if (c < c_end && c * kQChunk + 16 * t4 < half) {
      if (ok_lo) w0 = ldg_stream256(q_lo + c * kQChunk);
      if (ok_hi) w1 = ldg_stream256(q_hi + c * kQChunk);
    }
  };

  int acc_lo[NT][4], acc_hi[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_lo[nt][e] = acc_hi[nt][e] = 0;

  // The four products of a chunk's weights (w0 row g, w1 row g + 8) and
  // one n-tile: x's 16 low-half (xl) and high-half (xh) inputs of its batch
  // row g, into that n-tile's lo and hi sums.
  auto products = [&](const uint4& w0, const uint4& w1, const uint4& xl, const uint4& xh,
                      int (&lo)[4], int (&hi)[4]) {
    const uint32_t r0[4] = {w0.x, w0.y, w0.z, w0.w};
    const uint32_t r1[4] = {w1.x, w1.y, w1.z, w1.w};
    uint32_t l0[4], h0[4], l1[4], h1[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      l0[m] = nibbles_s8<Flip, 0>(r0[m]);
      h0[m] = nibbles_s8<Flip, 4>(r0[m]);
      l1[m] = nibbles_s8<Flip, 0>(r1[m]);
      h1[m] = nibbles_s8<Flip, 4>(r1[m]);
    }
    const uint32_t a_lo0[4] = {l0[0], l1[0], l0[1], l1[1]};
    const uint32_t a_lo1[4] = {l0[2], l1[2], l0[3], l1[3]};
    const uint32_t a_hi0[4] = {h0[0], h1[0], h0[1], h1[1]};
    const uint32_t a_hi1[4] = {h0[2], h1[2], h0[3], h1[3]};
    mma_s8(lo, a_lo0, xl.x, xl.y);
    mma_s8(lo, a_lo1, xl.z, xl.w);
    mma_s8(hi, a_hi0, xh.x, xh.y);
    mma_s8(hi, a_hi1, xh.z, xh.w);
  };

  uint4 cur0, cur1, nxt0, nxt1;
  if constexpr (NT == 1) {
    // x from global memory (L2; L1 for the block's other warps): lane (g, t)
    // reads batch row g's 16 low-half and 16 high-half inputs of the chunk,
    // two chunks ahead with the weights.  Each split streams one contiguous
    // range of chunks, whose next chunks the 256-byte fetch has brought.
    const int per = (n_chunks + splits - 1) / splits;
    const int c_end = min(n_chunks, (split + 1) * per);
    const int8_t* x_row = x + static_cast<size_t>(b0 + (g < nb ? g : 0)) * 2 * half + 16 * t4;
    auto load_x = [&](int c, uint4& xl, uint4& xh) {
      xl = xh = make_uint4(0u, 0u, 0u, 0u);
      if (g < nb && c < c_end && c * kQChunk + 16 * t4 < half) {
        xl = __ldg(reinterpret_cast<const uint4*>(x_row + c * kQChunk));
        xh = __ldg(reinterpret_cast<const uint4*>(x_row + half + c * kQChunk));
      }
    };
    int c = split * per;
    uint4 xcl, xch, xnl, xnh;
    load_w(c, c_end, cur0, cur1);
    load_w(c + 1, c_end, nxt0, nxt1);
    load_x(c, xcl, xch);
    load_x(c + 1, xnl, xnh);
    if (tile_ok) {
      for (; c < c_end; ++c) {
        uint4 fut0, fut1, xfl, xfh;
        load_w(c + 2, c_end, fut0, fut1);
        load_x(c + 2, xfl, xfh);
        products(cur0, cur1, xcl, xch, acc_lo[0], acc_hi[0]);
        cur0 = nxt0, cur1 = nxt1, nxt0 = fut0, nxt1 = fut1;
        xcl = xnl, xch = xnh, xnl = xfl, xnh = xfh;
      }
    }
  } else {
    // Staged x: every split takes every splits-th chunk of each slab.
    const int slab_chunks = slab / kQChunk;
    const int n_slabs = (n_chunks + slab_chunks - 1) / slab_chunks;
    const int row_bytes = 2 * slab + kQPad;
    const uint32_t x_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    int c = split;
    load_w(c, n_chunks, cur0, cur1);
    load_w(c + splits, n_chunks, nxt0, nxt1);
    for (int sl = 0; sl < n_slabs; ++sl) {
      const int c_begin = sl * slab_chunks, c_end = min(n_chunks, c_begin + slab_chunks);
      // 16-byte pieces of one half's row in this slab.
      const int pieces = (min(half, c_end * kQChunk) - c_begin * kQChunk) / 16;
      if (sl > 0) __syncthreads();  // every warp is done with the last slab
      for (int i = threadIdx.x; i < nb * 2 * pieces; i += blockDim.x) {
        const int r = i / (2 * pieces), part = (i / pieces) & 1, p = i % pieces;
        cp_async16(x_s + r * row_bytes + part * slab + p * 16,
                   x + static_cast<size_t>(b0 + r) * 2 * half + part * half + c_begin * kQChunk +
                       p * 16);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (!tile_ok) continue;
      for (; c < c_end; c += splits) {
        uint4 fut0, fut1;
        load_w(c + 2 * splits, n_chunks, fut0, fut1);
        // Shared address of this lane's 16 low-half inputs in batch row 0.
        const uint32_t x_at = x_s + (c - c_begin) * kQChunk + 16 * t4;
        const bool lane_ok = c * kQChunk + 16 * t4 < half;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = nt * 8 + g;
          uint4 xl = make_uint4(0u, 0u, 0u, 0u), xh = xl;
          if (lane_ok && r < nb) {
            xl = lds128(x_at + r * row_bytes);
            xh = lds128(x_at + r * row_bytes + slab);
          }
          products(cur0, cur1, xl, xh, acc_lo[nt], acc_hi[nt]);
        }
        cur0 = nxt0, cur1 = nxt1;
        nxt0 = fut0, nxt1 = fut1;
      }
    }
  }

  // The K splits' partial sums, each of the two on its own, added in warp
  // order.
  if (splits > 1) {
    int* red = reinterpret_cast<int*>(smem);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (threadIdx.x * NT + nt) * 2;
        red[at * 4 + e] = acc_lo[nt][e];
        red[(at + 1) * 4 + e] = acc_hi[nt][e];
      }
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int sum_lo = 0, sum_hi = 0;
        for (int sp = 0; sp < splits; ++sp) {
          const int at = (((sp * tiles_per_block + warp) * 32 + lane) * NT + nt) * 2;
          sum_lo += red[at * 4 + e];
          sum_hi += red[(at + 1) * 4 + e];
        }
        acc_lo[nt][e] = sum_lo;
        acc_hi[nt][e] = sum_hi;
      }
  }
  if (!tile_ok) return;
  const float s0_lo = ok_lo ? scale[o_lo] : 0.f, s0_hi = ok_lo ? scale[O + o_lo] : 0.f;
  const float s1_lo = ok_hi ? scale[o_hi] : 0.f, s1_hi = ok_hi ? scale[O + o_hi] : 0.f;
  // acc[nt]: (row g, batch 2t / 2t+1) in 0 / 1, (row g + 8, ...) in 2 / 3.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * t4 + e;
      if (r >= nb) continue;
      float* yr = y + static_cast<size_t>(b0 + r) * O;
      if (ok_lo)
        yr[o_lo] = __fadd_rn(__fmul_rn(__int2float_rn(acc_lo[nt][e]), s0_lo),
                             __fmul_rn(__int2float_rn(acc_hi[nt][e]), s0_hi));
      if (ok_hi)
        yr[o_hi] = __fadd_rn(__fmul_rn(__int2float_rn(acc_lo[nt][2 + e]), s1_lo),
                             __fmul_rn(__int2float_rn(acc_hi[nt][2 + e]), s1_hi));
    }
  }
}

// One launch: blocks sized by block_shape; above 8 rows, x staged in
// K-slabs that fit kQSlabBudget.
template <int NT, uint32_t Flip>
int launch_q4_i8_pass(const void* x, const void* q, const void* scale, void* y, int B, int O,
                      int half, cudaStream_t stream) {
  static bool sized[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(q4_i8_mma_kernel<NT, Flip>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) sized[dev] = true;
  }
  const int rows = std::min(B, NT * 8);
  const int passes = (B + NT * 8 - 1) / (NT * 8);
  const int half_chunks = (half + kQChunk - 1) / kQChunk * kQChunk;
  const int slab =
      std::min(half_chunks, std::max(kQChunk, kQSlabBudget / (2 * rows) / kQChunk * kQChunk));
  const int tiles = (O + 15) / 16;
  int warps, splits;
  block_shape(NT == 1, tiles, passes, 1, kQWarps, kQMaxWarps, warps, splits);
  const int tiles_per_block = warps / splits;
  size_t smem = NT == 1 ? 0 : static_cast<size_t>(rows) * (2 * slab + kQPad);
  if (splits > 1)
    smem = std::max(smem, static_cast<size_t>(warps) * 32 * NT * 2 * 4 * sizeof(int));
  const dim3 grid((tiles + tiles_per_block - 1) / tiles_per_block, passes);
  q4_i8_mma_kernel<NT, Flip><<<grid, warps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half, splits, slab);
  return static_cast<int>(cudaGetLastError());
}

// One, two or four n-tiles a block by B.
template <uint32_t Flip>
int launch_q4_i8(const void* x, const void* q, const void* scale, void* y, int B, int O,
                 int half, void* stream) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8) return launch_q4_i8_pass<1, Flip>(x, q, scale, y, B, O, half, s);
  if (B <= 16) return launch_q4_i8_pass<2, Flip>(x, q, scale, y, B, O, half, s);
  return launch_q4_i8_pass<4, Flip>(x, q, scale, y, B, O, half, s);
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
  return launch_q4_i8<0u>(x, q, scale, y, B, O, half, stream);
}

extern "C" int vt_q4_i8s_matmul(const void* x, const void* q, const void* scale, void* y,
                                int B, int O, int half, void* stream) {
  return launch_q4_i8<0x08080808u>(x, q, scale, y, B, O, half, stream);
}
