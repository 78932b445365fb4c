// Int4 weight-only matmul for Hopper (sm_90a): y[B, O] f32 = x[B, I] . W[O, I]^T
//
// One kernel on the tensor cores (q4_stacked_mma_kernel, below) in two
// arithmetics, behind four entries.  It replaces two Pallas TPU kernels of
// the JAX package, in its rounded form:
//   A: vis_tpu/ops/quantized.py:_q4_stacked_kernel (layer `idx` of a stacked
//      [L, O, I/2] weight; every decoder projection of a lookahead window)
//   B: vis_tpu/ops/quantized.py:_q4_matmul_kernel  (one [O, I/2] weight; the
//      int4 vocab head)                                 -> entry vt_q4_matmul
// and, in its folded form, three kernels of the int4 probe tools:
//   F: tools/probe_stacked_fused.py:_q4_stacked_folded_kernel (layer `idx`)
//   J: tools/probe_unpack.py:_q4_matmul_kernel_folded (one weight), and
//   I: tools/probe_stacked_fused.py:flat_folded (the padded vocab head sweep)
//                                                       -> entry vt_q4_matmul_folded
// An entry takes one layer's pointers: in torch `stack.q[idx]` is a view, so
// A and B, and F, J and I, are the same launch.
//
// Weight layout (same bytes as the JAX package): q[o, j] packs input j in the
// low nibble and input j + I/2 in the high nibble, both stored as value + 8.
//   - Rounded (A, B): scale [O, 2] = {s_lo, s_hi} per row, and the weight a
//     product sees is w = bf16((nibble - 8) * s), the JAX package's
//     dequantized bf16 weight (unpack_int4), so the kernel and its plain
//     PyTorch version agree up to the order of the f32 sums.
//   - Folded (F, I, J): the probes' scale layout [2, O] (row 0 s_lo, row 1
//     s_hi) and the TPU kernels' function, the scale applied once after an
//     f32 sum of bf16 x times the nibble,
//         y = (sum x_lo n_lo - 8 sum x_lo) s_lo + (sum x_hi n_hi - 8 sum x_hi) s_hi.
//     The kernel sums the same products centred, sum x_lo (n_lo - 8), which
//     is that value with the sums taken in another order: (n - 8) is exact
//     in bf16, the low and high nibbles' sums stay apart to the end, and the
//     epilogue is acc_lo * s_lo + acc_hi * s_hi, each step rounded (no FMA),
//     as the plain version's last step.  (The TPU folded the -8 into a
//     -8 * sum(x) correction, a lane-op trick for its vector unit; the
//     centred sum needs no sum of x and does not cancel, as sum x n - 8 sum x
//     does when x is near constant.)
//
// What bounds it: at the decode shapes (B = 1 to 8 rows) a launch streams
// O * I/2 bytes of packed weight plus 8 bytes of scale per row and does
// 2 * B * O * I flops, far below the ~295 flop/byte where an H100 turns
// compute-bound, so it is bound by weight bytes.  The dequant is not what
// holds it at about half of HBM's rate: on an H100 the folded form, a third
// of the rounded form's instructions a value, runs only ~5% faster.
//
// The matvec computes y^T = W . x^T with mma.sync.m16n8k16 (bf16 -> f32): a
// warp's 16 output rows are the M operand and 8 batch rows of x the N
// operand, so B <= 8 fills one n-tile, and each weight value is dequantized
// once, into the A fragment, whatever B is.  A dot product does not care
// about the order of k, so the fragment's k positions are permuted to the
// bytes a lane already holds: lane (g, t) loads 16 contiguous bytes of rows
// g and g + 8 at byte offset 16t of the warp's 64-byte chunk (a quad reads
// 64 contiguous bytes of a row), and word m of them feeds two products, the
// low nibbles (inputs j..j+3, j = chunk + 16t + 4m) and the high nibbles
// (inputs half + j..).  x's B fragment is read from shared memory with the
// same permutation: 8 contiguous bytes of batch row g.  The weight layout
// [L, O, I/2] is the one the model stores; nothing is repacked.
//   - Rounded dequant: (n - 8) exactly by the 0x4B000000 magic (one PRMT,
//     one FADD), one FMUL by s, and cvt.rn.bf16x2.f32 for two values: the
//     bits unpack_int4 gives each value, ~3.5 instructions a value.
//   - Folded dequant: one PRMT puts two nibbles under a 0x43 high byte, the
//     bf16 pair {128 + n0, 128 + n1} exactly, and one bf16x2 subtract of 136
//     gives {n0 - 8, n1 - 8}, exact: one instruction a value.
//   - x is staged once per block in shared memory, in K-slabs of at most
//     kSlabBudget bytes (down's x at B = 8 is 303 KB), rows padded by 16
//     bytes so that a quarter-warp's 16-byte reads hit 8 distinct bank groups.
//     (Double-buffering the slabs in two halves of that budget, or staging a
//     slab in groups that the warps wait for in turn, ran slower on the H100.)
//   - With enough 16-row tiles (at least 8 a SM: gate_up 2368, the heads
//     9504) each warp takes a tile and its whole K, in blocks of 8 to 20
//     warps sized so that the busiest SM gets the fewest tiles: one block of
//     18 warps a SM at Qwen's gate_up, where 8-warp blocks, two a SM, would
//     leave a second wave of 32 blocks on 32 SMs.  With fewer tiles (o, down
//     and qkv: 224-384) 8-warp blocks, two a SM, split K between their warps
//     (2, 4 or 8 ways), and the partial sums are added in shared memory in
//     warp order: no atomics, the same bits every run.
//   - Each lane keeps the next two chunks' weight loads (4 x 16 bytes) in
//     flight while it computes the current one.
//   - B > 8 runs 2 or 4 n-tiles a block (up to 32 batch rows) and more rows
//     in blocks of their own (grid y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kAWarps = 8;                // warps a block when K is split or B > 8
constexpr int kAMaxWarps = 20;            // a block's warps at most (one a tile, B <= 8)
constexpr int kChunk = 64;                // packed bytes of a row per warp step
constexpr int kSlabBudget = 72 * 1024;    // bytes of x a block stages at once
constexpr int kMaxPassRows = 32;          // batch rows a block takes (4 n-tiles)
constexpr int kASmemMax = kSlabBudget + kMaxPassRows * 16;

__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n - 8 for the nibble in byte `Byte` of `nibbles` (each byte holds one
// nibble): 0x4B0000nn is 2^23 + n as a float, exactly.
template <int Byte>
__device__ __forceinline__ float centred(uint32_t nibbles) {
  return __int_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7650 | Byte)) - 8388616.0f;
}

// Rounded: bf16x2 {bf16((n0 - 8) * s), bf16((n1 - 8) * s)} for bytes B0, B1,
// the bits unpack_int4 gives each value.
template <int B0, int B1>
__device__ __forceinline__ uint32_t dequant2(uint32_t nibbles, float s) {
  __nv_bfloat162 v = __floats2bfloat162_rn(centred<B0>(nibbles) * s, centred<B1>(nibbles) * s);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Folded: bf16x2 {n0 - 8, n1 - 8} for bytes B0, B1, exact.  The byte perm
// makes bf16 0x43nn = 128 + n (n < 16 fits the 7-bit mantissa); subtracting
// bf16 136 (0x4308) from both halves leaves n - 8.
template <int B0, int B1>
__device__ __forceinline__ uint32_t centred2(uint32_t nibbles) {
  const uint32_t biased = __byte_perm(nibbles, 0x43434343u, 0x4040 | (B1 << 8) | B0);
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                      __ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of word m of a lane's 16 bytes of rows g (w0) and g + 8
// (w1): a_lo holds the low-nibble values, a_hi the high-nibble ones.
// Fragment registers 0 / 2 are row g at k-slots (2t, 2t+1) / (2t+8, 2t+9),
// i.e. bytes (4m, 4m+1) / (4m+2, 4m+3); registers 1 / 3 the same for row g + 8.
// Rounded, each value is scaled by its row's and half's scale; folded, it
// is n - 8 and the scales wait for the epilogue.
template <bool Folded>
__device__ __forceinline__ void dequant_word(uint32_t w0, uint32_t w1, float s0_lo, float s0_hi,
                                             float s1_lo, float s1_hi, uint32_t (&a_lo)[4],
                                             uint32_t (&a_hi)[4]) {
  const uint32_t n0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t n1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
  if constexpr (Folded) {
    a_lo[0] = centred2<0, 1>(n0);
    a_lo[1] = centred2<0, 1>(n1);
    a_lo[2] = centred2<2, 3>(n0);
    a_lo[3] = centred2<2, 3>(n1);
    a_hi[0] = centred2<0, 1>(h0);
    a_hi[1] = centred2<0, 1>(h1);
    a_hi[2] = centred2<2, 3>(h0);
    a_hi[3] = centred2<2, 3>(h1);
  } else {
    a_lo[0] = dequant2<0, 1>(n0, s0_lo);
    a_lo[1] = dequant2<0, 1>(n1, s1_lo);
    a_lo[2] = dequant2<2, 3>(n0, s0_lo);
    a_lo[3] = dequant2<2, 3>(n1, s1_lo);
    a_hi[0] = dequant2<0, 1>(h0, s0_hi);
    a_hi[1] = dequant2<0, 1>(h1, s1_hi);
    a_hi[2] = dequant2<2, 3>(h0, s0_hi);
    a_hi[3] = dequant2<2, 3>(h1, s1_hi);
  }
}

// x's B fragments for one batch row: the 16 low-half inputs at shared
// address `at` into xl, the matching high-half inputs (2 * slab bytes on)
// into xh; zeros where `ok` is false (a lane past the row, a row past B).
__device__ __forceinline__ void x_frags(uint32_t at, int slab, bool ok, uint32_t (&xl)[8],
                                        uint32_t (&xh)[8]) {
  uint4 v[4] = {};
  if (ok) {
    v[0] = lds128(at);
    v[1] = lds128(at + 16);
    v[2] = lds128(at + 2 * slab);
    v[3] = lds128(at + 2 * slab + 16);
  }
  const uint32_t words[16] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w,
                              v[2].x, v[2].y, v[2].z, v[2].w, v[3].x, v[3].y, v[3].z, v[3].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xl[i] = words[i];
    xh[i] = words[8 + i];
  }
}

// y[B, O] f32 = x[B, 2*half] . W^T for one layer's q [O, half]; scale is
// [O, 2] rounded, [2, O] folded.
// Grid: (blocks of warps / splits 16-row tiles, passes of NT * 8 batch rows).
// Warp w takes tile w % tiles_per_block and every splits-th chunk from
// w / tiles_per_block.  Shared memory holds the pass's x rows for one slab of
// `slab` packed bytes: [lo inputs | hi inputs | 16 bytes of pad] per row.
template <int NT, bool Folded>
__global__ void __launch_bounds__(NT == 1 ? kAMaxWarps * 32 : kAWarps * 32, NT == 1 ? 1 : 2)
    q4_stacked_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                          const float* __restrict__ scale, float* __restrict__ y, int B,
                          int O, int half, int splits, int slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int tiles_per_block = warps / splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x * tiles_per_block + warp % tiles_per_block;
  const int split = warp / tiles_per_block;
  const int b0 = blockIdx.y * NT * 8;  // this pass's first batch row
  const int nb = min(NT * 8, B - b0);
  const int in_dim = 2 * half;
  const int n_chunks = (half + kChunk - 1) / kChunk;
  const int slab_chunks = slab / kChunk;
  const int n_slabs = (n_chunks + slab_chunks - 1) / slab_chunks;
  const int row_bytes = 4 * slab + 16;
  const uint32_t x_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int o_lo = tile * 16 + g, o_hi = o_lo + 8;
  const bool tile_ok = tile * 16 < O;
  const bool ok_lo = o_lo < O, ok_hi = o_hi < O;
  // Scale of (row, nibble half): [O, 2] rounded, [2, O] folded.
  auto scale_of = [&](int o, int part) {
    return Folded ? scale[part * O + o] : scale[2 * o + part];
  };
  const float s0_lo = ok_lo ? scale_of(o_lo, 0) : 0.f, s0_hi = ok_lo ? scale_of(o_lo, 1) : 0.f;
  const float s1_lo = ok_hi ? scale_of(o_hi, 0) : 0.f, s1_hi = ok_hi ? scale_of(o_hi, 1) : 0.f;
  const uint8_t* q_lo = q + static_cast<size_t>(ok_lo ? o_lo : 0) * half + 16 * t4;
  const uint8_t* q_hi = q + static_cast<size_t>(ok_hi ? o_hi : 0) * half + 16 * t4;

  // Chunk c's 16 bytes of rows g and g + 8 (zeros past the row or past O).
  auto load_w = [&](int c, uint4& w0, uint4& w1) {
    w0 = w1 = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks && c * kChunk + 16 * t4 < half) {
      if (ok_lo) w0 = ldg_stream(q_lo + c * kChunk);
      if (ok_hi) w1 = ldg_stream(q_hi + c * kChunk);
    }
  };

  // acc: every product (rounded, NT > 1) or the low nibbles' (otherwise);
  // acc_hi: the high nibbles' (rounded NT == 1, which adds it to acc at the
  // end, and folded, which keeps the two sums apart until the epilogue).
  constexpr int kHiTiles = Folded ? NT : 1;
  float acc[NT][4], acc_hi[kHiTiles][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kHiTiles; ++nt)
    acc_hi[nt][0] = acc_hi[nt][1] = acc_hi[nt][2] = acc_hi[nt][3] = 0.f;

  int c = split;
  uint4 cur0, cur1, nxt0, nxt1;
  load_w(c, cur0, cur1);
  load_w(c + splits, nxt0, nxt1);
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int c_begin = sl * slab_chunks, c_end = min(n_chunks, c_begin + slab_chunks);
    const int pieces = (min(half, c_end * kChunk) - c_begin * kChunk) / 8;  // of a half's row
    if (sl > 0) __syncthreads();  // every warp is done with the last slab
    for (int i = threadIdx.x; i < nb * 2 * pieces; i += blockDim.x) {
      const int r = i / (2 * pieces), part = (i / pieces) & 1, p = i % pieces;
      cp_async16(x_s + r * row_bytes + part * 2 * slab + p * 16,
                 x + static_cast<size_t>(b0 + r) * in_dim + part * half + c_begin * kChunk +
                     p * 8);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (!tile_ok) continue;
    for (; c < c_end; c += splits) {
      uint4 fut0, fut1;
      load_w(c + 2 * splits, fut0, fut1);
      // Shared address of this lane's 16 low-half inputs in batch row 0.
      const uint32_t x_at = x_s + ((c - c_begin) * kChunk + 16 * t4) * 2;
      const bool lane_ok = c * kChunk + 16 * t4 < half;
      const uint32_t r0[4] = {cur0.x, cur0.y, cur0.z, cur0.w};
      const uint32_t r1[4] = {cur1.x, cur1.y, cur1.z, cur1.w};
      if constexpr (NT == 1) {
        // One n-tile: x's fragments first, then word by word the dequant
        // and its two products, low nibbles into acc, high into acc_hi, so
        // that each product's latency hides under the next word's dequant.
        uint32_t xl[8], xh[8];
        x_frags(x_at + g * row_bytes, slab, lane_ok && g < nb, xl, xh);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t a_lo[4], a_hi[4];
          dequant_word<Folded>(r0[m], r1[m], s0_lo, s0_hi, s1_lo, s1_hi, a_lo, a_hi);
          mma_bf16(acc[0], a_lo, xl[2 * m], xl[2 * m + 1]);
          mma_bf16(acc_hi[0], a_hi, xh[2 * m], xh[2 * m + 1]);
        }
      } else {
        uint32_t a[8][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          dequant_word<Folded>(r0[m], r1[m], s0_lo, s0_hi, s1_lo, s1_hi, a[m], a[m + 4]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = nt * 8 + g;
          uint32_t xl[8], xh[8];
          x_frags(x_at + r * row_bytes, slab, lane_ok && r < nb, xl, xh);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mma_bf16(acc[nt], a[m], xl[2 * m], xl[2 * m + 1]);
            if constexpr (Folded)
              mma_bf16(acc_hi[nt], a[m + 4], xh[2 * m], xh[2 * m + 1]);
            else
              mma_bf16(acc[nt], a[m + 4], xh[2 * m], xh[2 * m + 1]);
          }
        }
      }
      cur0 = nxt0;
      cur1 = nxt1;
      nxt0 = fut0;
      nxt1 = fut1;
    }
  }

  if constexpr (NT == 1 && !Folded) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][e] += acc_hi[0][e];
  }
  // The K splits' partial sums, added in warp order (folded: each of the
  // two sums on its own).
  constexpr int kSums = Folded ? 2 : 1;
  if (splits > 1) {
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[((threadIdx.x * NT + nt) * kSums) * 4 + e] = acc[nt][e];
        if constexpr (Folded) red[((threadIdx.x * NT + nt) * kSums + 1) * 4 + e] = acc_hi[nt][e];
      }
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f, sum_hi = 0.f;
        for (int sp = 0; sp < splits; ++sp) {
          const int at = (((sp * tiles_per_block + warp) * 32 + lane) * NT + nt) * kSums;
          sum += red[at * 4 + e];
          if constexpr (Folded) sum_hi += red[(at + 1) * 4 + e];
        }
        acc[nt][e] = sum;
        if constexpr (Folded) acc_hi[nt][e] = sum_hi;
      }
  }
  if (!tile_ok) return;
  // acc[nt]: (row g, batch 2t / 2t+1) in 0 / 1, (row g + 8, ...) in 2 / 3.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * t4 + e;
      if (r >= nb) continue;
      float* yr = y + static_cast<size_t>(b0 + r) * O;
      if constexpr (Folded) {
        if (ok_lo)
          yr[o_lo] = __fadd_rn(__fmul_rn(acc[nt][e], s0_lo), __fmul_rn(acc_hi[nt][e], s0_hi));
        if (ok_hi)
          yr[o_hi] =
              __fadd_rn(__fmul_rn(acc[nt][2 + e], s1_lo), __fmul_rn(acc_hi[nt][2 + e], s1_hi));
      } else {
        if (ok_lo) yr[o_lo] = acc[nt][e];
        if (ok_hi) yr[o_hi] = acc[nt][2 + e];
      }
    }
  }
}

int num_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

template <int NT, bool Folded>
int launch_pass(const void* x, const void* q, const void* scale, void* y, int B, int O,
                int half, cudaStream_t stream) {
  static bool sized[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(q4_stacked_mma_kernel<NT, Folded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kASmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) sized[dev] = true;
  }
  const int rows = std::min(B, NT * 8);
  const int passes = (B + NT * 8 - 1) / (NT * 8);
  const int half_chunks = (half + kChunk - 1) / kChunk * kChunk;
  const int slab =
      std::min(half_chunks, std::max(kChunk, kSlabBudget / (4 * rows) / kChunk * kChunk));
  const int tiles = (O + 15) / 16;
  const int sms = num_sms();
  int warps = kAWarps, splits = 1;
  if (NT == 1 && tiles >= kAWarps * sms) {
    // A warp a tile, whole K, in blocks of 8 to kAMaxWarps warps: the size
    // that puts the fewest tiles on the busiest SM (blocks go round the SMs
    // in turn), and of equals the largest, which stages x the fewest times.
    int best = 0;
    for (int w = kAWarps; w <= kAMaxWarps; ++w) {
      const int busiest = (((tiles + w - 1) / w + sms - 1) / sms) * w;
      if (best == 0 || busiest <= best) best = busiest, warps = w;
    }
  } else {
    // The fewest K splits that give every SM two blocks (at most 8: a warp each).
    while (splits < kAWarps &&
           (tiles + kAWarps / splits - 1) / (kAWarps / splits) * passes < 2 * sms)
      splits *= 2;
  }
  const int tiles_per_block = warps / splits;
  size_t smem = static_cast<size_t>(rows) * (4 * slab + 16);
  if (splits > 1)
    smem = std::max(smem, static_cast<size_t>(warps) * 32 * NT * 4 * sizeof(float) *
                              (Folded ? 2 : 1));
  const dim3 grid((tiles + tiles_per_block - 1) / tiles_per_block, passes);
  q4_stacked_mma_kernel<NT, Folded><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), B, O, half, splits, slab);
  return static_cast<int>(cudaGetLastError());
}

// Every entry: one, two or four n-tiles a block by B.
template <bool Folded>
int launch(const void* x, const void* q, const void* scale, void* y, int B, int O, int half,
           void* stream) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8) return launch_pass<1, Folded>(x, q, scale, y, B, O, half, s);
  if (B <= 16) return launch_pass<2, Folded>(x, q, scale, y, B, O, half, s);
  return launch_pass<4, Folded>(x, q, scale, y, B, O, half, s);
}

}  // namespace

// x: [B, 2*half] bf16, q: [O, half] u8 (one weight, or the picked layer of
// a stacked one), scale: [O, 2] f32, y: [B, O] f32.  Every pointer 16-byte
// aligned, every array contiguous (the wrapper checks).
extern "C" int vt_q4_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int half, void* stream) {
  return launch<false>(x, q, scale, y, B, O, half, stream);
}

// The folded arithmetic; the same contract but scale [2, O] f32 (the s_lo
// row, then the s_hi row).
extern "C" int vt_q4_matmul_folded(const void* x, const void* q, const void* scale,
                                   void* y, int B, int O, int half, void* stream) {
  return launch<true>(x, q, scale, y, B, O, half, stream);
}
