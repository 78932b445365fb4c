// Int4 weight-only matmul for Hopper (sm_90a): y[B, O] f32 = x[B, I] . W[O, I]^T
//
// One kernel on the tensor cores (q4_stacked_mma_kernel, below) in four
// forms, behind four entries.  It replaces two Pallas TPU kernels of the JAX
// package, in its rounded form:
//   A: vis_tpu/ops/quantized.py:_q4_stacked_kernel (layer `idx` of a stacked
//      [L, O, I/2] weight; every decoder projection of a lookahead window)
//   B: vis_tpu/ops/quantized.py:_q4_matmul_kernel  (one [O, I/2] weight; the
//      int4 vocab head)                                 -> entry vt_q4_matmul
// in its folded form, three kernels of the int4 probe tools:
//   F: tools/probe_stacked_fused.py:_q4_stacked_folded_kernel (layer `idx`)
//   J: tools/probe_unpack.py:_q4_matmul_kernel_folded (one weight), and
//   I: tools/probe_stacked_fused.py:flat_folded (the padded vocab head sweep)
//                                                       -> entry vt_q4_matmul_folded
// and, in its signed form, one more:
//   K: tools/probe_unpack.py:_i4_matmul_kernel (native signed int4)
//                                                       -> entry vt_i4_matmul
// and, in a gated form and a slab-batched launch of the folded form, the
// probes' fused int4 SwiGLU MLP:
//   H: tools/probe_stacked_fused.py:_q4_fused_mlp_kernel (launched by
//      q4_fused_mlp, variant F)                         -> entry vt_q4_fused_mlp
// An entry takes one layer's pointers: in torch `stack.q[idx]` is a view, so
// A and B, and F, J and I, are the same launch.
//
// H over repack_slabs' per-slab layout (one layer): gq [n, 2bi, H/2] u8 (slab
// j: gate rows, then up rows, split-half packed), gs [n, 2, 2bi] (slab j's
// s_lo row, then its s_hi row), dq [n, H, bi/2] u8 (slab j's act column c
// low, c + bi/2 high), ds [n, 2, H]; y = sum over j = 0..n-1, in that
// order, of slab j's folded down product of act_j = bf16(g sigmoid(g) u).
// What bounds it: the weight bytes, 3 H I / 2 (101.8 MB at the probe's 16
// slabs of 1184, H 3584) and 0.8 MB of scales, 0.031 ms at 3.35 TB/s.  The
// TPU walks the slabs in grid order and carries y in its output block
// (o_ref += d); blocks on Hopper run in no order and a float atomicAdd would
// change the sum's order from run to run, so H is three launches on one
// stream, each output summed in a fixed order:
//   1. Gated (the folded form with two M operands, as q8_matmul.cu's gated
//      form for kernel E): a warp owns 16 act columns of one slab and reads
//      their gate and up rows against one x fragment; the lo and hi sums of
//      each stay apart, are scaled after the sum, and the lane-local
//      epilogue writes act = bf16(g * sigmoid(g) * u) slab-major, to a
//      [n, B, bi] bf16 scratch, so that slab j's act is a contiguous
//      [B, bi] x of the folded form (1184 tiles at the probe's shape);
//   2. the folded form once per slab, one launch over (tile, slab) on grid
//      z: x = act[j] (half = bi / 2 = 592, a multiple of 16 but not of 64:
//      every row ends in a partial chunk), q = dq[j], scale = ds[j], each
//      slab's partial to a [n, B, H] f32 scratch (16 x 224 = 3584 warp
//      tiles, enough to fill the card with no K split);
//   3. slab_sum_kernel: y = ((0 + d_0) + d_1) + ... + d_{n-1} in f32, the
//      plain version's order and the TPU's.
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
//   - Signed (K): another packing, the port's pack_int4_adjacent: q[o, k]
//     holds input 2k in the low nibble and 2k + 1 in the high nibble, each as
//     its two's-complement bits, and one scale a row, [1, O].  The TPU
//     converts each value to bf16 (exact), sums bf16 x times it in f32 and
//     multiplies the sum by the row's scale once; so does the kernel, with
//     one rounded multiply after all the sums.
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
//   - Signed: a lane's 16 bytes are 32 contiguous inputs, so word m feeds one
//     product with bytes (4m, 4m + 1) and another with bytes (4m + 2, 4m + 3),
//     each byte the bf16 pair {low nibble, high nibble} (fragment registers
//     0 and 2); x's fragments are then 8 contiguous bytes each, 64 bytes a
//     lane a chunk.  Dequant: one PRMT takes byte k of w and of w >> 4 (the
//     two nibbles, each in a byte's low bits), one LOP3 masks them, puts a
//     0x43 high byte over each and flips bit 3, which turns two's complement
//     v into offset binary v + 8, and one bf16x2 subtract of 136 leaves v,
//     exact: ~1.6 instructions a value.  x stays contiguous in shared
//     memory, its 16-byte units swizzled (unit u at u ^ 2 where bit 3 of u is
//     set) so that the quarter-warp's four lanes of a row, 64 bytes apart,
//     hit distinct bank groups.
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
//   - Each lane keeps the next two chunks' weight loads (4 x 16 bytes; the
//     gated form 8) in flight while it computes the current one.
//   - B > 8 runs 2 or 4 n-tiles a block (up to 32 batch rows) and more rows
//     in blocks of their own (grid y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kAWarps = 8;                // warps a block when K is split or B > 8
constexpr int kAMaxWarps = 20;            // a block's warps at most (one a tile, B <= 8)
constexpr int kAGatedMaxWarps = 10;       // the same, gated (two operands' registers)
constexpr int kChunk = 64;                // packed bytes of a row per warp step
constexpr int kSlabBudget = 72 * 1024;    // bytes of x a block stages at once
constexpr int kMaxPassRows = 32;          // batch rows a block takes (4 n-tiles)
constexpr int kASmemMax = kSlabBudget + kMaxPassRows * 16;

enum class Form { Rounded, Folded, Signed, Gated };

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

// Signed: bf16x2 {v_lo, v_hi} of byte K of the word w of two's-complement
// nibbles, exact; s = w >> 4.  The PRMT takes byte K of w and of s (each
// with its nibble in the low bits) into bytes 0 and 2; the LOP3 (& 0x000F000F,
// ^ 0x43084308) keeps those nibbles, flips their bit 3 (v + 8, offset binary)
// and puts 0x43 above each: bf16 0x43nn = 128 + n.  Subtracting 136 leaves v.
template <int K>
__device__ __forceinline__ uint32_t signed2(uint32_t w, uint32_t s) {
  const uint32_t biased =
      (__byte_perm(w, s, (K | (K << 4) | ((4 + K) << 8) | ((4 + K) << 12))) & 0x000F000Fu) ^
      0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                      __ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of word m of a lane's 16 bytes of rows g (w0) and g + 8
// (w1), for two products, a_lo and a_hi.  Fragment registers 0 / 2 are row g
// at k-slots (2t, 2t+1) / (2t+8, 2t+9); registers 1 / 3 the same for row g + 8.
// Rounded and folded: a_lo holds the low-nibble values, a_hi the high-nibble
// ones, registers 0 / 2 bytes (4m, 4m+1) / (4m+2, 4m+3) of each.  Rounded,
// each value is scaled by its row's and half's scale; folded, it is n - 8
// and the scales wait for the epilogue.  Signed: a_lo takes bytes 4m / 4m+1,
// a_hi bytes 4m+2 / 4m+3, each byte both its nibbles (inputs 2b, 2b + 1).
template <Form F>
__device__ __forceinline__ void dequant_word(uint32_t w0, uint32_t w1, float s0_lo, float s0_hi,
                                             float s1_lo, float s1_hi, uint32_t (&a_lo)[4],
                                             uint32_t (&a_hi)[4]) {
  if constexpr (F == Form::Signed) {
    const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
    a_lo[0] = signed2<0>(w0, h0);
    a_lo[1] = signed2<0>(w1, h1);
    a_lo[2] = signed2<1>(w0, h0);
    a_lo[3] = signed2<1>(w1, h1);
    a_hi[0] = signed2<2>(w0, h0);
    a_hi[1] = signed2<2>(w1, h1);
    a_hi[2] = signed2<3>(w0, h0);
    a_hi[3] = signed2<3>(w1, h1);
    return;
  }
  const uint32_t n0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t n1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
  if constexpr (F == Form::Folded || F == Form::Gated) {
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

// x's B fragments for one batch row; zeros where `ok` is false (a lane past
// the row, a row past B).  Rounded and folded: the 16 low-half inputs at
// shared address `at` into xl, the matching high-half inputs (2 * slab bytes
// on) into xh.  Signed: the lane's 32 contiguous inputs at `at`, read in the
// swizzled order (`swz` is 32 for lanes t = 2, 3), pairs (8m, 8m+1) and
// (8m+2, 8m+3) into xl[2m], xl[2m+1] and the next two into xh.
template <Form F>
__device__ __forceinline__ void x_frags(uint32_t at, int slab, uint32_t swz, bool ok,
                                        uint32_t (&xl)[8], uint32_t (&xh)[8]) {
  uint4 v[4] = {};
  if constexpr (F == Form::Signed) {
    if (ok) {
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = lds128(at + ((16u * m) ^ swz));
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      xl[2 * m] = v[m].x;
      xl[2 * m + 1] = v[m].y;
      xh[2 * m] = v[m].z;
      xh[2 * m + 1] = v[m].w;
    }
    return;
  }
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
// [O, 2] rounded, [2, O] folded, [1, O] signed.  Folded, grid z walks a
// stack of such matvecs at their natural strides (x [B, 2*half], q [O,
// half], scale [2, O], y [B, O] each): H's per-slab down products.  Gated
// (H's stage 1): O = n * bi act columns of n slabs of bi = slab_rows; column
// o = j * bi + c reads gate row j * 2bi + c and up row j * 2bi + bi + c of q
// [n * 2bi, half] as two M operands (scales [n, 2, 2bi]: slab j's s_lo row,
// then its s_hi row) and writes act[j, b, c] = bf16(g * sigmoid(g) * u) to
// y, a bf16 [n, B, bi].
// Grid: (blocks of warps / splits 16-row tiles, passes of NT * 8 batch rows,
// matvecs of the stack).  Warp w takes tile w % tiles_per_block and every
// splits-th chunk from w / tiles_per_block.  Shared memory holds the pass's
// x rows for one slab of `slab` packed bytes: [lo inputs | hi inputs | 16
// bytes of pad] per row (signed: the slab's 2 * slab contiguous inputs,
// swizzled, then the pad).
template <int NT, Form F>
__global__ void __launch_bounds__(NT == 1 ? (F == Form::Gated ? kAGatedMaxWarps : kAMaxWarps) * 32
                                          : kAWarps * 32,
                                  NT == 1 || F == Form::Gated ? 1 : 2)
    q4_stacked_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                          const float* __restrict__ scale, void* __restrict__ y, int B, int O,
                          int half, int splits, int slab, int slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool Gated = F == Form::Gated, Signed = F == Form::Signed;
  constexpr bool Folded = F == Form::Folded || Gated;  // the folded arithmetic
  constexpr int kMats = Gated ? 2 : 1;  // M operands a warp reads: gate and up, or one
  if constexpr (F == Form::Folded) {
    const size_t z = blockIdx.z;
    x += z * B * 2 * half;
    q += z * O * half;
    scale += z * 2 * O;
    y = static_cast<float*>(y) + z * B * O;
  }
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
  const uint32_t swz = (t4 & 2) * 16;  // signed x: lanes t = 2, 3 read units ^ 2

  const int o_lo = tile * 16 + g, o_hi = o_lo + 8;
  const bool tile_ok = tile * 16 < O;
  const bool ok_lo = o_lo < O, ok_hi = o_hi < O;
  // Gated: the tile's slab and its first column there (bi % 16 == 0, so a
  // tile never straddles two slabs).
  const int slab_j = Gated ? tile * 16 / slab_rows : 0;
  const int col0 = Gated ? tile * 16 - slab_j * slab_rows : 0;
  // Weight row of output o for M operand mt.
  auto row_of = [&](int o, int mt) {
    if constexpr (Gated) return (2 * slab_j + mt) * slab_rows + o - tile * 16 + col0;
    return o;
  };
  // Scale of (output, M operand, nibble half): [O, 2] rounded, [2, O] folded,
  // [n, 2, 2bi] gated; signed has one a row (its _lo), [1, O].
  auto scale_of = [&](int o, int mt, int part) {
    if constexpr (Signed) return part == 0 ? scale[o] : 0.f;
    if constexpr (Gated)
      return scale[(2 * slab_j + part) * 2 * slab_rows + mt * slab_rows + o - tile * 16 + col0];
    return Folded ? scale[part * O + o] : scale[2 * o + part];
  };
  float s0_lo[kMats], s0_hi[kMats], s1_lo[kMats], s1_hi[kMats];
  const uint8_t* q_lo[kMats];
  const uint8_t* q_hi[kMats];
#pragma unroll
  for (int mt = 0; mt < kMats; ++mt) {
    s0_lo[mt] = ok_lo ? scale_of(o_lo, mt, 0) : 0.f;
    s0_hi[mt] = ok_lo ? scale_of(o_lo, mt, 1) : 0.f;
    s1_lo[mt] = ok_hi ? scale_of(o_hi, mt, 0) : 0.f;
    s1_hi[mt] = ok_hi ? scale_of(o_hi, mt, 1) : 0.f;
    q_lo[mt] = q + static_cast<size_t>(ok_lo ? row_of(o_lo, mt) : 0) * half + 16 * t4;
    q_hi[mt] = q + static_cast<size_t>(ok_hi ? row_of(o_hi, mt) : 0) * half + 16 * t4;
  }

  // Chunk c's 16 bytes of rows g and g + 8 of each M operand (zeros past the
  // row or past O): w0[mt] row g, w1[mt] row g + 8.
  auto load_w = [&](int c, uint4 (&w0)[kMats], uint4 (&w1)[kMats]) {
#pragma unroll
    for (int mt = 0; mt < kMats; ++mt) w0[mt] = w1[mt] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks && c * kChunk + 16 * t4 < half) {
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt) {
        if constexpr (Gated) {  // the whole 256-byte block around each load, as q8_matmul.cu
          if (ok_lo) w0[mt] = ldg_stream256(q_lo[mt] + c * kChunk);
          if (ok_hi) w1[mt] = ldg_stream256(q_hi[mt] + c * kChunk);
        } else {
          if (ok_lo) w0[mt] = ldg_stream(q_lo[mt] + c * kChunk);
          if (ok_hi) w1[mt] = ldg_stream(q_hi[mt] + c * kChunk);
        }
      }
    }
  };

  // acc: every product (rounded and signed, NT > 1) or the first product
  // of each word's pair (otherwise); acc_hi: the second's (rounded and signed
  // NT == 1, which add it to acc at the end, and folded, which keeps the low
  // and high nibbles' sums apart until the epilogue).
  constexpr int kHiTiles = Folded ? NT : 1;
  float acc[kMats][NT][4], acc_hi[kMats][kHiTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMats; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kHiTiles; ++nt)
      acc_hi[mt][nt][0] = acc_hi[mt][nt][1] = acc_hi[mt][nt][2] = acc_hi[mt][nt][3] = 0.f;
  }

  int c = split;
  uint4 cur0[kMats], cur1[kMats], nxt0[kMats], nxt1[kMats];
  load_w(c, cur0, cur1);
  load_w(c + splits, nxt0, nxt1);
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int c_begin = sl * slab_chunks, c_end = min(n_chunks, c_begin + slab_chunks);
    const int pieces = (min(half, c_end * kChunk) - c_begin * kChunk) / 8;  // of a half's row
    if (sl > 0) __syncthreads();  // every warp is done with the last slab
    for (int i = threadIdx.x; i < nb * 2 * pieces; i += blockDim.x) {
      const int r = i / (2 * pieces);
      if constexpr (Signed) {
        const int u = i % (2 * pieces);  // 16-byte unit of the row's contiguous inputs
        cp_async16(x_s + r * row_bytes + (u ^ ((u >> 2) & 2)) * 16,
                   x + static_cast<size_t>(b0 + r) * in_dim + 2 * c_begin * kChunk + u * 8);
      } else {
        const int part = (i / pieces) & 1, p = i % pieces;
        cp_async16(x_s + r * row_bytes + part * 2 * slab + p * 16,
                   x + static_cast<size_t>(b0 + r) * in_dim + part * half + c_begin * kChunk +
                       p * 8);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (!tile_ok) continue;
    for (; c < c_end; c += splits) {
      uint4 fut0[kMats], fut1[kMats];
      load_w(c + 2 * splits, fut0, fut1);
      // Shared address of this lane's 16 low-half inputs (signed: its 32
      // inputs) in batch row 0.
      const uint32_t x_at = x_s + ((c - c_begin) * kChunk + 16 * t4) * (Signed ? 4 : 2);
      const bool lane_ok = c * kChunk + 16 * t4 < half;
      if constexpr (NT == 1) {
        // One n-tile: x's fragments first, then word by word the dequant
        // and its two products, low nibbles into acc, high into acc_hi, so
        // that each product's latency hides under the next word's dequant.
        uint32_t xl[8], xh[8];
        x_frags<F>(x_at + g * row_bytes, slab, swz, lane_ok && g < nb, xl, xh);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int mt = 0; mt < kMats; ++mt) {
            const uint32_t r0[4] = {cur0[mt].x, cur0[mt].y, cur0[mt].z, cur0[mt].w};
            const uint32_t r1[4] = {cur1[mt].x, cur1[mt].y, cur1[mt].z, cur1[mt].w};
            uint32_t a_lo[4], a_hi[4];
            dequant_word<F>(r0[m], r1[m], s0_lo[mt], s0_hi[mt], s1_lo[mt], s1_hi[mt], a_lo,
                            a_hi);
            mma_bf16(acc[mt][0], a_lo, xl[2 * m], xl[2 * m + 1]);
            mma_bf16(acc_hi[mt][0], a_hi, xh[2 * m], xh[2 * m + 1]);
          }
      } else {
        // Gated: one operand at a time (its dequantized words, then every
        // n-tile's products), which rereads x's fragments but keeps half
        // the registers.
#pragma unroll
        for (int mt = 0; mt < kMats; ++mt) {
          const uint32_t r0[4] = {cur0[mt].x, cur0[mt].y, cur0[mt].z, cur0[mt].w};
          const uint32_t r1[4] = {cur1[mt].x, cur1[mt].y, cur1[mt].z, cur1[mt].w};
          uint32_t a[8][4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            dequant_word<F>(r0[m], r1[m], s0_lo[mt], s0_hi[mt], s1_lo[mt], s1_hi[mt], a[m],
                            a[m + 4]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = nt * 8 + g;
            uint32_t xl[8], xh[8];
            x_frags<F>(x_at + r * row_bytes, slab, swz, lane_ok && r < nb, xl, xh);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              mma_bf16(acc[mt][nt], a[m], xl[2 * m], xl[2 * m + 1]);
              if constexpr (Folded)
                mma_bf16(acc_hi[mt][nt], a[m + 4], xh[2 * m], xh[2 * m + 1]);
              else
                mma_bf16(acc[mt][nt], a[m + 4], xh[2 * m], xh[2 * m + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt) {
        cur0[mt] = nxt0[mt];
        cur1[mt] = nxt1[mt];
        nxt0[mt] = fut0[mt];
        nxt1[mt] = fut1[mt];
      }
    }
  }

  if constexpr (NT == 1 && !Folded) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][0][e] += acc_hi[0][0][e];
  }
  // The K splits' partial sums, added in warp order (folded: each of the
  // two sums on its own; gated: each operand's apart).
  constexpr int kSums = Folded ? 2 : 1;
  if (splits > 1) {
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = ((threadIdx.x * NT + nt) * kMats + mt) * kSums;
          red[at * 4 + e] = acc[mt][nt][e];
          if constexpr (Folded) red[(at + 1) * 4 + e] = acc_hi[mt][nt][e];
        }
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f, sum_hi = 0.f;
          for (int sp = 0; sp < splits; ++sp) {
            const int at =
                ((((sp * tiles_per_block + warp) * 32 + lane) * NT + nt) * kMats + mt) * kSums;
            sum += red[at * 4 + e];
            if constexpr (Folded) sum_hi += red[(at + 1) * 4 + e];
          }
          acc[mt][nt][e] = sum;
          if constexpr (Folded) acc_hi[mt][nt][e] = sum_hi;
        }
  }
  if (!tile_ok) return;
  // acc[mt][nt]: (row g, batch 2t / 2t+1) in 0 / 1, (row g + 8, ...) in 2 / 3.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * t4 + e;
      if (r >= nb) continue;
      if constexpr (Gated) {
        // act[j, b, c]: the slab's [B, bi] block, the layout stage 2 reads.
        __nv_bfloat16* act = static_cast<__nv_bfloat16*>(y) +
                             (static_cast<size_t>(slab_j) * B + b0 + r) * slab_rows + col0 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e;
          const float sl[2] = {h ? s1_lo[0] : s0_lo[0], h ? s1_lo[1] : s0_lo[1]};
          const float sh[2] = {h ? s1_hi[0] : s0_hi[0], h ? s1_hi[1] : s0_hi[1]};
          const float gv = __fadd_rn(__fmul_rn(acc[0][nt][i], sl[0]),
                                     __fmul_rn(acc_hi[0][nt][i], sh[0]));
          const float uv = __fadd_rn(__fmul_rn(acc[1][nt][i], sl[1]),
                                     __fmul_rn(acc_hi[1][nt][i], sh[1]));
          const float sigmoid = 1.f / (1.f + expf(-gv));
          act[8 * h] = __float2bfloat16(gv * sigmoid * uv);
        }
        continue;
      }
      float* yr = static_cast<float*>(y) + static_cast<size_t>(b0 + r) * O;
      if constexpr (Folded) {
        if (ok_lo)
          yr[o_lo] = __fadd_rn(__fmul_rn(acc[0][nt][e], s0_lo[0]),
                               __fmul_rn(acc_hi[0][nt][e], s0_hi[0]));
        if (ok_hi)
          yr[o_hi] = __fadd_rn(__fmul_rn(acc[0][nt][2 + e], s1_lo[0]),
                               __fmul_rn(acc_hi[0][nt][2 + e], s1_hi[0]));
      } else if constexpr (Signed) {
        if (ok_lo) yr[o_lo] = __fmul_rn(acc[0][nt][e], s0_lo[0]);
        if (ok_hi) yr[o_hi] = __fmul_rn(acc[0][nt][2 + e], s1_lo[0]);
      } else {
        if (ok_lo) yr[o_lo] = acc[0][nt][e];
        if (ok_hi) yr[o_hi] = acc[0][nt][2 + e];
      }
    }
  }
}

// H's stage 3: y[i] = ((0 + part[0][i]) + part[1][i]) + ... + part[n-1][i]
// over `count` = B * H outputs, the slabs added in order as the TPU's
// o_ref += d adds them.
__global__ void slab_sum_kernel(const float* __restrict__ part, float* __restrict__ y, int n,
                                int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int j = 0; j < n; ++j) sum += part[static_cast<size_t>(j) * count + i];
  y[i] = sum;
}

// One launch of the matvec: `batches` matvecs of the stack (grid z, folded
// only), `slab_rows` the gated form's slab width.
template <int NT, Form F>
int launch_pass(const void* x, const void* q, const void* scale, void* y, int B, int O,
                int half, int batches, int slab_rows, cudaStream_t stream) {
  constexpr int kMats = F == Form::Gated ? 2 : 1;
  constexpr int kMaxWarps = F == Form::Gated ? kAGatedMaxWarps : kAMaxWarps;
  static bool sized[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(q4_stacked_mma_kernel<NT, F>,
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
  int warps, splits;
  block_shape(NT == 1, tiles, passes, batches, kAWarps, kMaxWarps, warps, splits);
  const int tiles_per_block = warps / splits;
  size_t smem = static_cast<size_t>(rows) * (4 * slab + 16);
  if (splits > 1)
    smem = std::max(smem, static_cast<size_t>(warps) * 32 * NT * 4 * sizeof(float) * kMats *
                              (F == Form::Folded || F == Form::Gated ? 2 : 1));
  const dim3 grid((tiles + tiles_per_block - 1) / tiles_per_block, passes, batches);
  q4_stacked_mma_kernel<NT, F><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), y, B, O, half, splits, slab, slab_rows);
  return static_cast<int>(cudaGetLastError());
}

// Every entry: one, two or four n-tiles a block by B.
template <Form F>
int launch(const void* x, const void* q, const void* scale, void* y, int B, int O, int half,
           cudaStream_t stream, int batches = 1, int slab_rows = 0) {
  if (B < 1 || O < 1 || half < 16 || half % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 8) return launch_pass<1, F>(x, q, scale, y, B, O, half, batches, slab_rows, stream);
  if (B <= 16) return launch_pass<2, F>(x, q, scale, y, B, O, half, batches, slab_rows, stream);
  return launch_pass<4, F>(x, q, scale, y, B, O, half, batches, slab_rows, stream);
}

}  // namespace

// x: [B, 2*half] bf16, q: [O, half] u8 (one weight, or the picked layer of
// a stacked one), scale: [O, 2] f32, y: [B, O] f32.  Every pointer 16-byte
// aligned, every array contiguous (the wrapper checks).
extern "C" int vt_q4_matmul(const void* x, const void* q, const void* scale,
                            void* y, int B, int O, int half, void* stream) {
  return launch<Form::Rounded>(x, q, scale, y, B, O, half, static_cast<cudaStream_t>(stream));
}

// The folded arithmetic; the same contract but scale [2, O] f32 (the s_lo
// row, then the s_hi row).
extern "C" int vt_q4_matmul_folded(const void* x, const void* q, const void* scale,
                                   void* y, int B, int O, int half, void* stream) {
  return launch<Form::Folded>(x, q, scale, y, B, O, half, static_cast<cudaStream_t>(stream));
}

// The signed form: q [O, half] u8 of adjacent two's-complement nibbles
// (input 2k low, 2k + 1 high), scale [1, O] f32; otherwise the same contract.
extern "C" int vt_i4_matmul(const void* x, const void* q, const void* scale, void* y, int B,
                            int O, int half, void* stream) {
  return launch<Form::Signed>(x, q, scale, y, B, O, half, static_cast<cudaStream_t>(stream));
}

// Probe kernel H, one layer: x [B, H] bf16, gq [n, 2*bi, H/2] u8, gs [n, 2,
// 2*bi] f32, dq [n, H, bi/2] u8, ds [n, 2, H] f32 (repack_slabs' layout),
// scratch: act [n, B, bi] bf16 then the slabs' partial outputs [n, B, H] f32
// (n * B * (2 * bi + 4 * H) bytes), y [B, H] f32.  Every pointer 16-byte
// aligned, every array contiguous, H % 32 == 0 and bi % 32 == 0 (the wrapper
// checks).  Three launches on `stream`; returns the first error.
extern "C" int vt_q4_fused_mlp(const void* x, const void* gq, const void* gs, const void* dq,
                               const void* ds, void* scratch, void* y, int B, int H, int n,
                               int bi, void* stream) {
  if (B < 1 || n < 1 || H < 32 || H % 32 != 0 || bi < 32 || bi % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* act = scratch;
  float* part = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                         static_cast<size_t>(n) * B * bi * 2);
  int err = launch<Form::Gated>(x, gq, gs, act, B, n * bi, H / 2, s, 1, bi);
  if (err != 0) return err;
  err = launch<Form::Folded>(act, dq, ds, part, B, H, bi / 2, s, n);
  if (err != 0) return err;
  const int count = B * H;
  slab_sum_kernel<<<(count + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(y), n, count);
  return static_cast<int>(cudaGetLastError());
}
