// Int8 weight-only matvecs for Hopper (sm_90a), one tensor-core kernel
// (q8_mma_kernel, below) in two forms behind two entries:
//   D: y[B, O] f32 = (x[B, I] . q[O, I]^T) * scale[O]          -> vt_q8_matmul
//   E: y[B, H] f32 = (h . down[H, I]^T) * down_scale[H],
//      h[B, I] bf16 = bf16(silu(g) * u),
//      g = (x . gate[I, H]^T) * gate_scale,  u = (x . up[I, H]^T) * up_scale
//                                                               -> vt_q8_swiglu
//
// D replaces the Pallas TPU kernel vis_tpu/ops/quantized.py:_q8_matmul_kernel
// (launched by quantized_matmul).  On the port's main path under
// QUANTIZATION=int8 it is every decoder's qkv and o projection in every
// decode step (Qwen2.5-VL-7B qkv [4608, 3584] and o [3584, 3584] at B = 1
// and 8; Llama-3.1-8B qkv [6144, 4096] and o [4096, 4096] at B = 1 and 3)
// and the int8 vocab heads ([128512, 4096], 128256 rows padded to a 512
// multiple, at B = 3 in batched decode and B = 1 at the end of a prefill);
// the int8 probe's kernel N (tools/probe_unpack2.py:_mixdot_kernel) runs on
// it too.  What bounds it: the weight bytes, 1 B a value plus 4 B of scale a
// row; at B <= 8 a launch does 2 * B flops a weight byte, far below the
// ~295 flop/byte where an H100 turns compute-bound.  Its semantics are the
// TPU kernel's, not the JAX CPU fallback's: x is rounded to bf16, each int8
// converts to bf16 exactly, the products are summed in f32 and the sum is
// multiplied by scale[o] once, after the sum; rows padded with q = 0 and
// scale = 0 give exactly 0.  It is the non-gated launch of the matvec (E's
// stage 2): its projections have 224-384 tiles of 16 rows, under 4 a SM,
// so 8-warp blocks split K between their warps (qkv and o at Qwen 8 ways:
// a warp streams 7 chunks of 64 bytes of its 16 rows), and at B <= 8 every
// lane reads its x straight from L2 with the weights; the heads' 8032 tiles
// take a warp each, whole K.
//
// E replaces vis_tpu/ops/quantized.py:_fused_mlp_kernel (launched by
// fused_swiglu_mlp).  On the main path under QUANTIZATION=int8 it is every
// decoder MLP of every decode step: Qwen2.5-VL-7B (H 3584, I 18944) at B = 8
// (lookahead windows) and Llama-3.1-8B (H 4096, I 14336) at B = 3
// (scheduler slots).  The fused gate+up weight is [2I, H] int8 with gate
// rows first and one f32 scale per row ([2I]); down is [H, I] int8 with
// scales [H].  Semantics are the TPU kernel's, as D's; h is rounded to bf16
// before the down product, as the TPU kernel feeds h to the MXU in bf16.
// One call reads 3 * H * I int8 bytes plus the scales: 203.9 MB at the Qwen
// shape and 176.3 MB at the Llama shape, 60.9 us and 52.6 us at 3.35 TB/s.
//
// The TPU kernel walks the intermediate dimension I in grid order and
// carries the down product's partial sum in its output block from step to
// step.  Blocks on Hopper run in no order, and a float atomicAdd would make
// the sum's order, and so the token stream, change from run to run.  So E
// runs as two launches of the matvec on one stream, each output summed in a
// fixed order: the same bits every run (D too: no atomics anywhere).
//
//   stage 1 (Gated): a warp owns 16 intermediate columns j..j+15 and reads
//     gate rows j.. and up rows I + j.. as two M operands of
//     mma.sync.m16n8k16 (bf16 -> f32) that share x's B fragment; its
//     epilogue is lane-local (a lane's gate and up accumulators hold the same
//     (column, batch row) positions) and writes h = bf16(silu(g) * u) to the
//     [B, I] bf16 scratch the wrapper allocated (B * I * 2 bytes, 0.3 MB at
//     the Qwen shape, B = 8);
//   stage 2: D's launch on (h, down), one M operand, y = sum * scale.
//
// The matvec is kernel A's design (q4_matmul.cu) on int8 weights:
//   - The weight is the M operand and up to 8 batch rows the N operand.  A
//     lane (g, t) loads 16 contiguous bytes of rows g and g + 8 at byte 16t
//     of the warp's 64-byte chunk (a quad reads 64 contiguous bytes of a
//     row), and word m of them feeds one k16 product: fragment registers
//     0 / 2 take bytes (4m, 4m+1) / (4m+2, 4m+3), the k positions permuted
//     to the bytes a lane holds.  x's B fragments are 4 contiguous bytes of
//     bf16 each, read from shared memory with the same permutation.
//   - int8 -> bf16, exact: XOR 0x80 makes each byte v + 128; one PRMT puts a
//     byte under 0x4B00, the float 2^23 + v + 128, one FADD of -(2^23 + 128)
//     leaves v, whose f32 bits end in 16 zeros (8 significant bits at most),
//     and one PRMT packs the upper halves of two such floats into a bf16
//     pair: ~2.75 instructions a value, paid once whatever B is.
//   - Stage 1 stages x once per block in shared memory with cp.async (57 KB
//     at Qwen B = 8), rows padded by 16 bytes so that a quarter-warp's
//     16-byte reads hit 8 distinct bank groups; so does the non-gated form
//     (D, E's stage 2) at B > 8, in K-slabs of at most kSlabBudget bytes.
//     At B <= 8 the non-gated form reads x from global memory instead (L2:
//     every block reads all of it), each lane its 32 bytes of batch row g a
//     chunk, loaded ahead with the weights.  Staged, E's h (303 KB at Qwen
//     B = 8) took five slabs a block, and each slab a pause of the weight
//     stream: 0.1297 against 0.1172 ms for the whole of E at Qwen B = 8 on
//     an H100.
//   - With enough 16-row tiles (at least 4 a SM: stage 1's 1184 at Qwen,
//     896 at Llama, D's heads 8032) each warp takes a tile and its whole K,
//     in blocks of 4 to 20 warps sized so that the busiest SM gets the
//     fewest tiles (132 blocks of 9 warps at Qwen, 128 of 7 at Llama).  With
//     fewer (D's qkv and o, 224-384; stage 2's 224 and 256) 8-warp blocks
//     split K between their warps (up to 8 ways) and add the partial sums in
//     shared memory in warp order: no atomics.
//   - Each lane keeps the next two chunks' weight loads in flight while it
//     computes the current one, and each load asks L2 for the whole 256-byte
//     block around it (ldg_stream256), so device memory serves the next
//     three chunks of the warp's rows in one fetch.  On an H100 (700 W)
//     that took D's head at B = 1 from 0.2739 to 0.2157 ms (2.44 TB/s) and
//     E at Qwen B = 8 from 0.1157 to 0.0943 ms; three or more chunks in
//     flight a lane instead ran slower (qkv 0.0111 -> 0.0161 ms).
//   - B > 8 runs 2 or 4 n-tiles a block (up to 32 batch rows) and more rows
//     in blocks of their own (grid y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kWarps = 8;              // warps a block when K is split or B > 8
constexpr int kMinWarps = 4;           // a block's warps at least (one a tile, B <= 8)
constexpr int kMaxWarps = 20;          // a block's warps at most (one a tile, B <= 8)
constexpr int kChunk = 64;             // int8 weights of a row per warp step
constexpr int kSlabBudget = 72 * 1024; // bytes of x a block stages at once
constexpr int kMaxPassRows = 32;       // batch rows a block takes (4 n-tiles)
constexpr int kSmemMax = kSlabBudget + kMaxPassRows * 16;

// bf16x2 {v0, v1} of bytes B0, B1 of `biased`, each byte an int8 value v
// stored as v + 128.  0x4B0000bb is 2^23 + bb as a float, so subtracting
// 2^23 + 128 leaves v exactly, and v's f32 bits are bf16(v) followed by 16
// zeros: the PRMT keeps the two upper halves.
template <int B0, int B1>
__device__ __forceinline__ uint32_t int8x2(uint32_t biased) {
  const float v0 = __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | B0)) - 8388736.0f;
  const float v1 = __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | B1)) - 8388736.0f;
  return __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632);
}

// The A fragment of word m of a lane's 16 bytes of rows g (w0) and g + 8
// (w1): registers 0 / 2 row g at bytes (4m, 4m+1) / (4m+2, 4m+3), registers
// 1 / 3 the same bytes of row g + 8.
__device__ __forceinline__ void int8_frag(uint32_t w0, uint32_t w1, uint32_t (&a)[4]) {
  const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;
  a[0] = int8x2<0, 1>(u0);
  a[1] = int8x2<0, 1>(u1);
  a[2] = int8x2<2, 3>(u0);
  a[3] = int8x2<2, 3>(u1);
}

// x's B fragments for one batch row: the lane's 16 inputs at shared address
// `at`, word m's pair of products reading xw[2m] and xw[2m + 1]; zeros where
// `ok` is false (a lane past the row, a row past B).
__device__ __forceinline__ void x_frag(uint32_t at, bool ok, uint32_t (&xw)[8]) {
  uint4 v[2] = {};
  if (ok) {
    v[0] = lds128(at);
    v[1] = lds128(at + 16);
  }
  xw[0] = v[0].x, xw[1] = v[0].y, xw[2] = v[0].z, xw[3] = v[0].w;
  xw[4] = v[1].x, xw[5] = v[1].y, xw[6] = v[1].z, xw[7] = v[1].w;
}

// Gated (E's stage 1): out = h [B, O = I] bf16 from w = gateup [2I, K = H]
// (up's rows O rows on) and scale [2I].  Otherwise (D, E's stage 2): out =
// y [B, O] f32 from w [O, K] and scale [O].
// Grid: (blocks of warps / splits 16-row tiles, passes of NT * 8 batch rows).
// Warp w takes tile w % tiles_per_block and every splits-th chunk from
// w / tiles_per_block.  Shared memory holds the pass's x rows for one slab of
// `slab` inputs: [inputs | 16 bytes of pad] per row; the non-gated form with
// one n-tile stages nothing and reads x with the weights (kDirectX).
template <int NT, bool Gated>
__global__ void __launch_bounds__(NT == 1 ? kMaxWarps * 32 : kWarps * 32,
                                  NT == 1 || Gated ? 1 : 2)
    q8_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, void* __restrict__ out, int B, int O, int K,
                  int splits, int slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMats = Gated ? 2 : 1;  // M operands a warp reads: gate and up, or down
  constexpr bool kDirectX = !Gated && NT == 1;  // x read from global memory, not staged
  const int warps = blockDim.x >> 5;
  const int tiles_per_block = warps / splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x * tiles_per_block + warp % tiles_per_block;
  const int split = warp / tiles_per_block;
  const int b0 = blockIdx.y * NT * 8;  // this pass's first batch row
  const int nb = min(NT * 8, B - b0);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int slab_chunks = slab / kChunk;
  const int n_slabs = kDirectX ? 1 : (n_chunks + slab_chunks - 1) / slab_chunks;
  const int row_bytes = 2 * slab + 16;
  const uint32_t x_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int o_lo = tile * 16 + g, o_hi = o_lo + 8;
  const bool tile_ok = tile * 16 < O;
  const bool ok_lo = o_lo < O, ok_hi = o_hi < O;
  const int8_t* w_lo[kMats];
  const int8_t* w_hi[kMats];
#pragma unroll
  for (int mt = 0; mt < kMats; ++mt) {
    w_lo[mt] = w + static_cast<size_t>(mt * O + (ok_lo ? o_lo : 0)) * K + 16 * t4;
    w_hi[mt] = w + static_cast<size_t>(mt * O + (ok_hi ? o_hi : 0)) * K + 16 * t4;
  }

  // Chunk c's 16 bytes of rows g and g + 8 of each M operand (zeros past the
  // row or past O): v[2 * mt] row g, v[2 * mt + 1] row g + 8.
  auto load_w = [&](int c, uint4 (&v)[2 * kMats]) {
#pragma unroll
    for (int i = 0; i < 2 * kMats; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks && c * kChunk + 16 * t4 < K) {
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt) {
        if (ok_lo) v[2 * mt] = ldg_stream256(w_lo[mt] + c * kChunk);
        if (ok_hi) v[2 * mt + 1] = ldg_stream256(w_hi[mt] + c * kChunk);
      }
    }
  };

  // kDirectX: the lane's 16 inputs of batch row g of chunk c (zeros past it).
  const __nv_bfloat16* x_row = x + static_cast<size_t>(b0 + min(g, nb - 1)) * K + 16 * t4;
  auto load_x = [&](int c, uint4 (&v)[2]) {
    v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
    if (kDirectX && g < nb && c < n_chunks && c * kChunk + 16 * t4 < K) {
      v[0] = ldg_stream(x_row + c * kChunk);
      v[1] = ldg_stream(x_row + c * kChunk + 8);
    }
  };

  float acc[kMats][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  int c = split;
  uint4 cur[2 * kMats], nxt[2 * kMats], xcur[2], xnxt[2];
  load_w(c, cur);
  load_w(c + splits, nxt);
  load_x(c, xcur);
  load_x(c + splits, xnxt);
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int c_begin = sl * slab_chunks;
    const int c_end = kDirectX ? n_chunks : min(n_chunks, c_begin + slab_chunks);
    if constexpr (!kDirectX) {
      const int pieces = (min(K, c_end * kChunk) - c_begin * kChunk) / 8;  // 16-byte units a row
      if (sl > 0) __syncthreads();  // every warp is done with the last slab
      for (int i = threadIdx.x; i < nb * pieces; i += blockDim.x) {
        const int r = i / pieces, p = i % pieces;
        cp_async16(x_s + r * row_bytes + p * 16,
                   x + static_cast<size_t>(b0 + r) * K + c_begin * kChunk + p * 8);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
      __syncthreads();
    }
    if (!tile_ok) continue;
    for (; c < c_end; c += splits) {
      uint4 fut[2 * kMats], xfut[2];
      load_w(c + 2 * splits, fut);
      load_x(c + 2 * splits, xfut);
      // Shared address of this lane's 16 inputs in batch row 0.
      const uint32_t x_at = x_s + ((c - c_begin) * kChunk + 16 * t4) * 2;
      const bool lane_ok = c * kChunk + 16 * t4 < K;
      uint32_t r0[kMats][4], r1[kMats][4];
#pragma unroll
      for (int mt = 0; mt < kMats; ++mt) {
        r0[mt][0] = cur[2 * mt].x, r0[mt][1] = cur[2 * mt].y;
        r0[mt][2] = cur[2 * mt].z, r0[mt][3] = cur[2 * mt].w;
        r1[mt][0] = cur[2 * mt + 1].x, r1[mt][1] = cur[2 * mt + 1].y;
        r1[mt][2] = cur[2 * mt + 1].z, r1[mt][3] = cur[2 * mt + 1].w;
      }
      if constexpr (NT == 1) {
        // One n-tile: x's fragments first, then word by word each operand's
        // dequant and its product, so that a product's latency hides under
        // the next dequant.
        uint32_t xw[8];
        if constexpr (kDirectX) {
          xw[0] = xcur[0].x, xw[1] = xcur[0].y, xw[2] = xcur[0].z, xw[3] = xcur[0].w;
          xw[4] = xcur[1].x, xw[5] = xcur[1].y, xw[6] = xcur[1].z, xw[7] = xcur[1].w;
        } else {
          x_frag(x_at + g * row_bytes, lane_ok && g < nb, xw);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int mt = 0; mt < kMats; ++mt) {
            uint32_t a[4];
            int8_frag(r0[mt][m], r1[mt][m], a);
            mma_bf16(acc[mt][0], a, xw[2 * m], xw[2 * m + 1]);
          }
      } else {
        uint32_t a[kMats][4][4];
#pragma unroll
        for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
          for (int m = 0; m < 4; ++m) int8_frag(r0[mt][m], r1[mt][m], a[mt][m]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = nt * 8 + g;
          uint32_t xw[8];
          x_frag(x_at + r * row_bytes, lane_ok && r < nb, xw);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int mt = 0; mt < kMats; ++mt)
              mma_bf16(acc[mt][nt], a[mt][m], xw[2 * m], xw[2 * m + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2 * kMats; ++i) {
        cur[i] = nxt[i];
        nxt[i] = fut[i];
      }
      xcur[0] = xnxt[0], xcur[1] = xnxt[1];
      xnxt[0] = xfut[0], xnxt[1] = xfut[1];
    }
  }

  // The K splits' partial sums, added in warp order (each operand's apart).
  if (splits > 1) {
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((threadIdx.x * NT + nt) * kMats + mt) * 4 + e] = acc[mt][nt][e];
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int mt = 0; mt < kMats; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f;
          for (int sp = 0; sp < splits; ++sp)
            sum += red[((((sp * tiles_per_block + warp) * 32 + lane) * NT + nt) * kMats + mt) * 4 +
                       e];
          acc[mt][nt][e] = sum;
        }
  }
  if (!tile_ok) return;
  // acc[mt][nt]: (row g, batch 2t / 2t+1) in 0 / 1, (row g + 8, ...) in 2 / 3.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = nt * 8 + 2 * t4 + (e & 1);
      const int o = e < 2 ? o_lo : o_hi;
      if (r >= nb || !(e < 2 ? ok_lo : ok_hi)) continue;
      const size_t at = static_cast<size_t>(b0 + r) * O + o;
      if constexpr (Gated) {
        const float gs = scale[o];
        const float us = scale[O + o];
        const float gv = acc[0][nt][e] * gs;
        const float uv = acc[1][nt][e] * us;
        const float sigmoid = 1.f / (1.f + expf(-gv));
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(gv * sigmoid * uv);
      } else {
        static_cast<float*>(out)[at] = __fmul_rn(acc[0][nt][e], scale[o]);
      }
    }
}

template <int NT, bool Gated>
int launch_pass(const void* x, const void* w, const void* scale, void* out, int B, int O, int K,
                cudaStream_t stream) {
  constexpr int kMats = Gated ? 2 : 1;
  static bool sized[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(q8_mma_kernel<NT, Gated>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) sized[dev] = true;
  }
  const int rows = std::min(B, NT * 8);
  const int passes = (B + NT * 8 - 1) / (NT * 8);
  const int k_chunks = (K + kChunk - 1) / kChunk * kChunk;
  const int slab =
      std::min(k_chunks, std::max(kChunk, kSlabBudget / (2 * rows) / kChunk * kChunk));
  const int tiles = (O + 15) / 16;
  const int sms = num_sms();
  int warps = kWarps, splits = 1;
  if (NT == 1 && tiles >= kMinWarps * sms) {
    // A warp a tile, whole K, in blocks of kMinWarps to kMaxWarps warps: the
    // size that puts the fewest tiles on the busiest SM (blocks go round the
    // SMs in turn), and of equals the largest, which stages x the fewest times.
    int best = 0;
    for (int wp = kMinWarps; wp <= kMaxWarps; ++wp) {
      const int busiest = (((tiles + wp - 1) / wp + sms - 1) / sms) * wp;
      if (best == 0 || busiest <= best) best = busiest, warps = wp;
    }
  } else {
    // The fewest K splits that give every SM two blocks (at most 8: a warp each).
    while (splits < kWarps &&
           (tiles + kWarps / splits - 1) / (kWarps / splits) * passes < 2 * sms)
      splits *= 2;
  }
  const int tiles_per_block = warps / splits;
  size_t smem = !Gated && NT == 1 ? 0 : static_cast<size_t>(rows) * (2 * slab + 16);
  if (splits > 1)
    smem = std::max(smem, static_cast<size_t>(warps) * 32 * NT * kMats * 4 * sizeof(float));
  const dim3 grid((tiles + tiles_per_block - 1) / tiles_per_block, passes);
  q8_mma_kernel<NT, Gated><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, B, O, K, splits, slab);
  return static_cast<int>(cudaGetLastError());
}

// One stage: one, two or four n-tiles a block by B.
template <bool Gated>
int launch(const void* x, const void* w, const void* scale, void* out, int B, int O, int K,
           cudaStream_t stream) {
  if (B <= 8) return launch_pass<1, Gated>(x, w, scale, out, B, O, K, stream);
  if (B <= 16) return launch_pass<2, Gated>(x, w, scale, out, B, O, K, stream);
  return launch_pass<4, Gated>(x, w, scale, out, B, O, K, stream);
}

}  // namespace

// x: [B, I] bf16, q: [O, I] int8, scale: [O] f32, y: [B, O] f32.  Every
// pointer 16-byte aligned, every array contiguous, I % 16 == 0 (the wrapper
// checks).  One launch on `stream`.
extern "C" int vt_q8_matmul(const void* x, const void* q, const void* scale, void* y, int B,
                            int O, int I, void* stream) {
  if (B < 1 || O < 1 || I < 16 || I % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, q, scale, y, B, O, I, static_cast<cudaStream_t>(stream));
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch<true>(x, gateup, gateup_scale, h, B, I, H, s);
  if (err != 0) return err;
  return launch<false>(h, down, down_scale, y, B, H, I, s);
}
