// Flash attention for Hopper (sm_90a), bf16 in and out, f32 statistics.
//
// Replaces vis_tpu/ops/flash_attention.py:_flash_kernel (launched by
// flash_attention).  Same contract: q [b, sq, h, d], k/v [b, skv, h, d],
// per-batch valid KV `lengths`, optional causal mask, online softmax with
// f32 m/l/acc, P rounded to bf16 before the P.V product, tiles past the
// length (and, causal, above the diagonal) skipped, and a row that never
// saw a valid key writes 0.  The TPU kernel sets a masked logit to NEG_INF
// = -0.7 * FLT_MAX; here a masked score is -inf and its probability exactly
// 0.  The two agree on every row: a row with a valid key gives that key
// weight 1 or more (its own maximum) and every masked key 0 either way, and
// a row with none writes 0 in both.
//
// What bounds it: 4 * s^2 * d * h flops (86 GFLOP at the vision tower's
// s=4096, h=16, d=80) against O(s * d * h) bytes, so it is tensor-core bound.
// The design follows FlashAttention-2 on mma.sync:
//
// - One CTA per (batch*head, 128-query tile), 8 warps of 16 query rows; at
//   s=4096, h=16 that is 512 CTAs, two resident on each of the 132 SMs.  The
//   wrapper takes sequence lengths that are multiples of 64, so the last
//   query tile may hold 64 rows: its upper four warps load and wait with
//   the rest but compute and store nothing.  A causal grid starts from the
//   last query tile, the one with the most keys.
// - Products are mma.sync.m16n8k16 bf16 -> f32.  d = 80 fits it natively
//   (5 k-steps for Q.K^T, 10 n-tiles of 8 for P.V), so nothing is padded in
//   the products.  wgmma would need d padded to 96 in shared memory or the
//   no-swizzle core-matrix layout, and a warpgroup's register budget for
//   S, P and O at once.  mma.sync is the simpler route, and on the H100 it
//   runs the tower's attention in about SDPA's time (PERF.md).
// - S and O live in registers: S's accumulator fragment is repacked in
//   place as the A operand of P.V, so S and P never touch shared memory.  Q
//   stays in shared memory and each k-step's fragment is read with ldmatrix
//   as it is needed: holding all of Q's fragments in registers (20 more a
//   thread at d = 80) spilled more and ran slower on the H100.
// - The softmax runs in registers: each thread holds two rows' worth of S
//   (rows g and g+8 of its warp's 16), the four threads of a quad share a
//   row's max through two shuffles, and the row sum stays a per-thread
//   partial until the end.  p = exp2(S * log2(e) * scale - m') is one FFMA
//   and one ex2.  The length and causal masks run only on the tiles that
//   need them (the ragged last tile, and tiles crossing a warp's diagonal).
// - K/V tiles of 64 keys are double-buffered with cp.async: the copy of tile
//   t+1 is issued right after the barrier that opens tile t, so it runs
//   under tile t's products; one barrier per tile.
// - Shared rows are padded from D to D + 8 bf16 (176 bytes at d = 80, 144 at
//   d = 64): the 8 row addresses of each ldmatrix 8x8 matrix then fall in 8
//   distinct 16-byte bank groups (160-byte rows would put two in each).  K
//   is read with ldmatrix, V with ldmatrix.trans for P.V's B operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 128;  // query rows per CTA
constexpr int kBlockK = 64;   // keys per KV tile
constexpr int kRowMultiple = 64;  // the wrapper's sequence-length multiple
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // padded shared row, in bf16
  static constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  static constexpr size_t kQ = size_t(kBlockQ) * kStride * sizeof(bf16);
  static constexpr size_t kKV = size_t(kBlockK) * kStride * sizeof(bf16);
  static constexpr size_t kTotal = kQ + 4 * kKV;  // Q, then K0, V0, K1, V1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// Two floats -> bf16x2 (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     const int* __restrict__ lengths, int sq, int skv, int heads,
                     float scale_log2, int causal) {
  using T = Tile<D>;
  constexpr int kS = T::kStride;
  constexpr int kKSteps = D / 16;  // Q.K^T k-steps
  constexpr int kDTiles = D / 8;   // P.V n-tiles
  constexpr int kKeyTiles = kBlockK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + T::kQ);  // stage st: K at 2st, V at 2st+1

  // Causal tiles grow with the query index: start the longest first, so
  // that the short ones fill the last wave.
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const size_t stride = static_cast<size_t>(heads) * D;  // between sequence rows
  const bf16* q_base = q + (static_cast<size_t>(b) * sq + q0) * stride + h * D;
  const bf16* k_base = k + static_cast<size_t>(b) * skv * stride + h * D;
  const bf16* v_base = v + static_cast<size_t>(b) * skv * stride + h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_rows = min(kBlockQ, sq - q0);

  const int valid_len = lengths[b];
  int kv_end = min(valid_len, skv);
  if (causal) kv_end = min(kv_end, q0 + q_rows);
  const int n_tiles = kv_end > 0 ? (kv_end + kBlockK - 1) / kBlockK : 0;

  auto load_kv = [&](int t, int st) {
    const size_t k0 = static_cast<size_t>(t) * kBlockK;
    bf16* k_dst = kv_s + (2 * st) * kBlockK * kS;
    bf16* v_dst = k_dst + kBlockK * kS;
    for (int i = tid; i < kBlockK * T::kChunks; i += kThreads) {
      const int r = i / T::kChunks, c = i % T::kChunks;
      const size_t src = (k0 + r) * stride + c * 8;
      cp_async16(smem_addr(k_dst + r * kS + c * 8), k_base + src);
      cp_async16(smem_addr(v_dst + r * kS + c * 8), v_base + src);
    }
  };

  for (int i = tid; i < q_rows * T::kChunks; i += kThreads) {
    const int r = i / T::kChunks, c = i % T::kChunks;
    cp_async16(smem_addr(q_s + r * kS + c * 8), q_base + r * stride + c * 8);
  }
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // This warp's 16 query rows; a warp past the last row only loads and waits.
  const int row0 = warp * 16;
  const bool active = row0 < q_rows;
  const int r_lo = q0 + row0 + g, r_hi = r_lo + 8;  // the two rows this thread holds
  const int warp_end = causal ? min(kv_end, q0 + row0 + 16) : kv_end;

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of the raw scores
  float l[2] = {0.f, 0.f};                      // this thread's share of the row sums
  const uint32_t q_at = smem_addr(q_s + (row0 + (lane & 15)) * kS + (lane >> 4) * 8);

  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t > 0) {
      cp_async_wait_all();  // tile t (issued one tile ago) has landed
      __syncthreads();      // ... for every thread, and tile t-1's stage is free
    }
    if (t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
    cp_async_commit();

    const int k0 = t * kBlockK;
    if (!active || k0 >= warp_end) continue;
    const bf16* k_s = kv_s + (2 * st) * kBlockK * kS;
    const bf16* v_s = k_s + kBlockK * kS;

    // S[16 rows, 64 keys] = Q . K^T
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_at = smem_addr(k_s + ((lane & 7) + ((lane >> 4) << 3)) * kS +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qf[4];
      ldmatrix_x4(qf, q_at + kk * 32);
#pragma unroll
      for (int j = 0; j < kKeyTiles; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_at + (j * 8 * kS + kk * 16) * 2);
        mma_bf16(s[j], qf, kb[0], kb[1]);
        mma_bf16(s[j + 1], qf, kb[2], kb[3]);
      }
    }

    // Masks, only on the tiles that cross the length or this warp's diagonal.
    const bool masked = k0 + kBlockK > valid_len || (causal && k0 + kBlockK - 1 > q0 + row0);
    if (masked) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + 2 * t4 + e;
          const bool in_len = col < valid_len;
          if (!(in_len && (!causal || col <= r_lo))) s[j][e] = -CUDART_INF_F;
          if (!(in_len && (!causal || col <= r_hi))) s[j][2 + e] = -CUDART_INF_F;
        }
      }
    }

    // Online softmax in registers.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i] * scale_log2;
      alpha[i] = m[i] == -CUDART_INF_F ? 0.f : fast_exp2((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale_log2, -base[i]));
        if (masked && s[j][e] == -CUDART_INF_F) p = 0.f;
        s[j][e] = p;
        rs[i] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O[16 rows, D] += P . V, P straight from S's registers as bf16.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int n = 0; n < kDTiles; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(v_s + key * kS + (n + (lane >> 4)) * 8));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // out = acc / l; l == 0 (no valid key) gives 0, as on the TPU.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (!active) return;
  const float inv_lo = l[0] == 0.f ? 1.f : 1.f / l[0];
  const float inv_hi = l[1] == 0.f ? 1.f : 1.f / l[1];
  bf16* o_lo = out + (static_cast<size_t>(b) * sq + r_lo) * stride + h * D + 2 * t4;
  bf16* o_hi = o_lo + 8 * stride;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    *reinterpret_cast<uint32_t*>(o_lo + n * 8) = pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(o_hi + n * 8) = pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const void* lengths,
           int batch, int sq, int skv, int heads, float sm_scale, int causal,
           cudaStream_t stream) {
  const size_t smem = Tile<D>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<const int*>(lengths), sq, skv, heads,
      sm_scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [batch, sq, heads, d] bf16; k/v: [batch, skv, heads, d] bf16;
// lengths: [batch] int32 on the device.  sq and skv are multiples of 64, d
// is 64 or 80, sm_scale >= 0 (the wrapper folds a negative scale into q),
// and every pointer is 16-byte aligned (the wrapper checks).
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  const void* lengths, int batch, int sq, int skv, int heads,
                                  int d, float sm_scale, int causal, void* stream) {
  if (batch < 1 || sq < kRowMultiple || sq % kRowMultiple || skv % kBlockK || heads < 1 ||
      !(sm_scale >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, lengths, batch, sq, skv, heads, sm_scale, causal, s);
    case 80:
      return launch<80>(q, k, v, out, lengths, batch, sq, skv, heads, sm_scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
