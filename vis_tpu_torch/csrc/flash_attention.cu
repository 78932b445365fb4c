// Flash attention for Hopper (sm_90a), bf16 in and out, f32 statistics.
//
// Replaces vis_tpu/ops/flash_attention.py:_flash_kernel (launched by
// flash_attention).  Same contract: q [b, sq, h, d], k/v [b, skv, h, d],
// per-batch valid KV `lengths`, optional causal mask, masked logits set to
// NEG_INF = -0.7 * FLT_MAX, online softmax with f32 m/l/acc, and a row that
// never saw a valid key writes 0.
//
// What bounds it: 4 * s^2 * d * h flops (86 GFLOP at the vision tower's
// s=4096, h=16, d=80) against O(s * d * h) bytes, so it is tensor-core bound.
// The design keeps the [s, s] score matrix out of device memory: one CTA per
// (batch*head, 64-query tile) walks the KV tiles in a loop (the TPU's
// sequential KV grid axis) and stops at the row's length and, when causal,
// at the diagonal (the TPU kernel's tile skip).  Products run on the tensor
// cores through nvcuda::wmma bf16 16x16x16 tiles with f32 accumulation; d=80
// is 5 k-steps of 16, so nothing is padded.  Each of the 4 warps owns 16
// query rows end to end (scores, softmax, P.V), so warps only meet at the
// K/V tile loads.  A simple first version: no TMA, no wgmma, no double
// buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -0.7f * FLT_MAX;

template <int D>
struct Smem {
  static constexpr size_t q = kBlockQ * D * sizeof(bf16);
  static constexpr size_t k = kBlockK * D * sizeof(bf16);
  static constexpr size_t v = kBlockK * D * sizeof(bf16);
  static constexpr size_t s = kBlockQ * kBlockK * sizeof(float);
  static constexpr size_t p = kBlockQ * kBlockK * sizeof(bf16);
  static constexpr size_t o = kBlockQ * D * sizeof(float);
  static constexpr size_t stats = 3 * kBlockQ * sizeof(float);  // m, l, alpha
  static constexpr size_t total = q + k + v + s + p + o + stats;
};

// Copy `rows` rows of D bf16 (row stride `stride` elements) into shared memory.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int rows) {
  constexpr int kVecPerRow = D * sizeof(bf16) / 16;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    reinterpret_cast<uint4*>(dst + r * D)[c] =
        reinterpret_cast<const uint4*>(src + r * stride)[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     const int* __restrict__ lengths, int sq, int skv,
                     int heads, float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<D>;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::q + L::k);
  float* s_s = reinterpret_cast<float*>(smem + L::q + L::k + L::v);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L::q + L::k + L::v + L::s);
  float* o_s =
      reinterpret_cast<float*>(smem + L::q + L::k + L::v + L::s + L::p);
  float* m_s = o_s + kBlockQ * D;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const size_t stride = static_cast<size_t>(heads) * D;  // between seq rows
  const bf16* q_base = q + (static_cast<size_t>(b) * sq + q0) * stride + h * D;
  const bf16* k_base = k + static_cast<size_t>(b) * skv * stride + h * D;
  const bf16* v_base = v + static_cast<size_t>(b) * skv * stride + h * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;  // this warp's first row inside the tile

  load_tile<D>(q_s, q_base, stride, kBlockQ);
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) o_s[i] = 0.f;
  if (threadIdx.x < kBlockQ) {
    m_s[threadIdx.x] = -CUDART_INF_F;
    l_s[threadIdx.x] = 0.f;
  }

  int kv_end = min(lengths[b], skv);
  if (causal) kv_end = min(kv_end, q0 + kBlockQ);
  const int n_tiles = kv_end > 0 ? (kv_end + kBlockK - 1) / kBlockK : 0;
  const int valid_len = lengths[b];

  // Softmax lanes: two per row, each over half of the tile's columns.
  const int srow = row0 + (lane >> 1);
  const int shalf = lane & 1;
  constexpr int kCols = kBlockK / 2;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile<D>(k_s, k_base + static_cast<size_t>(k0) * stride, stride,
                 kBlockK);
    load_tile<D>(v_s, v_base + static_cast<size_t>(k0) * stride, stride,
                 kBlockK);
    __syncthreads();

    // S[16 rows, 64 cols] = Q_w . K^T for this warp's rows.
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, q_s + row0 * D + kk * 16, D);
        wmma::load_matrix_sync(bt, k_s + n * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(s_s + row0 * kBlockK + n * 16, acc, kBlockK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile, f32.
    {
      const int qrow = q0 + srow;
      float* srow_p = s_s + srow * kBlockK + shalf * kCols;
      float tile_max = -CUDART_INF_F;
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + shalf * kCols + c;
        float s = srow_p[c] * sm_scale;
        const bool ok = col < valid_len && (!causal || col <= qrow);
        s = ok ? s : kNegInf;
        srow_p[c] = s;
        tile_max = fmaxf(tile_max, s);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      const float m_prev = m_s[srow];
      const float m_next = fmaxf(m_prev, tile_max);
      const float alpha = expf(m_prev - m_next);
      float psum = 0.f;
      bf16* prow = p_s + srow * kBlockK + shalf * kCols;
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(srow_p[c] - m_next);
        psum += p;
        prow[c] = __float2bfloat16_rn(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      if (shalf == 0) {
        m_s[srow] = m_next;
        l_s[srow] = alpha * l_s[srow] + psum;
        a_s[srow] = alpha;
      }
      // Rescale this row's running output.
      float* orow = o_s + srow * D + shalf * (D / 2);
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O[16 rows, D] += P . V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + row0 * D + n * 16, D,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, p_s + row0 * kBlockK + kk * 16, kBlockK);
        wmma::load_matrix_sync(bv, v_s + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(o_s + row0 * D + n * 16, acc, D,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  // out = acc / l, with l == 0 (no valid key) giving 0 as on the TPU.
  bf16* o_base = out + (static_cast<size_t>(b) * sq + q0) * stride + h * D;
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float l = l_s[r];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    o_base[r * stride + c] = __float2bfloat16_rn(o_s[i] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* lengths, int batch, int sq, int skv, int heads,
           float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<D>::total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / kBlockQ, batch * heads);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<const int*>(lengths), sq, skv, heads, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [batch, sq, heads, d] bf16; k/v: [batch, skv, heads, d] bf16;
// lengths: [batch] int32 on the device.  sq and skv are multiples of 64;
// d is 64 or 80 (the wrapper checks).
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, const void* lengths, int batch,
                                  int sq, int skv, int heads, int d,
                                  float sm_scale, int causal, void* stream) {
  if (batch < 1 || sq % kBlockQ || skv % kBlockK || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, lengths, batch, sq, skv, heads,
                        sm_scale, causal, s);
    case 80:
      return launch<80>(q, k, v, out, lengths, batch, sq, skv, heads,
                        sm_scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
