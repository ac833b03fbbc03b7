// One 64-row query tile of flash-attention forward on Hopper (sm_90a):
// the device body shared by the kernels of flash_attention.cu (BHSD and
// packed [b, s, n*d] addressing; base 2 or base e, block_k 64 or 128).
//
// Design (simple first): a block of 4 warps owns one 64-row q tile of one
// (batch, head) and loops over kBlockK-row K/V tiles staged in shared
// memory; each warp owns 16 q rows. Q.K^T and P.V run on the tensor cores
// through WMMA 16x16x16 bf16 fragments with fp32 accumulation. The score
// tile and the output accumulator live in shared memory, so the row-wise
// softmax and the rescale by alpha are plain per-row loops that need no
// fragment layout. No cp.async / TMA / wgmma yet: loads are not overlapped
// with compute, and that is what a later version changes first.
//
// Arithmetic (the TPU kernels'): in base 2, scale * log2(e) is folded into
// q once and q is rounded back to bf16, and the online softmax uses exp2;
// in base e, each score is scaled and the softmax uses exp. Running max,
// sum and accumulator are fp32, p is cast to bf16 before p.v, masked scores
// are -0.7 * FLT_MAX, and the causal mask is aligned top-left
// (q_idx >= k_idx; callers allow it only for q_len == kv_len).
//
// Rows are addressed as base + r * row_stride (in elements), so one body
// serves contiguous [BH, S, d] rows and packed rows of n*d elements.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

namespace fd_flash {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMask = -0.7f * FLT_MAX;

// Shared-memory layout of one block. Padded row strides (bf16 rows + 8,
// fp32 rows + 4) keep every 16-byte vector store and every 32-byte WMMA
// tile pointer aligned while shifting successive rows across banks.
template <int kHeadDim, int kBlockK>
struct Layout {
  static constexpr int kLdh = kHeadDim + 8;   // Q, K, V rows (bf16)
  static constexpr int kLdp = kBlockK + 8;    // P rows (bf16)
  static constexpr int kLds = kBlockK + 4;    // score rows (fp32)
  static constexpr int kLdo = kHeadDim + 4;   // accumulator rows (fp32)
  static constexpr int kQ = kBlockQ * kLdh;
  static constexpr int kKV = kBlockK * kLdh;
  static constexpr int kP = kBlockQ * kLdp;
  static constexpr int kS = kBlockQ * kLds;
  static constexpr int kO = kBlockQ * kLdo;
  static constexpr size_t kSmemBytes =
      (kQ + 2 * kKV + kP) * sizeof(bf16)
      + (kS + kO + 2 * kBlockQ) * sizeof(float);   // + running max m, sum l
};

// q/k/v/o point at row 0 of this (batch, head); q0 is the tile's first row.
// `scale` multiplies q before its bf16 rounding when kBase2 (the caller
// passes scale * log2 e), and each fp32 score otherwise.
template <int kHeadDim, int kBlockK, bool kBase2>
__device__ __forceinline__ void attend_tile(
    const bf16* __restrict__ qb, const bf16* __restrict__ kb,
    const bf16* __restrict__ vb, bf16* __restrict__ ob,
    int64_t q_row, int64_t k_row, int64_t v_row, int64_t o_row,
    int q0, int q_len, int kv_len, float scale, bool causal,
    unsigned char* smem) {
  using L = Layout<kHeadDim, kBlockK>;
  static_assert(kHeadDim % 16 == 0 && kBlockK % 32 == 0, "WMMA tiles");
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + L::kQ;
  bf16* s_v = s_k + L::kKV;
  bf16* s_p = s_v + L::kKV;
  float* s_s = reinterpret_cast<float*>(s_p + L::kP);
  float* s_o = s_s + L::kS;
  float* s_m = s_o + L::kO;
  float* s_l = s_m + kBlockQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kVecPerRow = kHeadDim / 8;   // 16-byte vectors per row

  // stage q (times scale * log2 e, rounded to bf16, in base 2)
  for (int idx = tid; idx < kBlockQ * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c8 = (idx % kVecPerRow) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < q_len)
      raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_row + c8);
    if (kBase2) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(s_q + r * L::kLdh + c8) = raw;
  }
  for (int idx = tid; idx < L::kO; idx += kThreads) s_o[idx] = 0.f;
  if (tid < kBlockQ) {
    s_m[tid] = kMask;
    s_l[tid] = 0.f;
  }

  int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) {
    // tiles wholly above the diagonal contribute nothing: skip them
    n_tiles = min(n_tiles, (q0 + kBlockQ + kBlockK - 1) / kBlockK);
  }
  const int wr = warp * 16;   // first row of this warp's 16-row slab

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // the previous tile's K/V are no longer read
    for (int idx = tid; idx < kBlockK * kVecPerRow; idx += kThreads) {
      const int r = idx / kVecPerRow;
      const int c8 = (idx % kVecPerRow) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (k0 + r < kv_len) {
        kr = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_row + c8);
        vr = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_row + c8);
      }
      *reinterpret_cast<uint4*>(s_k + r * L::kLdh + c8) = kr;
      *reinterpret_cast<uint4*>(s_v + r * L::kLdh + c8) = vr;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, s_q + wr * L::kLdh + kk * 16, L::kLdh);
        wmma::load_matrix_sync(b, s_k + n * 16 * L::kLdh + kk * 16, L::kLdh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_s + wr * L::kLds + n * 16, acc, L::kLds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, half a K tile each
    {
      constexpr int kHalfK = kBlockK / 2;
      constexpr int kHalfD = kHeadDim / 2;
      const int r = wr + lane / 2;
      const int c0 = (lane % 2) * kHalfK;
      const int qi = q0 + r;
      float* srow = s_s + r * L::kLds + c0;
      float mx = kMask;
      for (int c = 0; c < kHalfK; ++c) {
        const int kj = k0 + c0 + c;
        float s = kBase2 ? srow[c] : srow[c] * scale;
        if (kj >= kv_len || (causal && kj > qi)) s = kMask;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = kBase2 ? exp2f(m_prev - m_new) : expf(m_prev - m_new);
      float sum = 0.f;
      bf16* prow = s_p + r * L::kLdp + c0;
      for (int c = 0; c < kHalfK; ++c) {
        const float p = kBase2 ? exp2f(srow[c] - m_new) : expf(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* orow = s_o + r * L::kLdo + (lane % 2) * kHalfD;
      for (int c = 0; c < kHalfD; ++c) orow[c] *= alpha;
      __syncwarp();   // both lanes of a row have read s_m[r]
      if (lane % 2 == 0) {
        s_m[r] = m_new;
        s_l[r] = alpha * s_l[r] + sum;
      }
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, s_o + wr * L::kLdo + n * 16, L::kLdo,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, s_p + wr * L::kLdp + kk * 16, L::kLdp);
        wmma::load_matrix_sync(b, s_v + kk * 16 * L::kLdh + n * 16, L::kLdh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_o + wr * L::kLdo + n * 16, acc, L::kLdo,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // o = acc / l, this warp's 16 rows
  for (int idx = lane; idx < 16 * kVecPerRow; idx += 32) {
    const int r = wr + idx / kVecPerRow;
    const int c8 = (idx % kVecPerRow) * 8;
    if (q0 + r >= q_len) continue;
    const float l = s_l[r];
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(s_o[r * L::kLdo + c8 + j] / l);
    *reinterpret_cast<uint4*>(ob + (q0 + r) * o_row + c8) = raw;
  }
}

// Opt in to the tile's dynamic shared memory (above the 48 KB default).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fd_flash
