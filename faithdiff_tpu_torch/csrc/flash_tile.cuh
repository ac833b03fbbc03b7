// Flash-attention forward over 128-row query blocks on Hopper (sm_90a):
// the device body shared by every kernel of flash_attention.cu (contiguous
// [B, H, S, d] and packed [b, s, n*d] operands; base 2 or base e; K/V tile
// depth 64 or 128; causal or not). It replaces the bodies of the TPU
// kernels faithdiff_tpu/ops/attention.py::_flash_kernel and
// ::_flash_kernel_bsnd and of scripts/bench_attention_variants.py::kernel.
//
// What bounds it on the card: operations (about 1,000 flops per byte of
// q/k/v/o at S = 4096, d = 64, against a ridge near 295), so the design
// keeps the tensor cores fed and everything else out of their way:
//
// - Registers. S = Q.K^T is a warpgroup matrix multiply (wgmma m64nNk16,
//   bf16 -> fp32) whose operands are read from shared memory through
//   descriptors and whose result stays in the warpgroup's accumulator
//   registers. The online softmax runs on that register layout (a thread
//   holds pieces of two rows; a row's max and sum finish with two shuffles
//   inside its quad), the running max, sum and the output accumulator live
//   in registers for the whole K/V loop, and P is packed to bf16 in
//   registers and fed to the second wgmma, O += P.V, as its register
//   operand, with V read from shared memory as the MN-major operand. No
//   score, probability or accumulator touches shared memory; O goes there
//   once per q block, to leave as 128-byte rows through a TMA store.
// - The ring. A block is two consumer warpgroups (64 q rows each) and a
//   producer warpgroup of which one thread works. The producer fills a ring
//   of kStages K/V tiles with TMA tensor-map loads (128-byte swizzle, the
//   layout the wgmma descriptors name); a stage's arrival is counted in
//   bytes on its `full` mbarrier, and each consumer warp arrives on its
//   `empty` mbarrier after waiting for the wgmma that read it. The producer
//   gives most of its registers to the consumers (setmaxnreg). Loads of the
//   tiles ahead overlap the multiplies and the softmax of the current one.
// - Softmax beside the tensor cores. A warpgroup issues tile t's Q.K^T, then
//   tile t-1's P.V, and runs tile t's softmax while that P.V is still in
//   flight (two wgmma groups, wait for the older one first); the accumulator
//   is rescaled once the P.V has landed. The two warpgroups run unsynchronised,
//   so one's multiplies also fill the other's softmax. A stage is released
//   after its P.V, so the ring needs at least two stages.
// - Persistent blocks. A thread block walks several q blocks: the ring runs
//   on across them and, where shared memory holds two Q tiles (d = 64), the
//   next Q arrives during the current q block, so the output store of one
//   overlaps the first multiplies of the next.
// - TMA rather than cp.async: a tensor map with the head and the batch as
//   their own dimensions serves both layouts with one body, zero-fills rows
//   past the end of a sequence (their scores are still masked), clips the
//   output store to q_len, and costs the consumers no address arithmetic.
//
// Also here: the host side of the operands' 4-D TMA tensor maps
// (`Geometry`, `make_map`, bf16 or fp32), shared with flash_attention_wide.cu
// and flash_attention_f32.cu, whose kernels reuse the softmax, ring and
// packing helpers below, and the split merge both of those launch
// (`flash_wide_merge_kernel`, one template over the output type).
//
// Arithmetic (the TPU kernels'): in base 2, scale * log2(e) is folded into
// q once (the block rescales its Q tile in shared memory) and q is rounded
// back to bf16, and the online softmax uses exp2; in base e, each fp32 score
// is scaled and the softmax uses exp. Running max, sum and accumulator are
// fp32, p is cast to bf16 before p.v while its fp32 value enters the sum,
// masked scores are -0.7 * FLT_MAX, and the causal mask is aligned top-left
// (q_idx >= k_idx; callers allow it only for q_len == kv_len).
#pragma once

#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace fd_flash {

using bf16 = __nv_bfloat16;
using namespace fd_hopper;

constexpr int kConsumerGroups = 2;                 // warpgroups that multiply
constexpr int kGroupRows = 64;                     // q rows of one warpgroup
constexpr int kBlockQ = kConsumerGroups * kGroupRows;
constexpr int kThreads = (kConsumerGroups + 1) * 128;
constexpr int kPanelCols = 64;                     // 128 bytes: the swizzle's row
constexpr int kPanelRowBytes = kPanelCols * 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;                 // 2 * 232 + 40 = 504 = 3 * 168
constexpr float kMask = -0.7f * FLT_MAX;

// Shared memory of one block, from a 1024-byte aligned base: kQBuffers Q
// tiles (each later its own O) as [group][panel][64 rows][64 cols], then
// kStages K tiles and kStages V tiles as [panel][kBlockK rows][64 cols],
// every panel in the 128-byte swizzle, then the mbarriers (full and empty
// per Q buffer and per stage).
template <int kHeadDim, int kBlockK, int kStages, int kQBuffers>
struct Layout {
  static constexpr int kPanels = kHeadDim / kPanelCols;
  static constexpr int kQPanelBytes = kGroupRows * kPanelRowBytes;
  static constexpr int kQGroupBytes = kPanels * kQPanelBytes;
  static constexpr int kQBytes = kConsumerGroups * kQGroupBytes;
  static constexpr int kKVPanelBytes = kBlockK * kPanelRowBytes;
  static constexpr int kTileBytes = kPanels * kKVPanelBytes;
  static constexpr int kKOff = kQBuffers * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  // + 1024: the dynamic shared memory base is only known to be 16-byte aligned
  static constexpr size_t kSmemBytes =
      kBarOff + 2 * (kQBuffers + kStages) * 8 + 1024;
};

// K/V tiles a q block starting at row q0 visits: all of them, or under the
// causal mask those that hold a column <= the block's last row.
template <int kBlockK, bool kCausal>
__device__ __forceinline__ int kv_tiles(int q0, int kv_len) {
  const int all = (kv_len + kBlockK - 1) / kBlockK;
  return kCausal ? min(all, (q0 + kBlockQ + kBlockK - 1) / kBlockK) : all;
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kBlockK>
__device__ __forceinline__ void wgmma_qk(float (&s)[kBlockK / 2], uint64_t desc_q,
                                         uint64_t desc_k, int accumulate) {
  static_assert(kBlockK == 64 || kBlockK == 128, "K/V tile depth");
  if constexpr (kBlockK == 64) wgmma_ss_n64(s, desc_q, desc_k, accumulate);
  else wgmma_ss_n128(s, desc_q, desc_k, accumulate);
}

template <int kHeadDim>
__device__ __forceinline__ void wgmma_pv(float (&o)[kHeadDim / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_v) {
  static_assert(kHeadDim == 64 || kHeadDim == 128, "head dim");
  if constexpr (kHeadDim == 64) wgmma_rs_n64(o, a0, a1, a2, a3, desc_v);
  else wgmma_rs_n128(o, a0, a1, a2, a3, desc_v);
}

// The online-softmax state of the two rows a thread holds pieces of: their
// running max, this thread's share of their running sums, and where they
// are. A score fragment s[4j + e] belongs to row0 (e = 0, 1) or row1
// (e = 2, 3), column k0 + 8j + 2 * quad + e % 2.
struct SoftmaxRows {
  float m0, m1, l0, l1;
  int row0, row1, quad;

  // Scores of the tile at k0 in, unnormalised probabilities out (fp32, in
  // place); alpha0 / alpha1 are what the rows' earlier sums and
  // accumulators are to be multiplied by.
  template <int kBlockK, bool kBase2, bool kCausal>
  __device__ __forceinline__ void update(float (&s)[kBlockK / 2], int k0,
                                         int kv_len, int group_q0, float scale,
                                         float& alpha0, float& alpha1) {
    constexpr float kLog2e = 1.4426950408889634f;
    if (!kBase2) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) s[i] *= scale;
    }
    // only the last tile of a ragged kv_len and the tiles on the diagonal
    // hold masked columns
    if (k0 + kBlockK > kv_len || (kCausal && k0 + kBlockK - 1 > group_q0)) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * quad + (i % 2);
        const int row = (i % 4 < 2) ? row0 : row1;
        if (col >= kv_len || (kCausal && col > row)) s[i] = kMask;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      if (i % 4 < 2) mx0 = fmaxf(mx0, s[i]);
      else mx1 = fmaxf(mx1, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    alpha0 = exp2_fast(kBase2 ? m0 - mx0 : (m0 - mx0) * kLog2e);
    alpha1 = exp2_fast(kBase2 ? m1 - mx1 : (m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      const float x = s[i] - ((i % 4 < 2) ? m0 : m1);
      s[i] = exp2_fast(kBase2 ? x : x * kLog2e);
      if (i % 4 < 2) sum0 += s[i];
      else sum1 += s[i];
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
  }
};

template <int kHeadDim>
__device__ __forceinline__ void rescale(float (&o)[kHeadDim / 2], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int i = 0; i < kHeadDim / 2; ++i) o[i] *= (i % 4 < 2) ? alpha0 : alpha1;
}

// P as the register operand of P.V: k-step kk takes p[4kk .. 4kk+3], the
// tile's columns 16kk .. 16kk+15
template <int kBlockK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBlockK / 4],
                                       const float (&s)[kBlockK / 2]) {
#pragma unroll
  for (int i = 0; i < kBlockK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// s = Q.K^T over one K tile, issued and committed as one wgmma group
template <int kHeadDim, int kBlockK, typename L>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockK / 2], uint32_t q_smem,
                                         uint32_t k_smem) {
  fence_registers(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;           // 16 bf16 along the row
    wgmma_qk<kBlockK>(
        s, smem_desc(q_smem + (kk / 4) * L::kQPanelBytes + col, 16, 1024),
        smem_desc(k_smem + (kk / 4) * L::kKVPanelBytes + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o += P.V over one V tile, issued and committed as one wgmma group
template <int kHeadDim, int kBlockK, typename L>
__device__ __forceinline__ void issue_pv(float (&o)[kHeadDim / 2],
                                         uint32_t (&p)[kBlockK / 4],
                                         uint32_t v_smem) {
  fence_registers(o);
  fence_registers(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_pv<kHeadDim>(
        o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
        smem_desc(v_smem + kk * 16 * kPanelRowBytes, L::kKVPanelBytes, 1024));
  wgmma_commit();
}

// A position in the K/V ring: the stage and the parity of its current use.
template <int kStages>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ RingPos next() const {
    RingPos n = *this;
    if (++n.stage == kStages) {
      n.stage = 0;
      n.phase ^= 1;
    }
    return n;
  }
};

// The round-th q block of this thread block. A grid of G blocks deals the
// work items (a q block of one plane) in G-wide rounds: block c takes items
// c, 2G-1-c, 2G+c, ... (every other round reversed, so that under the causal
// mask, where the items are dealt longest first, no block collects every
// round's longest). With one block an item there is only round 0. Non-causal
// items run q block fastest, so the blocks in flight share a few planes' K/V
// in L2. False once the items are used up.
template <bool kCausal>
__device__ __forceinline__ bool work_item(int round, int q_blocks, int planes,
                                          int& q_block, int& plane) {
  const int width = gridDim.x;
  const int slot = (round & 1) ? width - 1 - blockIdx.x : blockIdx.x;
  const int item = round * width + slot;
  if (item >= q_blocks * planes) return false;
  if (kCausal) {
    q_block = q_blocks - 1 - item / planes;
    plane = item % planes;
  } else {
    q_block = item % q_blocks;
    plane = item / q_blocks;
  }
  return true;
}

// The tensor maps are 4-D, (column in head, head, row, batch), with boxes
// of (64, 1, 64, 1) for q and o and (64, 1, kBlockK, 1) for k and v; plane =
// batch * heads + head. `scale` multiplies q before its bf16 rounding when
// kBase2 (the caller passes scale * log2 e), and each fp32 score otherwise.
// Every thread of the block calls this; nothing of the block runs after it.
// The block walks its q blocks (`work_item`) without returning: the K/V
// ring runs on from one q block into the next, and with kQBuffers = 2 the
// next Q tile is loaded while the current one is still multiplied, so a q
// block's epilogue overlaps the next one's loads. With kQBuffers = 1 the
// next Q has to wait for the output store, and the launch gives every work
// item its own block instead (flash_attention.cu).
template <int kHeadDim, int kBlockK, int kStages, int kQBuffers, bool kBase2,
          bool kCausal>
__device__ __forceinline__ void attend_blocks(
    const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_o, int heads, int q_blocks, int planes, int kv_len,
    float scale, unsigned char* smem_raw) {
  using L = Layout<kHeadDim, kBlockK, kStages, kQBuffers>;
  static_assert(kStages >= 2, "a group holds tile t's K and tile t-1's V at once");
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - smem_u32(smem_raw));
  const uint32_t bar_q_full = s_base + L::kBarOff;
  const uint32_t bar_q_empty = bar_q_full + 8 * kQBuffers;
  const uint32_t bar_full = bar_q_empty + 8 * kQBuffers;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int group = tid / 128;

  if (tid == 0) {
    for (int b = 0; b < kQBuffers; ++b) {
      mbar_init(bar_q_full + 8 * b, 1);
      mbar_init(bar_q_empty + 8 * b, kConsumerGroups);   // one arrival a group
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerGroups * 4);   // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  int q_block, plane;
  if (group == kConsumerGroups) {
    // ---- producer: one thread keeps the Q buffers and the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumerGroups * 128) {
      RingPos<kStages> ring;
      for (int round = 0; work_item<kCausal>(round, q_blocks, planes, q_block, plane);
           ++round) {
        const int head = plane % heads, batch = plane / heads;
        const int q0 = q_block * kBlockQ;
        const int qb = round % kQBuffers;
        const uint32_t q_phase = (round / kQBuffers) & 1;
        mbar_wait(bar_q_empty + 8 * qb, q_phase ^ 1);   // passes on a fresh buffer
        mbar_expect_tx(bar_q_full + 8 * qb, L::kQBytes);
        for (int g = 0; g < kConsumerGroups; ++g)
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(s_base + qb * L::kQBytes + g * L::kQGroupBytes
                            + p * L::kQPanelBytes,
                        map_q, bar_q_full + 8 * qb, p * kPanelCols, head,
                        q0 + g * kGroupRows, batch);
        const int n_tiles = kv_tiles<kBlockK, kCausal>(q0, kv_len);
        for (int t = 0; t < n_tiles; ++t) {
          mbar_wait(bar_empty + 8 * ring.stage, ring.phase ^ 1);   // or a fresh ring
          const uint32_t full = bar_full + 8 * ring.stage;
          mbar_expect_tx(full, 2 * L::kTileBytes);
          for (int p = 0; p < L::kPanels; ++p) {
            const uint32_t off = ring.stage * L::kTileBytes + p * L::kKVPanelBytes;
            tma_load_4d(s_base + L::kKOff + off, map_k, full, p * kPanelCols, head,
                        t * kBlockK, batch);
            tma_load_4d(s_base + L::kVOff + off, map_v, full, p * kPanelCols, head,
                        t * kBlockK, batch);
          }
          ring = ring.next();
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ----
    setmaxnreg_inc<kConsumerRegs>();
    const int gtid = tid % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int row_in_group = (gtid / 32) * 16 + lane / 4;   // and + 8
    const uint32_t k_ring = s_base + L::kKOff, v_ring = s_base + L::kVOff;
    RingPos<kStages> ring;

    for (int round = 0; work_item<kCausal>(round, q_blocks, planes, q_block, plane);
         ++round) {
      const int head = plane % heads, batch = plane / heads;
      const int q0 = q_block * kBlockQ;
      const int n_tiles = kv_tiles<kBlockK, kCausal>(q0, kv_len);
      const int qb = round % kQBuffers;
      const int group_q0 = q0 + group * kGroupRows;
      const int q_off = qb * L::kQBytes + group * L::kQGroupBytes;
      const uint32_t q_smem = s_base + q_off;

      mbar_wait(bar_q_full + 8 * qb, (round / kQBuffers) & 1);
      if (kBase2) {
        // fold the scale into this group's q rows, rounded back to bf16
        uint4* qv = reinterpret_cast<uint4*>(smem + q_off);
        for (int i = gtid; i < L::kQGroupBytes / 16; i += 128) {
          uint4 raw = qv[i];
          bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
          qv[i] = raw;
        }
        fence_proxy_async_shared();
        named_barrier_sync(1 + group, 128);
      }

      float o[kHeadDim / 2];
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) o[i] = 0.f;
      SoftmaxRows rows{kMask, kMask, 0.f, 0.f, group_q0 + row_in_group,
                       group_q0 + row_in_group + 8, quad};
      // under the causal mask the tiles wholly above this group's rows add
      // nothing: the group multiplies the first `live` tiles only
      const int live =
          kCausal ? min(n_tiles, (group_q0 + kGroupRows + kBlockK - 1) / kBlockK)
                  : n_tiles;
      float s[kBlockK / 2];
      uint32_t p[kBlockK / 4];
      float alpha0, alpha1;

      // tile t's Q.K^T is issued before tile t-1's P.V, and tile t's softmax
      // runs while that P.V is still on the tensor cores
      RingPos<kStages> cur = ring;
      mbar_wait(bar_full + 8 * cur.stage, cur.phase);
      issue_qk<kHeadDim, kBlockK, L>(s, q_smem, k_ring + cur.stage * L::kTileBytes);
      wgmma_wait<0>();
      fence_registers(s);
      rows.template update<kBlockK, kBase2, kCausal>(s, 0, kv_len, group_q0, scale,
                                                     alpha0, alpha1);
      pack_p<kBlockK>(p, s);
      for (int t = 1; t < live; ++t) {
        const RingPos<kStages> nxt = cur.next();
        mbar_wait(bar_full + 8 * nxt.stage, nxt.phase);
        issue_qk<kHeadDim, kBlockK, L>(s, q_smem,
                                       k_ring + nxt.stage * L::kTileBytes);
        issue_pv<kHeadDim, kBlockK, L>(o, p, v_ring + cur.stage * L::kTileBytes);
        wgmma_wait<1>();
        fence_registers(s);
        rows.template update<kBlockK, kBase2, kCausal>(s, t * kBlockK, kv_len,
                                                       group_q0, scale, alpha0,
                                                       alpha1);
        wgmma_wait<0>();
        fence_registers(o);
        fence_registers(p);
        if (lane == 0) mbar_arrive(bar_empty + 8 * cur.stage);
        rescale<kHeadDim>(o, alpha0, alpha1);
        pack_p<kBlockK>(p, s);
        cur = nxt;
      }
      issue_pv<kHeadDim, kBlockK, L>(o, p, v_ring + cur.stage * L::kTileBytes);
      wgmma_wait<0>();
      fence_registers(o);
      fence_registers(p);
      if (lane == 0) mbar_arrive(bar_empty + 8 * cur.stage);
      // the tiles this group skips still pass through the ring
      for (int t = live; t < n_tiles; ++t) {
        cur = cur.next();
        mbar_wait(bar_full + 8 * cur.stage, cur.phase);
        if (lane == 0) mbar_arrive(bar_empty + 8 * cur.stage);
      }
      ring = cur.next();

      // o = acc / l, through this group's rows of the Q buffer (no wgmma
      // reads them any more) and out as one TMA store per panel, which
      // drops the rows past q_len
      float l0 = rows.l0, l1 = rows.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      named_barrier_sync(1 + group, 128);
      unsigned char* o_smem = smem + q_off;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        // column 8j + 2 * quad of the head: panel j / 8, 16-byte chunk j % 8,
        // swizzled with the row's low three bits
        unsigned char* panel = o_smem + (j / 8) * L::kQPanelBytes + quad * 4;
        const int r0 = row_in_group, r1 = row_in_group + 8;
        *reinterpret_cast<uint32_t*>(panel + r0 * kPanelRowBytes
                                     + (((j % 8) ^ (r0 % 8)) * 16)) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(panel + r1 * kPanelRowBytes
                                     + (((j % 8) ^ (r1 % 8)) * 16)) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      fence_proxy_async_shared();
      named_barrier_sync(1 + group, 128);
      if (gtid == 0) {
        for (int pn = 0; pn < L::kPanels; ++pn)
          tma_store_4d(map_o, q_smem + pn * L::kQPanelBytes, pn * kPanelCols, head,
                       group_q0, batch);
        tma_store_commit_and_wait();
        mbar_arrive(bar_q_empty + 8 * qb);   // the buffer may take another Q
      }
    }
  }
}

// One operand as the wrapper describes it: dims (column in head, head, row,
// batch), the byte strides of the last three, and the box of one TMA tile.
struct Geometry {
  uint64_t dims[4];
  uint64_t strides[3];
  uint64_t box[4];
};

// A tensor map with the 128-byte swizzle, bf16 (boxes of 64 columns) or
// fp32 (boxes of 32 columns: 128 bytes either way); rows past an extent
// read as zeros and are not written.
inline cudaError_t make_map(CUtensorMap* map, const void* base, const Geometry& g,
                            int box_rows,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const fd_hopper::EncodeTiled encode = fd_hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const uint64_t cols = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 32 : kPanelCols;
  if (g.box[0] != cols || g.box[1] != 1
      || g.box[2] != static_cast<uint64_t>(box_rows) || g.box[3] != 1)
    return cudaErrorInvalidValue;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.box[0]), 1,
                             static_cast<cuuint32_t>(g.box[2]), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype, 4, const_cast<void*>(base), g.dims, g.strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ void store4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// The split merge of the flash kernels that split a q block's K/V tiles
// over blocks (flash_attention_wide.cu in bf16, flash_attention_f32.cu in
// fp32): o[row] = sum_s 2^(m_s - M) o_s / sum_s 2^(m_s - M) l_s with M =
// max_s m_s, in split order (the same bits on every call); one warp a row,
// a lane's columns in 16-byte pieces 128 columns apart, the loads of a few
// splits in flight at once. part_o [splits, planes, rows_pad, kHeadDim] and
// part_ml [splits, planes, rows_pad, 2] as the split kernel wrote them; o
// (TOut) at element strides (batch, head, row), unit columns.
template <int kHeadDim, typename TOut>
__global__ void __launch_bounds__(256)
flash_wide_merge_kernel(const float* __restrict__ part_o,
                        const float* __restrict__ part_ml, TOut* __restrict__ o,
                        long long o_batch, long long o_head, long long o_row,
                        int heads, int planes, int q_len, int rows_pad, int splits) {
  constexpr int kPieces = (kHeadDim / 4 + 31) / 32;   // 4-column pieces a lane
  const long long warp = blockIdx.x * 8LL + threadIdx.x / 32;
  if (warp >= static_cast<long long>(planes) * q_len) return;
  const int plane = static_cast<int>(warp / q_len), row = static_cast<int>(warp % q_len);
  const int lane = threadIdx.x % 32;
  const size_t split_rows = static_cast<size_t>(planes) * rows_pad;
  const size_t r = static_cast<size_t>(plane) * rows_pad + row;
  float big = kMask;
  for (int s = 0; s < splits; ++s) big = fmaxf(big, part_ml[2 * (s * split_rows + r)]);
  float total = 0.f;
  float4 acc[kPieces];
#pragma unroll
  for (int c = 0; c < kPieces; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * (s * split_rows + r));
    const float wgt = exp2f(ml.x - big);
    total += wgt * ml.y;
    const float* src = part_o + (s * split_rows + r) * kHeadDim;
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int col = 4 * (lane + 32 * c);
      if (col < kHeadDim) {
        const float4 x = *reinterpret_cast<const float4*>(src + col);
        acc[c].x += wgt * x.x;
        acc[c].y += wgt * x.y;
        acc[c].z += wgt * x.z;
        acc[c].w += wgt * x.w;
      }
    }
  }
  const float inv = 1.f / total;
  TOut* out = o + (plane / heads) * o_batch + (plane % heads) * o_head + row * o_row;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int col = 4 * (lane + 32 * c);
    if (col < kHeadDim)
      store4(out + col, make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv,
                                    acc[c].w * inv));
  }
}

// The merge's launch: one warp a row of every plane. Returns a cudaError_t.
template <int kHeadDim, typename TOut>
cudaError_t launch_merge(const float* part_o, const float* part_ml, TOut* o,
                         const long long* o_strides, int heads, int planes, int q_len,
                         int rows_pad, int splits, cudaStream_t stream) {
  if (heads < 1 || planes < heads || q_len < 1 || rows_pad < q_len || splits < 1)
    return cudaErrorInvalidValue;
  const long long blocks = (static_cast<long long>(planes) * q_len + 7) / 8;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  flash_wide_merge_kernel<kHeadDim, TOut><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part_o, part_ml, o, o_strides[0], o_strides[1], o_strides[2], heads, planes, q_len,
      rows_pad, splits);
  return cudaGetLastError();
}

}  // namespace fd_flash
