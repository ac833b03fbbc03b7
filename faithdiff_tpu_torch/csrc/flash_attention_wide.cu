// Flash-attention forward for Hopper (sm_90a), bf16 in and out, at the wide
// head dims d = 192 ... 512 (multiples of 64), in both layouts the tensor
// maps describe: contiguous [B, H, S, d] planes and packed [b, s, n*d] rows
// (column slices of a fused projection included).
//
// Replaces the wide-d instantiations of:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl), which JAX's gate admits at any d % 64 == 0
//   while kv_len * d <= 512 Ki: the VAE mid-block's single-head d = 512
//   attention at a 32 x 32 latent ([B, 1, 1024, 512]), run by the denoise
//   encoder, the VAE encode and the VAE decode of a 256 x 256 restore;
// - faithdiff_tpu/ops/attention.py::_flash_kernel_bsnd (launched by
//   _flash_attention_bsnd_impl) at those head dims, non-causal.
//
// What it computes: o = softmax(q k^T * scale) v. Scores are fp32 products
// of the bf16 operands, scaled by scale * log2 e in fp32; an online softmax
// in base 2 over K/V tiles; p rounded to bf16 before p.v while its fp32
// value enters the sum; fp32 accumulation; o = acc / l. Columns past kv_len
// and, under `causal`, above the diagonal (top-left: col > row) score
// -0.7 * FLT_MAX, the TPU kernel's DEFAULT_MASK_VALUE.
//
// What bounds it on the card: operations (4 * BH * S^2 * d flops against
// 8 * BH * S * d bytes: ~2,000 flops a byte at S = 1024, d = 512), and at
// d > 256, where a block holds only 64 q rows, the K/V stream from L2
// (128 KB of K and V per 64-key tile for 8.4 Mflop at d = 512).
//
// The design, against the four limits of the first one (`mma.sync`, a
// 128-column output slice a block):
// 1. Scores once a block. A block is two consumer warpgroups and a
//    producer warpgroup. At d <= 256 it owns 128 q rows, 64 a consumer
//    warpgroup, each holding all d columns of its fp32 accumulator (d = 256:
//    128 registers a thread), as flash_tile.cuh's d = 64 / 128 blocks do.
//    At d > 256 the accumulator of 64 rows no longer fits one warpgroup, so
//    both share one 64-row q block and split the 64-column panels of d
//    between them (d = 320: 3 + 2; 448: 4 + 3; 512: 4 + 4). Each computes
//    q.k^T over its own panels only, the two fp32 64 x 64 halves meet in
//    shared memory (16 KB each), and both add them in the same order and
//    run the same softmax; each then multiplies P by its panels of V. The
//    scores are computed once, by halves, for all d output columns.
// 2. Short grids split K/V. `ops/attention.py::wide_plan` picks, from the
//    shape alone, how many blocks share a q block's K/V tiles (`splits`,
//    `tiles_per_split` each): as many as one wave of one block an SM holds,
//    while each split walks at least 2 tiles (one costs more in fixed
//    block time and merge traffic than it wins: PERF.md). [1, 1, 1024,
//    512] has 16 q blocks and runs 8 splits of 2 tiles. A split writes its
//    unnormalised fp32 partial output and its rows' max and sum to buffers
//    the wrapper allocates; flash_wide_merge_kernel (flash_tile.cuh, shared
//    with the fp32 kernel) then combines the splits in split order. No
//    atomics: a repeat gives the same bits.
// 3. Asynchronous copies. Q, K and V arrive by TMA tensor maps (128-byte
//    swizzle, 64-column panels) on mbarriers that count bytes: one producer
//    thread fills the K ring, another the V ring, so a tile's K loads while
//    the previous one's softmax and p.v run (K and V rings have their own
//    depth: as many 64-key stages as shared memory holds, from 1 + 1 at
//    d >= 448 to 3 + 3 at d = 192). V is read MN-major by the wgmma
//    descriptor: nothing is transposed.
// 4. wgmma for both products: q.k^T as SS m64n64k16 steps over the panels
//    a warpgroup owns, P.V as RS m64nNk16 with P in registers and N the
//    warpgroup's columns (128 ... 256). A warpgroup issues tile t's q.k^T
//    before tile t-1's P.V and runs tile t's exchange and softmax while that
//    P.V is on the tensor cores (flash_tile.cuh's order). The producer
//    warpgroup hands its registers to the consumers (setmaxnreg).
//
// Shared memory a block (WideLayout): Q, then at d > 256 the two score
// halves, then the K and V rings, then the mbarriers, from a 1024-byte
// aligned base: d = 192: 197,736 bytes; 256: 230,488; 320: 197,688; 384:
// 230,456; 448: 205,864; 512: 230,440 (one block an SM).
#include "flash_tile.cuh"

namespace {

using namespace fd_hopper;
using fd_flash::bf16;
using fd_flash::Geometry;
using fd_flash::kMask;
using fd_flash::kPanelCols;
using fd_flash::kPanelRowBytes;
using fd_flash::make_map;
using fd_flash::pack_bf16;
using fd_flash::RingPos;
using fd_flash::SoftmaxRows;

constexpr int kRows = 64;             // K/V rows a tile, q rows a warpgroup, TMA box rows
constexpr int kPanelBytes = kRows * kPanelRowBytes;    // one 64 x 64 panel: 8 KB
constexpr int kThreads = 384;         // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;    // 2 * 128 * 232 + 128 * 40 <= 65,536
constexpr int kSmemLimit = 232448;    // a block's shared memory on Hopper

template <int kHeadDim>
struct WideLayout {
  static constexpr int kPanels = kHeadDim / kPanelCols;
  // above d = 256 the warpgroups split the panels of one 64-row q block
  static constexpr bool kSplitCols = kHeadDim > 256;
  static constexpr int kRowGroups = kSplitCols ? 1 : 2;
  static constexpr int kBlockQ = kRowGroups * kRows;
  // panels (output columns, and at kSplitCols the share of q.k^T's
  // reduction) of warpgroup 0 and of warpgroup 1
  static constexpr int kPanels0 = kSplitCols ? (kPanels + 1) / 2 : kPanels;
  static constexpr int kPanels1 = kSplitCols ? kPanels - kPanels0 : kPanels;
  static constexpr int kQBytes = kRowGroups * kPanels * kPanelBytes;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  // the two warpgroups' fp32 score halves of a 64 x 64 tile
  static constexpr int kXBytes = kSplitCols ? 2 * kRows * kRows * 4 : 0;
  // stages: all the tiles that fit beside Q and the score halves (leaving
  // the alignment slack and 16 barriers), K first, at most 3 each
  static constexpr int kTiles =
      (kSmemLimit - 1024 - 8 * 16 - kQBytes - kXBytes) / kTileBytes;
  static constexpr int kKStages = (kTiles + 1) / 2 < 3 ? (kTiles + 1) / 2 : 3;
  static constexpr int kVStages = kTiles - kKStages < 3 ? kTiles - kKStages : 3;
  static constexpr int kXOff = kQBytes;
  static constexpr int kKOff = kXOff + kXBytes;
  static constexpr int kVOff = kKOff + kKStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kVStages * kTileBytes;
  // + 1024: the dynamic shared memory base is only known to be 16-byte aligned
  static constexpr size_t kSmemBytes =
      kBarOff + 8 * (1 + 2 * kKStages + 2 * kVStages) + 1024;
  static_assert(kVStages >= 1 && kSmemBytes <= kSmemLimit, "shared memory");
};

// What one block does: a q block of one plane, over K/V tiles [t0, t1).
struct Work {
  int head, batch, plane, q0, split, t0, t1;
};

// s = Q.K^T over the kGP panels at q_panels / k_panels (64 x 64, fp32),
// issued and committed as one wgmma group
template <int kGP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_panels,
                                         uint32_t k_panels) {
  fence_registers(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kGP * 4; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;   // 16 bf16 a step
    wgmma_ss_n64(s, smem_desc(q_panels + off, 16, 1024),
                 smem_desc(k_panels + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

template <int kGP>
__device__ __forceinline__ void wgmma_pv(float (&o)[kGP * 32], const uint32_t* p,
                                         uint64_t desc_v) {
  static_assert(kGP >= 2 && kGP <= 4, "a warpgroup's panels");
  if constexpr (kGP == 2) wgmma_rs_n128(o, p[0], p[1], p[2], p[3], desc_v);
  else if constexpr (kGP == 3) wgmma_rs_n192(o, p[0], p[1], p[2], p[3], desc_v);
  else wgmma_rs_n256(o, p[0], p[1], p[2], p[3], desc_v);
}

// o += P.V over the kGP panels of the V tile at v_panels, one wgmma group
template <int kGP>
__device__ __forceinline__ void issue_pv(float (&o)[kGP * 32], uint32_t (&p)[16],
                                         uint32_t v_panels) {
  fence_registers(o);
  fence_registers(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<kGP>(o, p + 4 * kk,
                  smem_desc(v_panels + kk * 16 * kPanelRowBytes, kPanelBytes, 1024));
  wgmma_commit();
}

__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Scores of the tile at k0 in, unnormalised probabilities out. At d > 256
// the warpgroup's half of the scores goes to shared memory at `x_mine`
// (element i of a thread at i * 512 bytes from it, the other warpgroup's
// 16 KB away), the other half is added (S0 + S1 in both warpgroups: the
// same bits), and both run the same softmax. Barrier 3: both halves
// written; 4: both read. Addresses stay 32-bit: beside a d = 512
// accumulator every register counts.
template <typename L, bool kCausal>
__device__ __forceinline__ void softmax_tile(float (&s)[32], SoftmaxRows& rows,
                                             int k0, int kv_len, int group_q0,
                                             float scale_log2, int group,
                                             uint32_t x_mine, float& alpha0,
                                             float& alpha1) {
  if constexpr (L::kSplitCols) {
    const uint32_t x_theirs = group == 0 ? x_mine + 128 * 32 * 4 : x_mine - 128 * 32 * 4;
#pragma unroll
    for (int i = 0; i < 32; ++i) st_shared(x_mine + i * 512, s[i]);
    named_barrier_sync(3, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += ld_shared(x_theirs + i * 512);
    named_barrier_sync(4, 256);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
  rows.template update<kRows, true, kCausal>(s, k0, kv_len, group_q0, 1.f, alpha0,
                                             alpha1);
}

// One consumer warpgroup: kGP panels from panel `pa`, its q rows from
// group_q0. Walks the block's tiles [t0, t1) (the live ones, those with a
// column <= its last row under the causal mask, through the products),
// then writes bf16 o through a TMA store or, when the K/V range is split,
// the fp32 partial and the rows' max and sum.
template <typename L, bool kCausal, int kGP>
__device__ __forceinline__ void consume(const Work& w, int group, int pa,
                                        int group_q0, uint32_t s_base,
                                        unsigned char* smem, const CUtensorMap* map_o,
                                        float* part_o, float* part_ml, int planes,
                                        int rows_pad, int kv_len, int partial,
                                        float scale_log2) {
  const uint32_t bar_q = s_base + L::kBarOff;
  const uint32_t k_full = bar_q + 8, k_empty = k_full + 8 * L::kKStages;
  const uint32_t v_full = k_empty + 8 * L::kKStages, v_empty = v_full + 8 * L::kVStages;
  const uint32_t q_smem = s_base + (L::kSplitCols ? 0 : group * L::kPanels * kPanelBytes)
                          + pa * kPanelBytes;
  const uint32_t k_ring = s_base + L::kKOff + pa * kPanelBytes;
  const uint32_t v_ring = s_base + L::kVOff + pa * kPanelBytes;
  const int gtid = threadIdx.x % 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int row_in_group = (gtid / 32) * 16 + lane / 4;   // and + 8
  const uint32_t x_mine = s_base + L::kXOff + (group * 32 * 128 + gtid) * 4;

  int te = w.t1;
  if (kCausal) te = min(te, (group_q0 + kRows + kRows - 1) / kRows);
  float o[kGP * 32];
#pragma unroll
  for (int i = 0; i < kGP * 32; ++i) o[i] = 0.f;
  SoftmaxRows rows{kMask, kMask, 0.f, 0.f, group_q0 + row_in_group,
                   group_q0 + row_in_group + 8, quad};
  RingPos<L::kKStages> kp;
  RingPos<L::kVStages> vp;
  float s[32], alpha0, alpha1;
  uint32_t p[16];

  mbar_wait(bar_q, 0);
  if (te > w.t0) {
    mbar_wait(k_full + 8 * kp.stage, kp.phase);
    issue_qk<kGP>(s, q_smem, k_ring + kp.stage * L::kTileBytes);
    wgmma_wait<0>();
    fence_registers(s);
    if (lane == 0) mbar_arrive(k_empty + 8 * kp.stage);
    kp = kp.next();
    softmax_tile<L, kCausal>(s, rows, w.t0 * kRows, kv_len, group_q0, scale_log2,
                             group, x_mine, alpha0, alpha1);
    fd_flash::pack_p<kRows>(p, s);
    for (int t = w.t0 + 1; t < te; ++t) {
      mbar_wait(k_full + 8 * kp.stage, kp.phase);
      issue_qk<kGP>(s, q_smem, k_ring + kp.stage * L::kTileBytes);
      mbar_wait(v_full + 8 * vp.stage, vp.phase);
      issue_pv<kGP>(o, p, v_ring + vp.stage * L::kTileBytes);
      wgmma_wait<1>();
      fence_registers(s);
      if (lane == 0) mbar_arrive(k_empty + 8 * kp.stage);
      kp = kp.next();
      softmax_tile<L, kCausal>(s, rows, t * kRows, kv_len, group_q0, scale_log2,
                               group, x_mine, alpha0, alpha1);
      wgmma_wait<0>();
      fence_registers(o);
      fence_registers(p);
      if (lane == 0) mbar_arrive(v_empty + 8 * vp.stage);
      vp = vp.next();
      fd_flash::rescale<kGP * kPanelCols>(o, alpha0, alpha1);
      fd_flash::pack_p<kRows>(p, s);
    }
    mbar_wait(v_full + 8 * vp.stage, vp.phase);
    issue_pv<kGP>(o, p, v_ring + vp.stage * L::kTileBytes);
    wgmma_wait<0>();
    fence_registers(o);
    fence_registers(p);
    if (lane == 0) mbar_arrive(v_empty + 8 * vp.stage);
    vp = vp.next();
  }
  // the tiles of the block above this group's rows still pass through the rings
  for (int t = max(te, w.t0); t < w.t1; ++t) {
    mbar_wait(k_full + 8 * kp.stage, kp.phase);
    if (lane == 0) mbar_arrive(k_empty + 8 * kp.stage);
    kp = kp.next();
    mbar_wait(v_full + 8 * vp.stage, vp.phase);
    if (lane == 0) mbar_arrive(v_empty + 8 * vp.stage);
    vp = vp.next();
  }

  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = group_q0 + row_in_group, r1 = r0 + 8;
  if (partial) {
    // unnormalised fp32 rows of this split, with their max and sum
    constexpr int kD = L::kPanels * kPanelCols;
    const size_t base = (static_cast<size_t>(w.split) * planes + w.plane) * rows_pad;
    float* po = part_o + base * kD;
#pragma unroll
    for (int j = 0; j < kGP * 8; ++j) {
      const int col = pa * kPanelCols + 8 * j + 2 * quad;
      *reinterpret_cast<float2*>(po + static_cast<size_t>(r0) * kD + col) =
          make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(po + static_cast<size_t>(r1) * kD + col) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (quad == 0 && (!L::kSplitCols || group == 0)) {
      float* ml = part_ml + base * 2;
      *reinterpret_cast<float2*>(ml + 2 * r0) = make_float2(rows.m0, l0);
      *reinterpret_cast<float2*>(ml + 2 * r1) = make_float2(rows.m1, l1);
    }
    return;
  }
  // o = acc / l through this group's Q panels (no wgmma reads them any
  // more) and out as one TMA store a panel, which drops rows past q_len
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  named_barrier_sync(1 + group, 128);
  unsigned char* o_smem = smem + (q_smem - s_base);
  const int rr0 = row_in_group, rr1 = row_in_group + 8;
#pragma unroll
  for (int j = 0; j < kGP * 8; ++j) {
    unsigned char* panel = o_smem + (j / 8) * kPanelBytes + quad * 4;
    *reinterpret_cast<uint32_t*>(panel + rr0 * kPanelRowBytes
                                 + (((j % 8) ^ (rr0 % 8)) * 16)) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(panel + rr1 * kPanelRowBytes
                                 + (((j % 8) ^ (rr1 % 8)) * 16)) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  fence_proxy_async_shared();
  named_barrier_sync(1 + group, 128);
  if (gtid == 0) {
    for (int pn = 0; pn < kGP; ++pn)
      tma_store_4d(map_o, q_smem + pn * kPanelBytes, (pa + pn) * kPanelCols, w.head,
                   group_q0, w.batch);
    tma_store_commit_and_wait();
  }
}

// The grid is one-dimensional: block = (work item) * splits + split, with
// the work items (a q block of one plane) q block fastest, or under the
// causal mask longest first. The tensor maps are 4-D (column in head, head,
// row, batch) with 64 x 64 boxes; plane = batch * heads + head. With
// `partial` the block writes split partials (rows_pad rows a plane and
// split) instead of o.
template <int kHeadDim, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o, float* part_o,
                      float* part_ml, int heads, int q_blocks, int planes,
                      int kv_len, int splits, int tiles_per_split, int rows_pad,
                      float scale_log2) {
  using L = WideLayout<kHeadDim>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - smem_u32(smem_raw));
  const uint32_t bar_q = s_base + L::kBarOff;
  const uint32_t k_full = bar_q + 8, k_empty = k_full + 8 * L::kKStages;
  const uint32_t v_full = k_empty + 8 * L::kKStages, v_empty = v_full + 8 * L::kVStages;

  Work w;
  w.split = blockIdx.x % splits;
  const int item = blockIdx.x / splits;
  int q_block;
  if (kCausal) {
    q_block = q_blocks - 1 - item / planes;
    w.plane = item % planes;
  } else {
    q_block = item % q_blocks;
    w.plane = item / q_blocks;
  }
  w.head = w.plane % heads;
  w.batch = w.plane / heads;
  w.q0 = q_block * L::kBlockQ;
  int n_tiles = (kv_len + kRows - 1) / kRows;
  if (kCausal) n_tiles = min(n_tiles, (w.q0 + L::kBlockQ + kRows - 1) / kRows);
  w.t0 = w.split * tiles_per_split;
  w.t1 = max(w.t0, min(w.t0 + tiles_per_split, n_tiles));

  const int tid = threadIdx.x, group = tid / 128;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kKStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    for (int s = 0; s < L::kVStages; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (group == 2) {
    // ---- producer: one thread loads Q and the K ring, another the V ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int g = 0; g < L::kRowGroups; ++g)
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(s_base + (g * L::kPanels + p) * kPanelBytes, &map_q, bar_q,
                      p * kPanelCols, w.head, w.q0 + g * kRows, w.batch);
      RingPos<L::kKStages> kp;
      for (int t = w.t0; t < w.t1; ++t) {
        mbar_wait(k_empty + 8 * kp.stage, kp.phase ^ 1);   // passes on a fresh ring
        mbar_expect_tx(k_full + 8 * kp.stage, L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(s_base + L::kKOff + kp.stage * L::kTileBytes + p * kPanelBytes,
                      &map_k, k_full + 8 * kp.stage, p * kPanelCols, w.head, t * kRows,
                      w.batch);
        kp = kp.next();
      }
    } else if (tid == 288) {
      RingPos<L::kVStages> vp;
      for (int t = w.t0; t < w.t1; ++t) {
        mbar_wait(v_empty + 8 * vp.stage, vp.phase ^ 1);
        mbar_expect_tx(v_full + 8 * vp.stage, L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(s_base + L::kVOff + vp.stage * L::kTileBytes + p * kPanelBytes,
                      &map_v, v_full + 8 * vp.stage, p * kPanelCols, w.head, t * kRows,
                      w.batch);
        vp = vp.next();
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int partial = splits > 1;
    if (group == 0)
      consume<L, kCausal, L::kPanels0>(w, 0, 0, w.q0, s_base, smem, &map_o, part_o,
                                       part_ml, planes, rows_pad, kv_len, partial,
                                       scale_log2);
    else
      consume<L, kCausal, L::kPanels1>(
          w, 1, L::kSplitCols ? L::kPanels0 : 0, L::kSplitCols ? w.q0 : w.q0 + kRows,
          s_base, smem, &map_o, part_o, part_ml, planes, rows_pad, kv_len, partial,
          scale_log2);
  }
}

template <int kHeadDim, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Geometry* geometry, float* part_o, float* part_ml,
                   int rows_pad, int splits, int tiles_per_split, float scale_log2,
                   cudaStream_t stream) {
  using L = WideLayout<kHeadDim>;
  const Geometry& gq = geometry[0];
  const Geometry& gk = geometry[1];
  for (int i = 0; i < 4; ++i)
    if (geometry[i].dims[0] != static_cast<uint64_t>(kHeadDim)
        || geometry[i].dims[1] != gq.dims[1] || geometry[i].dims[3] != gq.dims[3]
        || geometry[i].dims[2] != (i == 0 || i == 3 ? gq : gk).dims[2])
      return cudaErrorInvalidValue;
  const uint64_t heads = gq.dims[1], q_len = gq.dims[2], kv_len = gk.dims[2];
  const uint64_t planes = heads * gq.dims[3];
  if (q_len == 0 || kv_len == 0 || q_len > INT32_MAX || kv_len > INT32_MAX
      || planes == 0 || planes > INT32_MAX)
    return cudaErrorInvalidValue;
  // every split holds at least one of the kv_len tiles; partials need buffers
  const uint64_t tiles = (kv_len + kRows - 1) / kRows;
  if (splits < 1 || tiles_per_split < 1
      || static_cast<uint64_t>(splits - 1) * tiles_per_split >= tiles
      || static_cast<uint64_t>(splits) * tiles_per_split < tiles
      || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  // the caller sized the partial buffers' rows a plane by this layout's q blocks
  const uint64_t q_blocks = (q_len + L::kBlockQ - 1) / L::kBlockQ;
  const uint64_t blocks = q_blocks * planes * splits;
  if (blocks > INT32_MAX || rows_pad < 1
      || static_cast<uint64_t>(rows_pad) != q_blocks * L::kBlockQ)
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_o;
  cudaError_t err = make_map(&map_q, q, geometry[0], kRows);
  if (err == cudaSuccess) err = make_map(&map_k, k, geometry[1], kRows);
  if (err == cudaSuccess) err = make_map(&map_v, v, geometry[2], kRows);
  if (err == cudaSuccess) err = make_map(&map_o, o, geometry[3], kRows);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wide_fwd_kernel<kHeadDim, kCausal>;
  // once per instantiation and device
  static int allowed_on = -1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess && allowed_on != device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmemBytes));
    if (err == cudaSuccess) allowed_on = device;
  }
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kSmemBytes, stream>>>(
      map_q, map_k, map_v, map_o, part_o, part_ml, static_cast<int>(heads),
      static_cast<int>(q_blocks), static_cast<int>(planes), static_cast<int>(kv_len),
      splits, tiles_per_split, rows_pad, scale_log2);
  return cudaGetLastError();
}

#define FD_WIDE_CASE(D)                                                          \
  case D:                                                                        \
    return causal ? launch<D, true>(q, k, v, o, g, po, pml, rows_pad, splits,    \
                                    tiles_per_split, scale_log2, s)              \
                  : launch<D, false>(q, k, v, o, g, po, pml, rows_pad, splits,   \
                                     tiles_per_split, scale_log2, s);

}  // namespace

extern "C" {

// q [batch, heads, q_len, head_dim], k / v [batch, heads, kv_len, head_dim],
// o like q, bf16, as `geometry` (four Geometry records, q, k, v, o, each
// with 64 x 64 boxes: ops/attention.py::wide_geometry) describes them.
// head_dim 192, 256, 320, 384, 448 or 512; `scale_log2` is the softmax scale
// times log2 e; `causal` masks top-left (needs q_len == kv_len, which the
// wrapper checks). The kv_len tiles of 64 rows are split in `splits` ranges
// of `tiles_per_split` (ops/attention.py::wide_plan): with one split o is
// written; with more, part_o [splits, planes, rows_pad, head_dim] and
// part_ml [splits, planes, rows_pad, 2] (fp32) take the partials for
// fd_flash_attention_wide_merge. rows_pad must be the q blocks' rows at
// this head dim (WideLayout::kBlockQ; ops/attention.py::wide_plan's
// block_q), else nothing launches.
// Returns a cudaError_t code.
int fd_flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* geometry, void* part_o,
                                void* part_ml, int rows_pad, int head_dim, int splits,
                                int tiles_per_split, float scale_log2, int causal,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const Geometry*>(geometry);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  switch (head_dim) {
    FD_WIDE_CASE(192)
    FD_WIDE_CASE(256)
    FD_WIDE_CASE(320)
    FD_WIDE_CASE(384)
    FD_WIDE_CASE(448)
    FD_WIDE_CASE(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The splits' partials (as fd_flash_attention_wide_fwd wrote them) merged
// into bf16 o at element strides o_strides = (batch, head, row), unit
// columns; planes = batch * heads, rows 0 ... q_len - 1 of each. Returns a
// cudaError_t code.
int fd_flash_attention_wide_merge(const void* part_o, const void* part_ml, void* o,
                                  const void* o_strides, int heads, int planes,
                                  int q_len, int rows_pad, int head_dim, int splits,
                                  void* stream) {
  const auto* st = static_cast<const long long*>(o_strides);
  const auto* po = static_cast<const float*>(part_o);
  const auto* pml = static_cast<const float*>(part_ml);
  auto* ob = static_cast<bf16*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define FD_MERGE_CASE(D)                                                                  \
  case D:                                                                                 \
    return static_cast<int>(fd_flash::launch_merge<D, bf16>(po, pml, ob, st, heads, planes, \
                                                            q_len, rows_pad, splits, s));
    FD_MERGE_CASE(192)
    FD_MERGE_CASE(256)
    FD_MERGE_CASE(320)
    FD_MERGE_CASE(384)
    FD_MERGE_CASE(448)
    FD_MERGE_CASE(512)
#undef FD_MERGE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
