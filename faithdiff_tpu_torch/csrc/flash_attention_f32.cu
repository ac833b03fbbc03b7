// Flash-attention forward for Hopper (sm_90a) in float32: fp32 in and out,
// head dim 64, 128 or a wide one (192 ... 512, multiples of 64), in both
// layouts the tensor maps describe: contiguous [B, H, S, d] planes and
// packed [b, s, n*d] rows (column slices of a fused projection included).
//
// Replaces the fp32 instantiation of:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl): JAX gates its kernel on shapes alone, so
//   the fp32 trainer (`cli.py train --dtype float32`) runs it at fp32, at
//   every UNet self-attention of >= 1024 tokens ([B,10,1024,64] at 512 px,
//   10 a stage-1 micro-step; [B,10,4096,64] at a 1024 px tile), causal or not,
//   and at 256 px at the VAE's single-head d = 512 attention over a 32 x 32
//   latent ([B,1,1024,512]: the VAE encode and the denoise encoder);
// - faithdiff_tpu/ops/attention.py::_flash_kernel_bsnd (launched by
//   _flash_attention_bsnd_impl) at fp32: the packed [b, s, n*d] projection
//   outputs under FAITHDIFF_BSND_ATTN=1, non-causal.
//
// What it computes: o = softmax(q k^T * scale) v with the TPU kernels'
// arithmetic: q * (scale * log2 e) once, in fp32; fp32 scores; an online
// softmax in base 2 over K/V tiles (m, l, acc carried in registers, acc
// rescaled by alpha = 2^(m_old - m_new)); p kept in fp32 for p.v; fp32
// accumulation; o = acc * (1 / l). Columns past kv_len and, under
// `causal`, columns above the diagonal (top-left: col > row) score
// -0.7 * FLT_MAX, as the TPU kernel's DEFAULT_MASK_VALUE.
//
// What bounds it on the card: operations. 4 * BH * S^2 * d flops against
// 16 * BH * S * d bytes of q/k/v/o: ~1,000 flops a byte at S = 4096, far
// past the ridge. fp32 products on the CUDA cores peak at 67 TFLOP/s; the
// tensor cores take TF32 at 495. One TF32 product keeps 11 significant
// bits of each operand (relative error ~2^-11: too far from the fp32
// plain version, PERF.md), but split precision does not: each operand x
// is split into big = tf32(x) and small = tf32(x - big) (cvt.rna, round to
// nearest, ties away), and x.y is taken as small.big + big.small + big.big,
// accumulated in fp32, the small products first (CUTLASS's "3xTF32",
// OpMultiplyAddFastF32, which SDPA's fp32 kernel runs): ~2^-21 relative,
// fp32's own accuracy for these sums, at 495 / 3 = 165 TFLOP/s. That rate
// is the kernel's bound.
//
// The design:
// 1. Products on the tensor cores: mma.sync m16n8k8 .tf32 (row.col) for
//    both q.k^T and P.V, three a product as above. wgmma takes .tf32 only
//    with both operands K-major, and V's reduction axis (keys) is strided;
//    mma.sync reads its B fragments from row-major V in shared memory
//    instead, with nothing transposed, and the accumulator of q.k^T is
//    already P's A fragment for P.V: with keys 2t and 2t + 1 of each 8-key
//    step taken as the fragment's k = t and t + 4 (V's rows read in the
//    same order), no shuffle is needed. Operands are split as they leave
//    shared memory (a shared copy of big and small would double the bytes
//    and halve the ring): q (scaled once, in place) and K through ldmatrix
//    (an 8 x 4 fp32 block is an 8 x 8 b16 matrix), V by plain loads (its
//    fragment is the transpose of ldmatrix's), P split once a tile (d <=
//    256) or once a V panel (d > 256, where registers are short).
//    Accumulation: the tensor cores add into their accumulator less exactly
//    than an fp32 add, and over 4096 keys in one accumulator the output
//    drifted to 2.4x the tolerance (PERF.md); so each V panel's products of
//    a tile go to registers of their own (at d <= 128 the small products
//    and big.big apart: twice the independent mma chains), added to the
//    output accumulator once with an fp32 add (~1e-6 relative at 4096 keys).
//    The loops over a tile's panels stay rolled: unrolled, the d = 512
//    instance spilled ~1 KB a thread and ran 1.9x slower (PERF.md).
// 2. Asynchronous K/V: Q, K and V arrive by TMA tensor maps (fp32, 32-column
//    128-byte panels of 64 rows, the 128-byte swizzle, which makes every
//    fragment read below free of bank conflicts) into a ring of panels on
//    mbarriers that count bytes. One producer thread streams a tile's K
//    panels, then its V panels, as far ahead as the ring holds (8 ... 16
//    panels: up to two tiles of K and V at d = 64), so tile t + 1's K loads
//    while tile t's products and softmax run. A consumer warp frees a slot
//    only after a CTA fence and a proxy fence (`release`): its reads are
//    generic-proxy loads and the next fill an async-proxy write, and without
//    the fences one warp's rows came out wrong, different on each call,
//    where two blocks shared an SM. The producer is a warpgroup of its own
//    that gives its registers to the consumers (setmaxnreg): a block of 5
//    or 9 warps puts 3 on one SM quarter and caps ptxas at 168 registers.
// 3. Scores once a block. A block owns 64 q rows, 16 a consumer warp. At
//    d <= 128 each of its 4 consumer warps holds all d output columns. Above,
//    the fp32 accumulator of 16 rows x d would not fit a thread's registers
//    (d = 512: 256), so 8 consumer warps split the d columns into two halves:
//    a warp multiplies q.k^T over its half's panels only, the two fp32 16 x
//    64 score halves of a row group meet in shared memory (32 KB), both warps
//    add them (the same bits: fp32 addition commutes) and run the same
//    softmax, and each multiplies P by its half of V. The scores of a block
//    are computed once, for all d output columns; Q stays whole in shared
//    memory (128 KB at d = 512) and K/V stream through the ring by panels.
// 4. Short grids split K/V. `ops/attention.py::f32_plan` picks, from the
//    shape alone, how many blocks share a q block's K/V tiles: as many as
//    one wave of the blocks an SM holds (2 at d <= 128, 1 above), while each
//    split walks at least 2 tiles. A split writes its unnormalised fp32 rows
//    and their max and sum; flash_wide_merge_kernel (flash_tile.cuh, the
//    wide bf16 kernel's, here with fp32 output) combines the splits in split
//    order. No atomics: a repeat gives the same bits.
//
// Shared memory a block (F32Layout): Q, then at d > 128 the score halves,
// then the ring, then the mbarriers, from a 1024-byte aligned base: d = 64:
// 107,704 bytes (11 ring panels; 2 blocks an SM); 128: 107,672 (9); 192:
// 214,280 (16); 256: 230,664 (16); 320: 230,632 (14); 384: 230,600 (12);
// 448: 230,568 (10); 512: 230,536 (8).
#include "flash_tile.cuh"

namespace {

using namespace fd_hopper;
using fd_flash::Geometry;
using fd_flash::kMask;
using fd_flash::make_map;
using fd_flash::SoftmaxRows;

constexpr int kRows = 64;             // q rows a block, K/V rows a tile, TMA box rows
constexpr int kPanelCols = 32;        // fp32 columns of one 128-byte panel row
constexpr int kPanelBytes = kRows * 128;   // one 64 x 32 panel: 8 KB
constexpr int kRowGroups = 4;         // consumer warps of 16 q rows a column half
constexpr int kMaxRing = 16;

template <int kHeadDim>
struct F32Layout {
  static constexpr int kPanels = kHeadDim / kPanelCols;
  // above d = 128 two column halves of warps share the block's rows
  static constexpr int kHalves = kHeadDim > 128 ? 2 : 1;
  static constexpr int kHalfPanels = kPanels / kHalves;
  static constexpr int kConsumerWarps = kRowGroups * kHalves;
  // the consumer warpgroups and a producer warpgroup (one thread of it works)
  static constexpr int kThreads = (kConsumerWarps + 4) * 32;
  // two blocks an SM at d <= 128 (each within half the SM's 228 KB, less the
  // 1 KB a block reserves), one above
  static constexpr int kBlocksPerSm = kHalves == 1 ? 2 : 1;
  // registers a thread after setmaxnreg: the producer warpgroup gives its
  // share to the consumers (d <= 128: 128 * 232 + 128 * 24 = 32,768, half
  // the SM's; above: 256 * 240 + 128 * 24 = 64,512, what a 384-thread block
  // is given)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kHalves == 1 ? 232 : 240;
  static constexpr int kBudget = kHalves == 1 ? 115712 : 232448;
  static constexpr int kQBytes = kPanels * kPanelBytes;
  // every consumer warp's 32 score registers x 32 lanes
  static constexpr int kXBytes = kHalves == 2 ? kConsumerWarps * 32 * 32 * 4 : 0;
  static constexpr int kFit =
      (kBudget - 1024 - kQBytes - kXBytes - 8 * (1 + 2 * kMaxRing)) / kPanelBytes;
  // an even ring at two halves: a half's panels keep to slots of its parity
  static constexpr int kRing = (kFit < kMaxRing ? kFit : kMaxRing) & ~(kHalves - 1);
  static constexpr int kXOff = kQBytes;
  static constexpr int kRingOff = kXOff + kXBytes;
  static constexpr int kBarOff = kRingOff + kRing * kPanelBytes;
  // + 1024: the dynamic shared memory base is only known to be 16-byte aligned
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 2 * kRing) + 1024;
  // P split once a tile into 64 registers where the output accumulator
  // leaves room; P.V's small products in an accumulator of their own (twice
  // the independent mma chains) where the warp holds 32 or 64 output columns
  static constexpr bool kKeepP = kHalfPanels <= 4;
  static constexpr bool kSmallPv = kHalves == 1;
  static_assert(kPanels % kHalves == 0 && kRing >= 2 * kHalves && kSmemBytes <= kBudget,
                "shared memory");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (the low 13 bits of the fp32 pattern clear)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d (16 x 8, fp32) += A (16 x 8, TF32, row) . B (8 x 8, TF32, col)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lds(const unsigned char* base, uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}

// Four 8 x 4 fp32 blocks of shared memory (ldmatrix's 8 x 8 b16 matrices),
// each lane's row address from lanes 8m ... 8m + 7 for block m: register m
// of lane (g, t4) = element (g, t4) of block m.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A consumer warp is done with a ring slot: its reads of the slot are
// complete and ordered before the producer's next TMA write into it (a
// generic-proxy read, then an async-proxy write: without both fences a
// block's warps read panels the next load had begun to overwrite, seen as
// one warp's rows wrong and different bits call to call, PERF.md), then
// one arrival for the warp.
__device__ __forceinline__ void release(uint32_t empty_bar, int lane) {
  __threadfence_block();
  fence_proxy_async_shared();
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_bar);
}

// The byte offset of element (row, col) of a 64 x 32 fp32 panel in the
// 128-byte swizzle: the row's 16-byte units permuted by the row's low 3 bits.
__host__ __device__ constexpr uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7))) << 4) + (col & 3) * 4;
}

// A block: the q block at q0 of one plane, over K/V tiles [t0, t1). The
// grid is one-dimensional: block = (work item) * splits + split, the work
// items (a q block of one plane) q block fastest, or under the causal mask
// longest first. The tensor maps are 4-D (column in head, head, row, batch)
// with 32 x 64 boxes; plane = batch * heads + head; o is written at element
// strides (head, row, batch) of the same coordinates. With splits > 1 the
// block writes its split's partials (rows_pad rows a plane and split)
// instead of o.
template <int kHeadDim, bool kCausal>
__global__ void __launch_bounds__(F32Layout<kHeadDim>::kThreads,
                                  F32Layout<kHeadDim>::kBlocksPerSm)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, float* o,
                     long long o_head, long long o_row, long long o_batch,
                     float* part_o, float* part_ml, int heads, int q_len, int q_blocks,
                     int planes, int kv_len, int splits, int tiles_per_split,
                     int rows_pad, float scale_log2) {
  using L = F32Layout<kHeadDim>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - smem_u32(smem_raw));
  const uint32_t bar_q = s_base + L::kBarOff;
  const uint32_t full = bar_q + 8, empty = full + 8 * L::kRing;

  const int split = blockIdx.x % splits;
  const int item = blockIdx.x / splits;
  int q_block, plane;
  if (kCausal) {
    q_block = q_blocks - 1 - item / planes;
    plane = item % planes;
  } else {
    q_block = item % q_blocks;
    plane = item / q_blocks;
  }
  const int head = plane % heads, batch = plane / heads;
  const int q0 = q_block * kRows;
  int n_tiles = (kv_len + kRows - 1) / kRows;
  // under the causal mask: the tiles holding a column <= the block's last row
  if (kCausal) n_tiles = min(n_tiles, q_block + 1);
  const int t0 = split * tiles_per_split;
  const int t1 = max(t0, min(t0 + tiles_per_split, n_tiles));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kRowGroups);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The ring's stream: panel use n of a block is, for its tile tt = t - t0,
  // K then V, panel i of half h at n = tt * 2P + (V ? P : 0) + i * halves + h
  // (P = d / 32 panels), in slot n % kRing, for the (n / kRing)-th time.
  if (warp >= L::kConsumerWarps) {
    // ---- producer: one thread loads Q and streams the K / V panels ----
    setmaxnreg_dec<L::kProducerRegs>();
    if (warp == L::kConsumerWarps && lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(s_base + p * kPanelBytes, &map_q, bar_q, p * kPanelCols, head, q0,
                    batch);
      int n = 0;
      for (int t = t0; t < t1; ++t)
        for (int kv = 0; kv < 2; ++kv)
          for (int i = 0; i < L::kHalfPanels; ++i)
            for (int h = 0; h < L::kHalves; ++h, ++n) {
              const int slot = n % L::kRing;
              mbar_wait(empty + 8 * slot, ((n / L::kRing) & 1) ^ 1);   // or a fresh slot
              mbar_expect_tx(full + 8 * slot, kPanelBytes);
              tma_load_4d(s_base + L::kRingOff + slot * kPanelBytes, kv ? &map_v : &map_k,
                          full + 8 * slot, (h * L::kHalfPanels + i) * kPanelCols, head,
                          t * kRows, batch);
            }
    }
    return;
  }

  // ---- consumers: warp (row group rg, column half h): 16 q rows ----
  setmaxnreg_inc<L::kConsumerRegs>();
  constexpr int kCols = L::kHalfPanels * kPanelCols;   // output columns a warp
  const int rg = warp % kRowGroups, h = warp / kRowGroups;
  const int g = lane / 4, t4 = lane % 4;
  const int warp_q0 = q0 + rg * 16;
  // mma fragments (thread g = lane / 4, t4 = lane % 4): A of q.k^T at
  // rows rg*16 + g (+ 8), columns 8kk + t4 (+ 4), and B at K rows 8j + g,
  // the same columns, both by ldmatrix; B of P.V by plain loads (swz) at V
  // rows 8j + 2 t4 (+ 1), columns 8nn + g
  const unsigned char* ring = smem + L::kRingOff;
  // ldmatrix row addresses: Q's blocks (rows + 0 / 8, columns 8kk + 0 / 4:
  // a0 ... a3), K's (rows 8j / 8j + 8, columns 8kk + 0 / 4: b0, b1 of n-tiles
  // j and j + 1); the 16-byte unit of column 8kk is swizzled by the row
  const int lr = lane % 8;
  const uint32_t q_row = s_base + h * L::kHalfPanels * kPanelBytes
                         + (rg * 16 + lr + 8 * ((lane / 8) % 2)) * 128;
  const int q_unit = lane / 16;
  const uint32_t k_row = s_base + L::kRingOff + (8 * (lane / 16) + lr) * 128;
  const int k_unit = (lane / 8) % 2;
  float o_acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o_acc[i] = 0.f;
  SoftmaxRows rows{kMask, kMask, 0.f, 0.f, warp_q0 + g, warp_q0 + g + 8, t4};
  const uint32_t x_mine = L::kXOff + ((h * kRowGroups + rg) * 32 * 32 + lane) * 4;
  const uint32_t x_theirs = L::kXOff + (((1 - h) * kRowGroups + rg) * 32 * 32 + lane) * 4;

  mbar_wait(bar_q, 0);
  {
    // q * (scale log2 e), once, in place: this warp's 16 rows of its panels
    // (no other warp reads them)
    float* qw = reinterpret_cast<float*>(smem + h * L::kHalfPanels * kPanelBytes
                                         + rg * 16 * 128);
#pragma unroll
    for (int i = 0; i < L::kHalfPanels; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) qw[i * kPanelBytes / 4 + e * 32 + lane] *= scale_log2;
    __syncwarp();
  }
  int n_base = 0;
  for (int t = t0; t < t1; ++t, n_base += 2 * L::kPanels) {
    // s = (q * scale log2 e) . k^T over this half's panels, 3xTF32
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    // rolled panel loops (here and for P.V): unrolled over the panels the
    // kernel outgrows the instruction cache and spills (rolled, 0.128 ->
    // 0.068 ms at [1,1,1024,512], and no shape slower: PERF.md)
#pragma unroll 1
    for (int i = 0; i < L::kHalfPanels; ++i) {
      const int n = n_base + i * L::kHalves + h;
      const int slot = n % L::kRing;
      mbar_wait(full + 8 * slot, (n / L::kRing) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t raw[4], ab[4], as[4];
        ldsm_x4(q_row + i * kPanelBytes + (((2 * kk + q_unit) ^ lr) << 4), raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), ab[e], as[e]);
        const uint32_t k_at = k_row + slot * kPanelBytes + (((2 * kk + k_unit) ^ lr) << 4);
#pragma unroll
        for (int jc = 0; jc < 8; jc += 4) {
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int jp = 0; jp < 4; jp += 2) {
            ldsm_x4(k_at + (jc + jp) * 1024, raw);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(__uint_as_float(raw[e]), bb[jp + e / 2][e % 2], bs[jp + e / 2][e % 2]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(s + 4 * (jc + jj), as, bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(s + 4 * (jc + jj), ab, bs[jj][0], bs[jj][1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(s + 4 * (jc + jj), ab, bb[jj][0], bb[jj][1]);
        }
      }
      release(empty + 8 * slot, lane);
    }
    if constexpr (L::kHalves == 2) {
      // the row group's two score halves: both warps add them alike
      float* xm = reinterpret_cast<float*>(smem + x_mine);
      const float* xt = reinterpret_cast<const float*>(smem + x_theirs);
#pragma unroll
      for (int i = 0; i < 32; ++i) xm[i * 32] = s[i];
      named_barrier_sync(1 + rg, 64);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += xt[i * 32];
      named_barrier_sync(1 + rg, 64);
    }
    float alpha0, alpha1;
    rows.template update<kRows, true, kCausal>(s, t * kRows, kv_len, warp_q0, 1.f,
                                               alpha0, alpha1);
    fd_flash::rescale<kCols>(o_acc, alpha0, alpha1);

    // o += P . V over this half's panels, 3xTF32. P's A fragment at 8-key
    // step j: k = t4 is key 8j + 2 t4 (s[4j], s[4j + 2]), k = t4 + 4 is key
    // 8j + 2 t4 + 1 (s[4j + 1], s[4j + 3]); V's rows are read alike.
    uint32_t pb[L::kKeepP ? 32 : 1], ps[L::kKeepP ? 32 : 1];
    if constexpr (L::kKeepP) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split_tf32(s[4 * j], pb[4 * j], ps[4 * j]);
        split_tf32(s[4 * j + 2], pb[4 * j + 1], ps[4 * j + 1]);
        split_tf32(s[4 * j + 1], pb[4 * j + 2], ps[4 * j + 2]);
        split_tf32(s[4 * j + 3], pb[4 * j + 3], ps[4 * j + 3]);
      }
    }
#pragma unroll 1
    for (int i = 0; i < L::kHalfPanels; ++i) {
      const int n = n_base + L::kPanels + i * L::kHalves + h;
      const int slot = n % L::kRing;
      mbar_wait(full + 8 * slot, (n / L::kRing) & 1);
      const unsigned char* vp = ring + slot * kPanelBytes;
      // this tile's products of the panel in registers of their own, then
      // one fp32 add into the accumulator: the tensor cores' accumulation
      // rounds less exactly than an add, and over thousands of keys in one
      // accumulator it drifts past the tolerance (PERF.md)
      float pv[16], pv_small[L::kSmallPv ? 16 : 1];
      float* acc_small = L::kSmallPv ? pv_small : pv;
#pragma unroll
      for (int e = 0; e < 16; ++e) pv[e] = 0.f;
      if constexpr (L::kSmallPv) {
#pragma unroll
        for (int e = 0; e < 16; ++e) pv_small[e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ab[4], as[4];
        if constexpr (L::kKeepP) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[e] = pb[4 * j + e];
            as[e] = ps[4 * j + e];
          }
        } else {
          split_tf32(s[4 * j], ab[0], as[0]);
          split_tf32(s[4 * j + 2], ab[1], as[1]);
          split_tf32(s[4 * j + 1], ab[2], as[2]);
          split_tf32(s[4 * j + 3], ab[3], as[3]);
        }
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          split_tf32(lds(vp, swz(8 * j + 2 * t4, 8 * nn + g)), bb[nn][0], bs[nn][0]);
          split_tf32(lds(vp, swz(8 * j + 2 * t4 + 1, 8 * nn + g)), bb[nn][1], bs[nn][1]);
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) mma_tf32(acc_small + 4 * nn, as, bb[nn][0], bb[nn][1]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) mma_tf32(acc_small + 4 * nn, ab, bs[nn][0], bs[nn][1]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) mma_tf32(pv + 4 * nn, ab, bb[nn][0], bb[nn][1]);
      }
      release(empty + 8 * slot, lane);
      if constexpr (L::kSmallPv) {
#pragma unroll
        for (int e = 0; e < 16; ++e) pv[e] += pv_small[e];
      }
      // panel i's 16 accumulator registers, named by constants (a register
      // array indexed at run time would live in local memory)
#pragma unroll
      for (int c = 0; c < L::kHalfPanels; ++c)
        if (c == i) {
#pragma unroll
          for (int e = 0; e < 16; ++e) o_acc[c * 16 + e] += pv[e];
        }
    }
  }

  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = warp_q0 + g, r1 = r0 + 8;
  const int c0 = h * kCols + 2 * t4;   // o_acc[4c + e]: column c0 + 8c + e % 2
  if (splits > 1) {
    // unnormalised fp32 rows of this split, with their max and sum
    const size_t base = (static_cast<size_t>(split) * planes + plane) * rows_pad;
    float* po = part_o + base * kHeadDim;
#pragma unroll
    for (int c = 0; c < kCols / 8; ++c) {
      *reinterpret_cast<float2*>(po + static_cast<size_t>(r0) * kHeadDim + c0 + 8 * c) =
          make_float2(o_acc[4 * c], o_acc[4 * c + 1]);
      *reinterpret_cast<float2*>(po + static_cast<size_t>(r1) * kHeadDim + c0 + 8 * c) =
          make_float2(o_acc[4 * c + 2], o_acc[4 * c + 3]);
    }
    if (t4 == 0 && h == 0) {
      float* ml = part_ml + base * 2;
      *reinterpret_cast<float2*>(ml + 2 * r0) = make_float2(rows.m0, l0);
      *reinterpret_cast<float2*>(ml + 2 * r1) = make_float2(rows.m1, l1);
    }
    return;
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* ob = o + head * o_head + batch * o_batch + c0;
#pragma unroll
  for (int c = 0; c < kCols / 8; ++c) {
    if (r0 < q_len)
      *reinterpret_cast<float2*>(ob + r0 * o_row + 8 * c) =
          make_float2(o_acc[4 * c] * inv0, o_acc[4 * c + 1] * inv0);
    if (r1 < q_len)
      *reinterpret_cast<float2*>(ob + r1 * o_row + 8 * c) =
          make_float2(o_acc[4 * c + 2] * inv1, o_acc[4 * c + 3] * inv1);
  }
}

template <int kHeadDim, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Geometry* geometry, float* part_o, float* part_ml,
                   int rows_pad, int splits, int tiles_per_split, float scale_log2,
                   cudaStream_t stream) {
  using L = F32Layout<kHeadDim>;
  const Geometry& gq = geometry[0];
  const Geometry& gk = geometry[1];
  const Geometry& go = geometry[3];
  for (int i = 0; i < 4; ++i)
    if (geometry[i].dims[0] != static_cast<uint64_t>(kHeadDim)
        || geometry[i].dims[1] != gq.dims[1] || geometry[i].dims[3] != gq.dims[3]
        || geometry[i].dims[2] != (i == 0 || i == 3 ? gq : gk).dims[2]
        || geometry[i].box[0] != kPanelCols || geometry[i].box[2] != kRows)
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
  const uint64_t q_blocks = (q_len + kRows - 1) / kRows;
  const uint64_t blocks = q_blocks * planes * splits;
  if (blocks > INT32_MAX || rows_pad < 1 || static_cast<uint64_t>(rows_pad) != q_blocks * kRows)
    return cudaErrorInvalidValue;
  // o by element strides of the tensor map's coordinates (it is written from
  // registers; only its geometry is read)
  for (int i = 0; i < 3; ++i)
    if (go.strides[i] % 16) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_map(&map_q, q, geometry[0], kRows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = make_map(&map_k, k, geometry[1], kRows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = make_map(&map_v, v, geometry[2], kRows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  auto kernel = flash_f32_fwd_kernel<kHeadDim, kCausal>;
  // once per instantiation and device
  static int allowed_on = -1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess && allowed_on != device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmemBytes);
    if (err == cudaSuccess) allowed_on = device;
  }
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<float*>(o), static_cast<long long>(go.strides[0] / 4),
      static_cast<long long>(go.strides[1] / 4), static_cast<long long>(go.strides[2] / 4),
      part_o, part_ml, static_cast<int>(heads), static_cast<int>(q_len),
      static_cast<int>(q_blocks), static_cast<int>(planes), static_cast<int>(kv_len), splits,
      tiles_per_split, rows_pad, scale_log2);
  return cudaGetLastError();
}

#define FD_F32_CASE(D)                                                           \
  case D:                                                                        \
    return causal ? launch<D, true>(q, k, v, o, g, po, pml, rows_pad, splits,    \
                                    tiles_per_split, scale_log2, s)              \
                  : launch<D, false>(q, k, v, o, g, po, pml, rows_pad, splits,   \
                                     tiles_per_split, scale_log2, s);

}  // namespace

extern "C" {

// q [batch, heads, q_len, head_dim], k / v [batch, heads, kv_len, head_dim],
// o like q, fp32, as `geometry` (four Geometry records, q, k, v, o, each
// with 32-column, 64-row boxes and byte strides that are multiples of 16:
// ops/attention.py::wide_geometry at 4-byte elements) describes them.
// head_dim 64, 128, 192, 256, 320, 384, 448 or 512; `scale_log2` is the
// softmax scale times log2 e; `causal` masks top-left (needs q_len ==
// kv_len, which the wrapper checks). The kv_len tiles of 64 rows are split
// in `splits` ranges of `tiles_per_split` (ops/attention.py::f32_plan): with
// one split o is written; with more, part_o [splits, planes, rows_pad,
// head_dim] and part_ml [splits, planes, rows_pad, 2] (fp32) take the
// partials for fd_flash_attention_f32_merge. rows_pad must be the 64-row q
// blocks' rows, else nothing launches.
// Returns a cudaError_t code.
int fd_flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* o,
                               const void* geometry, void* part_o, void* part_ml,
                               int rows_pad, int head_dim, int splits,
                               int tiles_per_split, float scale_log2, int causal,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const Geometry*>(geometry);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  switch (head_dim) {
    FD_F32_CASE(64)
    FD_F32_CASE(128)
    FD_F32_CASE(192)
    FD_F32_CASE(256)
    FD_F32_CASE(320)
    FD_F32_CASE(384)
    FD_F32_CASE(448)
    FD_F32_CASE(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The splits' partials (as fd_flash_attention_f32_fwd wrote them) merged
// into fp32 o at element strides o_strides = (batch, head, row), unit
// columns (each a multiple of 4: 16-byte stores); planes = batch * heads,
// rows 0 ... q_len - 1 of each. The wide bf16 kernel's merge, with fp32
// output. Returns a cudaError_t code.
int fd_flash_attention_f32_merge(const void* part_o, const void* part_ml, void* o,
                                 const void* o_strides, int heads, int planes, int q_len,
                                 int rows_pad, int head_dim, int splits, void* stream) {
  const auto* st = static_cast<const long long*>(o_strides);
  if (st[0] % 4 || st[1] % 4 || st[2] % 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto* po = static_cast<const float*>(part_o);
  const auto* pml = static_cast<const float*>(part_ml);
  auto* ob = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define FD_MERGE_CASE(D)                                                                   \
  case D:                                                                                  \
    return static_cast<int>(fd_flash::launch_merge<D, float>(po, pml, ob, st, heads, planes, \
                                                             q_len, rows_pad, splits, s));
    FD_MERGE_CASE(64)
    FD_MERGE_CASE(128)
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
