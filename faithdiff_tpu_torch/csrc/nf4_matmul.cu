// NF4 dequant-matmul for Hopper (sm_90a): y[M, out] = x[M, in] . dequant(W)^T,
// x and y bf16, W NF4 half-row packed.
//
// Replaces: faithdiff_tpu/ops/nf4_matmul.py:73 _nf4_matvec_kernel (the Pallas
// TPU kernel launched by _nf4_matmul_fused_2d), which runs every LLaMA
// projection of the load_4bit captioner: (in, out) in {(5120, 5120) q/k/v/o,
// (5120, 13824) gate/up, (13824, 5120) down}, M = B * S at prefill, M = B
// at decode.
//
// What it computes (the TPU kernel's arithmetic): byte (o, c) of packed
// [out, in/2] holds element (o, c) of the [out, in] weight in its high nibble
// and (o, c + in/2) in its low nibble. Each nibble decodes through the
// 16-entry NF4 table, is multiplied by absmax[o, col / 64] in fp32 and
// rounded to bf16; the bf16 products are summed in fp32 and the sum is
// rounded to bf16. The decoded weight never goes to device memory.
//
// What bounds it on the card: at decode (M <= 8) bytes: the packed codes
// (in * out / 2) and absmax (in * out / 16) dwarf x and y, so one token
// of the 13B model streams ~7.1 GB, ~2.1 ms at 3.35 TB/s. At 3.35 TB/s an
// SM takes in ~14.5 bytes a clock, so a warp's 32 x 16-byte vectors leave
// ~140 instructions a lane per vector: the decode has to be cheap and no
// part of it may grow with M. At prefill (M ~ 640 per image) operations:
// 2 * M * in * out flops against ~0.56 bytes per weight, far above the
// ~295 flop/byte ridge.
//
// Two routes; ops/nf4_matmul.py plans them and passes the plan in:
// - nf4_gemv_kernel (decode, M <= 8): the product runs on tensor cores,
//   mma.sync m16n8k16 with A = 16 decoded weight rows x 16 k and B = 16 k
//   x 8 columns of x (columns m >= M zero), so M = 1 and M = 8 cost the
//   same decode work. A block owns 16 output rows over the whole K;
//   its warps split K by quads (64 packed bytes of a row), warp w taking
//   quads w, w + W, w + 2W, ..., a quad a step, so at a step the block
//   reads W x 64 contiguous bytes of each of its rows. Lane (g, t) of an
//   mma thread group holds 16-byte vector 4q + t of rows g and g + 8: a
//   dot product does not care about the order of k, so the mma's k slots
//   of lane t are that vector's columns (word j of the vector: high
//   nibbles in one mma, low nibbles in the next), and the B fragment is
//   gathered from x with the same permutation. The packed layout is not
//   rewritten. Each lane streams its packed vectors through a kStages-deep
//   ring of its own in shared memory with cp.async, so a warp has the next
//   three quads in flight while it decodes one, whatever its registers;
//   zero-filling copies stand in for rows past out_f and vectors past the
//   packed row. x is read once per block into shared memory: staged whole
//   at block start (wide coalesced copies into rows padded by 16 bytes)
//   for M >= 4 or up to 32 KB of x, else a piece a lane a step through the
//   same ring (ops/nf4_matmul.plan_nf4_gemv decides: timed both ways on an
//   H100, pieces of x cost most at M = 8, a large x staged before any work
//   most at M = 2-3 and in = 13824). All blocks read the same x, so block
//   b starts its warps at step b mod their step count. The block's absmax rows are staged once in shared
//   memory. Decode: the 16-entry fp32 table in shared memory at a
//   256-aligned address, its load address made by one PRMT from 4 x the
//   nibble; one fp32 multiply by the block's absmax; two results rounded
//   into one bf16x2 register. The warps' fp32 [16, 8] partial tiles are
//   folded in shared memory in warp order: one launch, no atomics, the
//   same bits on every run.
// - nf4_gemm_kernel (M > 8: the prefill, decode batches of 9+ images). What
//   bounds it: operations from M ~ 85 rows of x on (2 * M flops a weight
//   against ~0.56 bytes of codes and scales a weight, the ~295 flop/byte
//   ridge), so the tensor cores have to stay fed and the decode must not
//   grow with M. A block owns 128 weight rows x n_tile rows of x (16..256,
//   ops/nf4_matmul.plan_nf4_gemm picks it by waves on 132 SMs) over the
//   whole K and computes y^T = W . x^T for them: two consumer warpgroups of
//   64 weight rows multiply with wgmma m64nNk16, A (the decoded weights) in
//   registers and B (x) read from shared memory as the K-major operand, and
//   one producer warp keeps a ring of 2-4 stages full on mbarriers. A K step
//   is 64 packed bytes of a row: the producer brings in by TMA the x box of
//   its 64 high-nibble columns and that of its 64 low-nibble columns (two
//   maps over x's halves, so columns past a half read as zeros: the ragged
//   last step of in = 64 or 576), the block's [128, 64] packed bytes, and by
//   cp.async the rows' scales of the step (the low half's first two blocks
//   where it starts mid-block). A consumer lane decodes its A fragments
//   (rows g and g + 8, k = 2t, 2t+1, 2t+8, 2t+9 of each 16-column chunk)
//   straight into registers: the same packed bytes give the high-nibble and
//   the low-nibble chunk; the table lookup is the decode route's (fp32
//   table at a 256-aligned address, one PRMT per load address, one fp32
//   multiply, two results rounded into one bf16x2), so each weight is
//   decoded once per n_tile rows of x and no decoded weight is ever
//   written to shared or device memory. (A table of a row's 16 scaled
//   bf16 codes built in registers each step and looked up with PRMT, no
//   shared loads, ran 3-7% slower at M = 640 and 1244 on an NVIDIA H100
//   80GB HBM3 at 700 W: 31% more instructions.) The next step is decoded
//   while the current step's wgmmas run. The epilogue rounds to bf16 and
//   goes through shared memory to leave as rows of y. Rows past M or out_f
//   read zeros and are not stored. One block an output tile over all of K:
//   the same bits on every call.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace fd_hopper;

__constant__ float kCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr int kBlock = 64;      // elements per absmax block

// ---------------------------------------------------------------- M <= 8
constexpr int kGemvMaxM = 8;
constexpr int kGemvWarps = 8;   // a block: 8 warps split K
constexpr int kGemvRows = 16;   // a block: one 16-row mma tile
constexpr int kQuadBytes = 64;  // packed bytes of a row per quad: 4 lanes x 16
constexpr int kStages = 4;      // K steps (quads) in flight in a warp's ring

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// word j of a vector (j a compile-time constant after unrolling, so the
// vector stays in registers)
__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// d += a . b, one m16n8k16 bf16 product with fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// code[n] * s for the nibble whose 4 * n is byte i of `idx4`: one PRMT puts
// that byte under the table's 256-aligned shared address, one load
template <int I>
__device__ __forceinline__ float scaled_code(uint32_t idx4, uint32_t table, float s) {
  return lds32(__byte_perm(idx4, table, 0x7650 | I)) * s;
}

// the four high or low nibbles of a 4-byte word, decoded and scaled,
// rounded to bf16 pairs: bytes (0, 1) and (2, 3)
template <bool kHigh>
__device__ __forceinline__ void decode_word(uint32_t word, uint32_t table, float s,
                                            uint32_t& p01, uint32_t& p23) {
  const uint32_t idx4 = (kHigh ? word >> 2 : word << 2) & 0x3C3C3C3Cu;
  __nv_bfloat162 h01 = __floats2bfloat162_rn(scaled_code<0>(idx4, table, s),
                                             scaled_code<1>(idx4, table, s));
  __nv_bfloat162 h23 = __floats2bfloat162_rn(scaled_code<2>(idx4, table, s),
                                             scaled_code<3>(idx4, table, s));
  p01 = *reinterpret_cast<uint32_t*>(&h01);
  p23 = *reinterpret_cast<uint32_t*>(&h23);
}

// cp.async of 16 bytes, or of zeros where `copy` is false (src-size 0)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

// A lane's rows g (r = 0) and g + 8 (r = 1) of the block: where its packed
// row starts (at the lane's 16-byte column within a quad), whether the row
// exists, and where its scales sit in shared memory
struct LaneRows {
  const uint8_t* packed[2];
  uint32_t scales[2];
  bool ok[2];
};

// Issues one K step (quad) into a ring stage: the lane's packed vectors of
// its rows (zeros for a row past out_f or a vector past the packed row)
// and, unless x is staged whole, for lanes with g < M row g's 16 high and
// 16 low columns of x at its vector (4 x 16 bytes)
template <bool kXWhole>
__device__ __forceinline__ void issue_step(uint32_t wst, uint32_t xst, const LaneRows& lr,
                                           const bf16* xr, int half, int m, bool use_x,
                                           int quad, int vec, int n_vec) {
  const bool vec_ok = vec < n_vec;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    cp_async16_or_zero(wst + r * 32 * 16, lr.packed[r] + quad * kQuadBytes, lr.ok[r] && vec_ok);
  if (!kXWhole && use_x) {
#pragma unroll
    for (int c = 0; c < 4; ++c)       // high 0-7, high 8-15, low 0-7, low 8-15
      cp_async16_or_zero(xst + c * 4 * m * 16,
                         xr + (c / 2) * half + 16 * (vec_ok ? vec : 0) + 8 * (c % 2), vec_ok);
  }
}

template <bool kFull, bool kXWhole>
__device__ __forceinline__ void mma_step(float (&acc)[4], const LaneRows& lr, uint32_t table,
                                         uint32_t wst, uint32_t xst, uint32_t x_row, int half,
                                         int m, bool use_x, int quad, int lo_blk,
                                         bool vec_ok) {
  // B fragments: x row g at the lane's 16 high and 16 low columns; zero
  // for rows m >= M (and, x staged whole, for a vector past the packed row)
  uint4 bh[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  uint4 bl[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (kXWhole) {
    if (use_x && (kFull || vec_ok)) {
      const uint32_t p = x_row + 2 * quad * kQuadBytes;   // x_row: row g at the lane's column
      bh[0] = lds128(p);
      bh[1] = lds128(p + 16);
      bl[0] = lds128(p + 2 * half);
      bl[1] = lds128(p + 2 * half + 16);
    }
  } else if (use_x) {
    const uint32_t chunk = 4 * m * 16;
    bh[0] = lds128(xst);
    bh[1] = lds128(xst + chunk);
    bl[0] = lds128(xst + 2 * chunk);
    bl[1] = lds128(xst + 3 * chunk);
  }
  const uint4 w0 = lds128(wst);
  const uint4 w8 = lds128(wst + 32 * 16);
  // (high, low) scales of rows g and g + 8; a vector past the packed row
  // (zero codes, zero x) gets zero scales, so its weights decode to zero
  float2 s0 = make_float2(0.f, 0.f), s8 = make_float2(0.f, 0.f);
  if (kFull || vec_ok) {
    s0 = make_float2(lds32(lr.scales[0] + 4 * quad), lds32(lr.scales[0] + 4 * lo_blk));
    s8 = make_float2(lds32(lr.scales[1] + 4 * quad), lds32(lr.scales[1] + 4 * lo_blk));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // x columns 4j .. 4j+3 of the lane's 16: words 2j, 2j+1 of its 32 bytes
    const uint4& xh = bh[j / 2];
    const uint4& xl = bl[j / 2];
    uint32_t a0, a1, a2, a3;
    decode_word<true>(word_of(w0, j), table, s0.x, a0, a2);    // row g, high nibbles
    decode_word<true>(word_of(w8, j), table, s8.x, a1, a3);    // row g + 8
    mma_bf16(acc, a0, a1, a2, a3, word_of(xh, 2 * (j % 2)), word_of(xh, 2 * (j % 2) + 1));
    decode_word<false>(word_of(w0, j), table, s0.y, a0, a2);   // low nibbles
    decode_word<false>(word_of(w8, j), table, s8.y, a1, a3);
    mma_bf16(acc, a0, a1, a2, a3, word_of(xl, 2 * (j % 2)), word_of(xl, 2 * (j % 2) + 1));
  }
}

// scales row stride in shared memory: odd, so the 8 rows of a thread
// group's load fall in 8 banks
__host__ __device__ constexpr int scale_stride(int n_blk) { return n_blk | 1; }

// the block's scales in shared memory, padded to 16 bytes
__host__ __device__ constexpr int scale_bytes(int in_f) {
  return (kGemvRows * scale_stride(in_f / kBlock) * 4 + 15) / 16 * 16;
}

// shared memory of one warp's ring: kStages x (2 packed vectors x 32 lanes
// + unless x is staged whole, 4 pieces of x x 4 M lanes) x 16 bytes
__host__ __device__ constexpr int ring_bytes(int m, bool x_whole) {
  return kStages * (2 * 32 + (x_whole ? 0 : 4 * 4 * m)) * 16;
}

// x staged whole: m rows of in_f bf16, each padded by 16 bytes so the
// thread groups' 16-byte reads of rows g and g + 1 fall in other banks
__host__ __device__ constexpr int x_whole_bytes(int m, int in_f) { return m * (2 * in_f + 16); }

// at most 64 registers a lane (4 blocks an SM's registers hold): on an
// H100 the decode ran as fast capped at 64 as at 85 or 128
template <bool kFull, bool kXWhole>
__global__ void __launch_bounds__(kGemvWarps * 32, 4)
nf4_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ absmax, bf16* __restrict__ y,
                int m, int in_f, int out_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the code table at a 256-aligned address: decode_word builds a load
  // address from the table's upper bytes and 4 * nibble in the lowest
  __shared__ __align__(256) float s_code[16];
  if (threadIdx.x < 16) s_code[threadIdx.x] = kCode[threadIdx.x];
  const uint32_t table = static_cast<uint32_t>(__cvta_generic_to_shared(s_code));
  if (table & 0xffu) __trap();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int half = in_f / 2;
  const int n_vec = half / 16;
  const int n_blk = in_f / kBlock;
  const int stride = scale_stride(n_blk);
  const int row0 = blockIdx.x * kGemvRows;
  const int quads = (half + kQuadBytes - 1) / kQuadBytes;
  // warp w takes quads w, w + W, w + 2W, ...: at a step the block's warps
  // read W x 64 contiguous bytes of each of its rows
  const int steps = warp < quads ? (quads - warp + kGemvWarps - 1) / kGemvWarps : 0;
  // every block reads the same x: blocks start their warps at different
  // steps, so the L2 lines of x a step asks for differ from block to block
  const int rot = steps > 0 ? blockIdx.x % steps : 0;
  const bool use_x = g < m;
  // the lane's low-nibble scale for quad q is block q + lo_off
  const int lo_off = (half + 16 * tig) / kBlock;

  // shared memory: the block's scales [rows][stride] f32, x when staged
  // whole, then the warps' rings, each stage 2 x 32 packed vectors then
  // (unless x is whole) 4 x 4 M pieces of x, every lane's entries its own;
  // after the loop the fold's partial tiles overlay all of it
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t x_base = sbase + scale_bytes(in_f);
  const uint32_t stage_bytes = ring_bytes(m, kXWhole) / kStages;
  const uint32_t ring = x_base + (kXWhole ? x_whole_bytes(m, in_f) : 0) +
                        warp * ring_bytes(m, kXWhole);
  const uint32_t w_lane = ring + lane * 16;
  const uint32_t x_lane = ring + 2 * 32 * 16 + lane * 16;

  LaneRows lr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lrow = g + 8 * r;
    lr.ok[r] = kFull || row0 + lrow < out_f;
    lr.packed[r] = packed + static_cast<size_t>(lr.ok[r] ? row0 + lrow : 0) * half + 16 * tig;
    lr.scales[r] = sbase + lrow * stride * 4;
  }
  const bf16* xr = x + static_cast<size_t>(use_x ? g : 0) * in_f;
  const uint32_t x_row = x_base + (use_x ? g : 0) * (2 * in_f + 16) + 32 * tig;

  // the first kStages - 1 steps go out before anything else, so device
  // memory is busy while the scales and x arrive
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) {
      const int quad = warp + kGemvWarps * ((i + rot) % steps);
      issue_step<kXWhole>(w_lane + i * stage_bytes, x_lane + i * stage_bytes, lr, xr, half, m,
                          use_x, quad, 4 * quad + tig, n_vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (kXWhole) {        // x once, 16 bytes a thread a turn, coalesced
    const int per_row = in_f / 8;
    for (int i = threadIdx.x; i < m * per_row; i += kGemvWarps * 32) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * in_f) + c);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(x_base + r * (2 * in_f + 16) + 16 * c), "r"(v.x), "r"(v.y), "r"(v.z),
                   "r"(v.w) : "memory");
    }
  }
  float* sc = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < kGemvRows * n_blk; i += kGemvWarps * 32) {
    const int r = i / n_blk;
    const int b = i - r * n_blk;
    sc[r * stride + b] = kFull || row0 + r < out_f
                             ? __ldg(absmax + static_cast<size_t>(row0) * n_blk + i) : 0.f;
  }
  __syncthreads();     // the code table, the scales and a whole x

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int ahead = s + kStages - 1;
    if (ahead < steps) {
      const uint32_t st = (ahead % kStages) * stage_bytes;
      const int quad = warp + kGemvWarps * ((ahead + rot) % steps);
      issue_step<kXWhole>(w_lane + st, x_lane + st, lr, xr, half, m, use_x, quad,
                          4 * quad + tig, n_vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const uint32_t st = (s % kStages) * stage_bytes;
    const int quad = warp + kGemvWarps * ((s + rot) % steps);
    mma_step<kFull, kXWhole>(acc, lr, table, w_lane + st, x_lane + st, x_row, half, m, use_x,
                             quad, quad + lo_off, 4 * quad + tig < n_vec);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // fold: the warps' [16, 8] partial tiles, summed in warp order
  __syncthreads();     // the partials overlay the scales, x and the rings
  float* part = reinterpret_cast<float*>(smem);
  float* p = part + (warp * kGemvRows + g) * kGemvMaxM + 2 * tig;
  *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  *reinterpret_cast<float2*>(p + 8 * kGemvMaxM) = make_float2(acc[2], acc[3]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * kGemvRows; idx += kGemvWarps * 32) {
    const int mm = idx / kGemvRows;
    const int r = idx - mm * kGemvRows;
    if (row0 + r >= out_f) continue;
    float sum = 0.f;
    for (int w = 0; w < kGemvWarps; ++w) sum += part[(w * kGemvRows + r) * kGemvMaxM + mm];
    y[static_cast<size_t>(mm) * out_f + row0 + r] = __float2bfloat16(sum);
  }
}

// ---------------------------------------------------------------- M > 8
constexpr int kGemmRows = 128;               // weight rows a block: two warpgroups of 64
constexpr int kGemmConsumers = 2;
constexpr int kGemmThreads = (kGemmConsumers + 1) * 128;   // + the producer warpgroup
constexpr int kStepBytes = 64;               // packed bytes of a row a K step
constexpr int kXRowBytes = 128;              // a row of an x box: 64 bf16, the 128-byte swizzle
constexpr int kPackedBytes = kGemmRows * kStepBytes;
constexpr int kScaleRowBytes = 16;           // a row's (high, low, next low, -) f32 scales
constexpr int kScaleBytes = kGemmRows * kScaleRowBytes;
constexpr int kEpiPitch = 272;               // bytes of a y row in the epilogue's transpose
constexpr int kGemmProducerRegs = 40;
constexpr int kGemmConsumerRegs = 232;       // 2 * 232 + 40 = 504 = 3 * 168
constexpr int kGemmSmemLimit = 227 * 1024 - 1024;   // dynamic; the rest for the code table

// A ring stage: the x box of the step's high-nibble columns and that of its
// low-nibble columns ([n rows][64 cols] bf16 each, 128-byte swizzle), the
// block's packed bytes of the step ([128 rows][64 bytes], 64-byte swizzle)
// and its rows' scales. Every offset is a multiple of 1024.
__host__ __device__ constexpr int gemm_stage_bytes(int n) {
  return 2 * n * kXRowBytes + kPackedBytes + kScaleBytes;
}

// dynamic shared memory: 1024 bytes of alignment slack, the ring, and a full
// and an empty mbarrier a stage; the epilogue's transpose overlays the ring
__host__ __device__ constexpr int gemm_smem_bytes(int n, int stages) {
  return 1024 + stages * gemm_stage_bytes(n) + 16 * stages;
}

__device__ __forceinline__ uint32_t lds32u(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds128f(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// cp.async of 4 bytes, or a zero where `copy` is false (src-size 0)
__device__ __forceinline__ void cp_async4_or_zero(uint32_t dst, const void* src, bool copy) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(copy ? 4 : 0) : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The descriptor of the operand `bytes` further on in shared memory than the
// one `d` describes: only the start address field (16-byte units, the low
// 14 bits) moves, and a shared address stays below 2^18, so a 32-bit add on
// the low word does it (where a descriptor built anew costs ~6 instructions)
__device__ __forceinline__ uint64_t desc_plus(uint64_t d, uint32_t bytes) {
  const uint32_t lo = static_cast<uint32_t>(d) + (bytes >> 4);
  return (d & 0xFFFFFFFF00000000ull) | lo;
}

// acc (+)= A . B^T over the tile's kN rows of x (B K-major in shared memory,
// 128-byte rows, `b` the descriptor of its first row), as wgmma widths 128,
// 64, 32, 16, widest first; the accumulator fragments of the pieces lie one
// after another in acc
template <int kN, int kDone = 0>
__device__ __forceinline__ void wgmma_x_rows(float (&acc)[kN / 2], const uint32_t (&a)[4],
                                             uint64_t b) {
  constexpr int kLeft = kN - kDone;
  if constexpr (kLeft > 0) {
    constexpr int kW = kLeft >= 128 ? 128 : kLeft >= 64 ? 64 : kLeft >= 32 ? 32 : 16;
    const uint64_t desc = desc_plus(b, kDone * kXRowBytes);
    float* d = acc + kDone / 2;
    if constexpr (kW == 128)
      wgmma_rs_kmajor_n128(*reinterpret_cast<float(*)[64]>(d), a[0], a[1], a[2], a[3], desc);
    else if constexpr (kW == 64)
      wgmma_rs_kmajor_n64(*reinterpret_cast<float(*)[32]>(d), a[0], a[1], a[2], a[3], desc);
    else if constexpr (kW == 32)
      wgmma_rs_kmajor_n32(*reinterpret_cast<float(*)[16]>(d), a[0], a[1], a[2], a[3], desc);
    else
      wgmma_rs_kmajor_n16(*reinterpret_cast<float(*)[8]>(d), a[0], a[1], a[2], a[3], desc);
    wgmma_x_rows<kN, kDone + kW>(acc, a, b);
  }
}

// The A fragments of one K step for lane (g, t) of a consumer warp: rows
// `row` and row + 8 of the block (g and g + 8 of the warp's 16), at k = 2t,
// 2t+1 (a0, a1) and 2t+8, 2t+9 (a2, a3) of each 16-column chunk j:
// a[4j ..] the high-nibble chunks (x columns c0 + 16j ..), a[16 + 4j ..] the
// low-nibble ones (in/2 + c0 + 16j ..). The four packed bytes a lane needs
// of a chunk (2t, 2t+1, 2t+8, 2t+9) come from two 32-bit loads and one PRMT;
// the 64-byte swizzle of the packed box moves chunk j of row r to chunk
// j ^ ((r >> 1) & 3), which puts a warp's 8 rows in 16 different banks.
__device__ __forceinline__ void decode_step(uint32_t (&a)[32], uint32_t packed, uint32_t scales,
                                            uint32_t table, int row, int t, bool lo_split) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row + 8 * rr;
    const float4 sc = lds128f(scales + r * kScaleRowBytes);
    const uint32_t base = packed + r * kStepBytes + 4 * (t >> 1);
    const int sw = (r >> 1) & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t chunk = base + ((j ^ sw) << 4);
      const uint32_t w = __byte_perm(lds32u(chunk), lds32u(chunk + 8),
                                     (t & 1) ? 0x7632 : 0x5410);
      // the low half starts mid-block when in / 2 % 64 == 32: its chunks
      // 2 and 3 then belong to the next block
      const float s_lo = (lo_split && j >= 2) ? sc.z : sc.y;
      decode_word<true>(w, table, sc.x, a[4 * j + rr], a[4 * j + 2 + rr]);
      decode_word<false>(w, table, s_lo, a[16 + 4 * j + rr], a[16 + 4 * j + 2 + rr]);
    }
  }
}

// One K step of a consumer warpgroup: the step's 8 wgmmas (4 high-nibble
// and 4 low-nibble chunks) from a[kBuf], and while they run the next step's
// A fragments decoded into a[kBuf ^ 1]; the stage is released once the
// wgmmas that read it are done.
template <int kN, int kBuf>
__device__ __forceinline__ void consume_step(float (&acc)[kN / 2], uint32_t (&a)[2][32],
                                             int s, int steps, int stages, uint32_t ring,
                                             uint32_t bar_full, uint32_t bar_empty,
                                             uint32_t table, int row, int t, int lane,
                                             bool lo_split) {
  constexpr uint32_t kStage = gemm_stage_bytes(kN);
  const uint32_t st = ring + (s % stages) * kStage;
  const uint64_t x_desc = smem_desc(st, 16, 1024);
  fence_registers(acc);
  fence_registers(a[kBuf]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t(&frag)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[kBuf][4 * j]);
    // chunk j % 4 of the high (j < 4) or the low x box: 32 bytes a chunk
    wgmma_x_rows<kN>(acc, frag, desc_plus(x_desc, (j / 4) * kN * kXRowBytes + (j % 4) * 32));
  }
  wgmma_commit();
  if (s + 1 < steps) {
    const int nxt = (s + 1) % stages;
    mbar_wait(bar_full + 8 * nxt, ((s + 1) / stages) & 1);
    const uint32_t nst = ring + nxt * kStage;
    decode_step(a[kBuf ^ 1], nst + 2 * kN * kXRowBytes, nst + 2 * kN * kXRowBytes + kPackedBytes,
                table, row, t, lo_split);
  }
  wgmma_wait<0>();
  fence_registers(acc);
  fence_registers(a[kBuf]);
  if (lane == 0) mbar_arrive(bar_empty + 8 * (s % stages));
}

// The prefill route. A block owns 128 weight rows (two consumer warpgroups
// of 64) x kN rows of x over all of K and computes y^T for them: block b
// takes weight tile b / m_tiles and x tile b % m_tiles, so the blocks in
// flight share a few weight tiles in L2.
template <int kN>
__global__ void __launch_bounds__(kGemmThreads, 1)
nf4_gemm_kernel(const __grid_constant__ CUtensorMap map_xh,
                const __grid_constant__ CUtensorMap map_xl,
                const __grid_constant__ CUtensorMap map_w, const float* __restrict__ absmax,
                bf16* __restrict__ y, int m, int in_f, int out_f, int m_tiles, int stages,
                int full) {
  static_assert(kN % 16 == 0 && kN >= 16 && kN <= 256, "x rows a tile");
  constexpr uint32_t kStage = gemm_stage_bytes(kN);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(256) float s_code[16];
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - smem_u32(smem_raw));
  const uint32_t bar_full = s_base + stages * kStage;
  const uint32_t bar_empty = bar_full + 8 * stages;

  const int tid = threadIdx.x;
  const int group = tid / 128;
  const int half = in_f / 2;
  const int n_blk = in_f / kBlock;
  const int steps = (half + kStepBytes - 1) / kStepBytes;
  const int w_tile = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x - w_tile * m_tiles) * kN;
  const int row0 = w_tile * kGemmRows;

  if (tid < 16) s_code[tid] = kCode[tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);      // the TMA bytes' arrival + 32 lanes' scales
      mbar_init(bar_empty + 8 * s, kGemmConsumers * 4);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (group == kGemmConsumers) {
    // ---- producer: one warp keeps the ring full ----
    setmaxnreg_dec<kGemmProducerRegs>();
    if (tid < kGemmConsumers * 128 + 32) {
      const int lane = tid % 32;
      for (int s = 0; s < steps; ++s) {
        const int stage = s % stages;
        mbar_wait(bar_empty + 8 * stage, ((s / stages) & 1) ^ 1);   // passes on a fresh ring
        const uint32_t full_bar = bar_full + 8 * stage;
        const uint32_t st = s_base + stage * kStage;
        if (lane == 0) {
          mbar_expect_tx(full_bar, 2 * kN * kXRowBytes + kPackedBytes);
          tma_load_2d(st, &map_xh, full_bar, s * kStepBytes, m0);
          tma_load_2d(st + kN * kXRowBytes, &map_xl, full_bar, s * kStepBytes, m0);
          tma_load_2d(st + 2 * kN * kXRowBytes, &map_w, full_bar, s * kStepBytes, row0);
        }
        // the scales of the step: block s for the high columns, the blocks
        // of the low columns' first and (if it starts mid-block) next 32;
        // zeros past out_f or past the row's blocks
        const int lo = (half + s * kStepBytes) / kBlock;
        const uint32_t sc = st + 2 * kN * kXRowBytes + kPackedBytes;
#pragma unroll
        for (int i = 0; i < kGemmRows / 32; ++i) {
          const int r = lane + 32 * i;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int blk = c == 0 ? s : lo + c - 1;
            const bool ok = row0 + r < out_f && blk < n_blk;
            cp_async4_or_zero(sc + r * kScaleRowBytes + 4 * c,
                              absmax + (ok ? static_cast<size_t>(row0 + r) * n_blk + blk : 0),
                              ok);
          }
        }
        cp_async_arrive_noinc(full_bar);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumers: 64 weight rows a warpgroup ----
    setmaxnreg_inc<kGemmConsumerRegs>();
    const int gtid = tid % 128;
    const int warp = gtid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row = group * 64 + warp * 16 + g;     // block rows row, row + 8
    const uint32_t table = smem_u32(s_code);
    const bool lo_split = half % kBlock != 0;

    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    uint32_t a[2][32];
    mbar_wait(bar_full, 0);
    decode_step(a[0], s_base + 2 * kN * kXRowBytes, s_base + 2 * kN * kXRowBytes + kPackedBytes,
                table, row, t, lo_split);
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {
      consume_step<kN, 0>(acc, a, s, steps, stages, s_base, bar_full, bar_empty, table, row, t,
                          lane, lo_split);
      if (s + 1 < steps)
        consume_step<kN, 1>(acc, a, s + 1, steps, stages, s_base, bar_full, bar_empty, table,
                            row, t, lane, lo_split);
    }

    // epilogue: y^T fragments -> bf16 [kN rows of x][128 weight rows] in
    // shared memory (over the ring, which no one reads any more), then out
    // as rows of y, 16 bytes a thread where the row holds them
    named_barrier_sync(1, kGemmConsumers * 128);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      // fragment i: x row 8 (i / 4) + 2t + i % 2, weight row `row` (+ 8)
      const int n = 8 * (i / 4) + 2 * t + (i & 1);
      const int r = row + 8 * ((i >> 1) & 1);
      *reinterpret_cast<bf16*>(smem + n * kEpiPitch + 2 * r) = __float2bfloat16(acc[i]);
    }
    named_barrier_sync(1, kGemmConsumers * 128);
    const int ctid = tid;                            // 0 .. 255
    const bool vec = out_f % 8 == 0;
    for (int idx = ctid; idx < kN * (kGemmRows / 8); idx += kGemmConsumers * 128) {
      const int n = idx / (kGemmRows / 8);
      const int v = idx - n * (kGemmRows / 8);
      const int gm = m0 + n;
      const int col = row0 + 8 * v;
      if (!full && gm >= m) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(smem + n * kEpiPitch + 16 * v);
      bf16* dst = y + static_cast<size_t>(gm) * out_f + col;
      if (full || (vec && col + 8 <= out_f)) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        const uint32_t words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (col + k < out_f)
            dst[k] = __ushort_as_bfloat16(static_cast<unsigned short>(words[k / 2] >> (16 * (k % 2))));
      }
    }
  }
}

// the x rows a tile the entry point takes: every multiple of 16 up to 256
// (ops/nf4_matmul.GEMM_N_TILES)
template <int kN>
cudaError_t launch_gemm(const void* x, const void* packed, const void* absmax, void* y, int m,
                        int in_f, int out_f, int m_tiles, int stages, int grid, int smem, int full,
                        cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int half = in_f / 2;
  CUtensorMap maps[3];
  // x's high and low halves: [m rows][in/2 cols] each, rows in_f apart, a
  // box of 64 columns x kN rows; W: [out rows][in/2 bytes], a box of 64 x
  // 128. What lies past an extent reads as zeros.
  const void* bases[3] = {x, static_cast<const bf16*>(x) + half, packed};
  for (int i = 0; i < 3; ++i) {
    const bool w = i == 2;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(half),
                                static_cast<cuuint64_t>(w ? out_f : m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w ? half : 2 * in_f)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStepBytes),
                               static_cast<cuuint32_t>(w ? kGemmRows : kN)};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(
        &maps[i], w ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(bases[i]), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        w ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  constexpr int kMaxDevices = 64;
  static int smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_allowed[dev]) {
    e = cudaFuncSetAttribute(nf4_gemm_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_allowed[dev] = smem;
  }
  nf4_gemm_kernel<kN><<<grid, kGemmThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(absmax), static_cast<bf16*>(y), m,
      in_f, out_f, m_tiles, stages, full);
  return cudaGetLastError();
}

template <bool kFull, bool kXWhole>
cudaError_t launch_gemv(const void* x, const void* packed, const void* absmax, void* y,
                        int m, int in_f, int out_f, int grid, int smem, cudaStream_t stream) {
  // the dynamic shared memory this instance may take on each device: the
  // attribute acts on the current device, so it is raised once per device
  constexpr int kMaxDevices = 64;
  static int smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_allowed[dev]) {
    e = cudaFuncSetAttribute(nf4_gemv_kernel<kFull, kXWhole>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_allowed[dev] = smem;
  }
  nf4_gemv_kernel<kFull, kXWhole><<<grid, kGemvWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<bf16*>(y), m, in_f, out_f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The decode route. x: contiguous bf16 [m, in_f], 1 <= m <= 8; packed:
// uint8 [out_f, in_f / 2] (half-row); absmax: f32 [out_f, in_f / 64]; y:
// bf16 [m, out_f]. The launch numbers are ops/nf4_matmul.plan_nf4_gemv's:
// full (no row past out_f, no partial last quad), x_whole (x staged whole
// at block start, not a piece a lane a step), grid (16 rows a block) and
// dynamic shared memory bytes; they are checked against the shape (grid
// exactly ceil(out_f / 16)) and the shared-memory layout above. All
// pointers 16-byte aligned. Returns a cudaError_t code.
int fd_nf4_gemv(const void* x, const void* packed, const void* absmax, void* y,
                int m, int in_f, int out_f, int full, int x_whole, int grid, int smem,
                void* stream) {
  const long need = scale_bytes(in_f) + kGemvWarps * ring_bytes(m, x_whole) +
                    (x_whole ? x_whole_bytes(m, in_f) : 0);
  const long fold_bytes = 4L * kGemvWarps * kGemvRows * kGemvMaxM;
  if (m < 1 || m > kGemvMaxM || out_f <= 0 || in_f <= 0 || in_f % kBlock ||
      grid != (out_f + kGemvRows - 1) / kGemvRows || smem < need || smem < fold_bytes ||
      (full && (out_f % kGemvRows || (in_f / 2) % kQuadBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (full)
    e = x_whole ? launch_gemv<true, true>(x, packed, absmax, y, m, in_f, out_f, grid, smem, s)
                : launch_gemv<true, false>(x, packed, absmax, y, m, in_f, out_f, grid, smem, s);
  else
    e = x_whole ? launch_gemv<false, true>(x, packed, absmax, y, m, in_f, out_f, grid, smem, s)
                : launch_gemv<false, false>(x, packed, absmax, y, m, in_f, out_f, grid, smem, s);
  return static_cast<int>(e);
}

// The prefill route. Same operands as fd_nf4_gemv, any m >= 1. The launch
// numbers are ops/nf4_matmul.plan_nf4_gemm's: n_tile (x rows a block, a
// multiple of 16 up to 256), stages (of the ring), grid (exactly
// ceil(out_f / 128) * ceil(m / n_tile)), dynamic shared memory bytes (at
// least the ring and its barriers, at most what a block may have) and full
// (no row of x past m and no weight row past out_f in any tile: the
// epilogue stores unmasked). A launch that disagrees with the shape is
// refused. Returns a cudaError_t code.
int fd_nf4_gemm(const void* x, const void* packed, const void* absmax, void* y,
                int m, int in_f, int out_f, int n_tile, int stages, int grid, int smem,
                int full, void* stream) {
  if (m <= 0 || out_f <= 0 || in_f <= 0 || in_f % kBlock || n_tile < 16 || n_tile > 256 ||
      n_tile % 16 || stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long m_tiles = (m + n_tile - 1) / n_tile;
  const long w_tiles = (out_f + kGemmRows - 1) / kGemmRows;
  const bool is_full = out_f % kGemmRows == 0 && m % n_tile == 0;
  if (grid != m_tiles * w_tiles || smem < gemm_smem_bytes(n_tile, stages) ||
      smem > kGemmSmemLimit || (full != 0) != is_full)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
#define FD_GEMM_CASE(N)                                                                  \
    case N:                                                                              \
      return static_cast<int>(launch_gemm<N>(x, packed, absmax, y, m, in_f, out_f,       \
                                             static_cast<int>(m_tiles), stages, grid,    \
                                             smem, full, s));
    FD_GEMM_CASE(16) FD_GEMM_CASE(32) FD_GEMM_CASE(48) FD_GEMM_CASE(64)
    FD_GEMM_CASE(80) FD_GEMM_CASE(96) FD_GEMM_CASE(112) FD_GEMM_CASE(128)
    FD_GEMM_CASE(144) FD_GEMM_CASE(160) FD_GEMM_CASE(176) FD_GEMM_CASE(192)
    FD_GEMM_CASE(208) FD_GEMM_CASE(224) FD_GEMM_CASE(240) FD_GEMM_CASE(256)
#undef FD_GEMM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
