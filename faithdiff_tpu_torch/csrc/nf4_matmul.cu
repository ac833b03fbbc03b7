// NF4 dequant-matmul for Hopper (sm_90a): y[M, out] = x[M, in] . dequant(W)^T,
// x and y bf16, W NF4 half-row packed.
//
// Replaces: faithdiff_tpu/ops/nf4_matmul.py::_nf4_matvec_kernel (the Pallas
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
// - nf4_gemm_kernel (M > 8, the prefill): a tiled product. A block of 8
//   warps owns a 64 x 128 output tile and walks the packed columns 32
//   bytes at a time (= 64 weight columns: 32 from the high nibbles, 32
//   from the low). Per step it decodes the [128, 64] weight tile into
//   shared memory as bf16, stages the matching x columns, and multiplies
//   with WMMA 16x16x16 bf16 fragments into fp32 accumulators (each warp
//   32 x 32). No cp.async / TMA / wgmma yet: loads are not overlapped with
//   the tensor-core work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

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
constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kStepBytes = 32;                 // packed columns per step
constexpr int kStepK = 2 * kStepBytes;         // weight columns per step
constexpr int kTileWarps = 8;                  // 2 (M) x 4 (N), 32 x 32 each
constexpr int kTileThreads = kTileWarps * 32;
// padded rows: 144-byte bf16 rows and 528-byte fp32 rows keep 16-byte
// stores and 32-byte WMMA tile pointers aligned and spread the banks
constexpr int kLdh = kStepK + 8;
constexpr int kLdc = kTileN + 4;
constexpr int kXBytes = kTileM * kLdh * 2;
constexpr int kWBytes = kTileN * kLdh * 2;
constexpr int kCBytes = kTileM * kLdc * 4;
constexpr int kSmemBytes = (kXBytes + kWBytes > kCBytes) ? kXBytes + kWBytes : kCBytes;

__global__ void __launch_bounds__(kTileThreads)
nf4_gemm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ absmax, bf16* __restrict__ y,
                int m_rows, int in_f, int out_f) {
  // x and W tiles during the main loop; the fp32 output tile afterwards
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float s_code[16];
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  bf16* s_w = reinterpret_cast<bf16*>(smem + kXBytes);
  float* s_c = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 4) * 32;              // warp's rows in the tile
  const int wn = (warp % 4) * 32;              // warp's columns in the tile
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int half = in_f / 2;
  const int n_blk = in_f / kBlock;
  if (tid < 16) s_code[tid] = kCode[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < half; c0 += kStepBytes) {
    __syncthreads();   // the previous step's tiles are no longer read
    // x: row r, columns [c0, c0 + 32) then [half + c0, half + c0 + 32)
    for (int idx = tid; idx < kTileM * 8; idx += kTileThreads) {
      const int r = idx / 8;
      const int part = idx % 8;              // 8 vectors of 8 bf16 per row
      const int col = (part < 4) ? c0 + part * 8 : half + c0 + (part - 4) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (m0 + r < m_rows)
        raw = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * in_f + col));
      *reinterpret_cast<uint4*>(s_x + r * kLdh + part * 8) = raw;
    }
    // W: row n, 16 packed bytes per thread -> 16 high + 16 low columns
    for (int idx = tid; idx < kTileN * 2; idx += kTileThreads) {
      const int n = idx / 2;
      const int part = idx % 2;
      uint4 lo4[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      uint4 hi4[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (n0 + n < out_f) {
        const size_t row = static_cast<size_t>(n0 + n);
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            packed + row * half + c0 + part * 16));
        const float s_hi = __ldg(absmax + row * n_blk + c0 / kBlock);
        const float s_lo = __ldg(absmax + row * n_blk + (half + c0) / kBlock);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        bf16* h = reinterpret_cast<bf16*>(hi4);
        bf16* l = reinterpret_cast<bf16*>(lo4);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t byte = (words[j / 4] >> (8 * (j % 4))) & 0xffu;
          h[j] = __float2bfloat16(s_code[byte >> 4] * s_hi);
          l[j] = __float2bfloat16(s_code[byte & 0xfu] * s_lo);
        }
      }
      bf16* dst = s_w + n * kLdh;
      *reinterpret_cast<uint4*>(dst + part * 16) = hi4[0];
      *reinterpret_cast<uint4*>(dst + part * 16 + 8) = hi4[1];
      *reinterpret_cast<uint4*>(dst + kStepBytes + part * 16) = lo4[0];
      *reinterpret_cast<uint4*>(dst + kStepBytes + part * 16 + 8) = lo4[1];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], s_x + (wm + i * 16) * kLdh + kk * 16, kLdh);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], s_w + (wn + j * 16) * kLdh + kk * 16, kLdh);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  __syncthreads();   // s_c overlays the x / W tiles
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_c + (wm + i * 16) * kLdc + wn + j * 16, acc[i][j], kLdc,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kTileM * kTileN; idx += kTileThreads) {
    const int r = idx / kTileN;
    const int c = idx % kTileN;
    if (m0 + r < m_rows && n0 + c < out_f)
      y[static_cast<size_t>(m0 + r) * out_f + n0 + c] = __float2bfloat16(s_c[r * kLdc + c]);
  }
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

// The tiled product, for any m. Same operands as fd_nf4_gemv.
int fd_nf4_gemm(const void* x, const void* packed, const void* absmax, void* y,
                int m, int in_f, int out_f, void* stream) {
  if (m <= 0 || out_f <= 0 || in_f <= 0 || in_f % kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (m + kTileM - 1) / kTileM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((out_f + kTileN - 1) / kTileN, m_tiles);
  nf4_gemm_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<bf16*>(y), m, in_f, out_f);
  return static_cast<int>(cudaGetLastError());
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
