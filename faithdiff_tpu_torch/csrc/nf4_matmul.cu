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
// of the 13B model streams ~7.1 GB, ~2.1 ms at 3.35 TB/s. At prefill
// (M ~ 640 per image) operations: 2 * M * in * out flops against ~0.56 bytes
// per weight, far above the ~295 flop/byte ridge.
//
// Design (simple first), two paths chosen by M:
// - M <= 8: one warp per output row. Each lane reads the packed row as
//   16-byte vectors (16 high and 16 low codes), decodes them with the table
//   in shared memory, and multiplies by the matching x slices read through
//   the read-only cache; the warp reduces its M partial sums with shuffles.
// - M > 8: a tiled product. A block of 8 warps owns a 64 x 128 output tile
//   and walks the packed columns 32 bytes at a time (= 64 weight columns:
//   32 from the high nibbles, 32 from the low). Per step it decodes the
//   [128, 64] weight tile into shared memory as bf16, stages the matching
//   x columns, and multiplies with WMMA 16x16x16 bf16 fragments into fp32
//   accumulators (each warp 32 x 32). No cp.async / TMA / wgmma yet: loads
//   are not overlapped with the tensor-core work.
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

// code * absmax in fp32, rounded to bf16 (returned widened to fp32)
__device__ __forceinline__ float decode(const float* code, uint32_t nib, float s) {
  return __bfloat162float(__float2bfloat16(code[nib] * s));
}

__device__ __forceinline__ void widen8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// ---------------------------------------------------------------- M <= 8
constexpr int kGemvWarps = 8;

template <int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
nf4_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ absmax, bf16* __restrict__ y,
                int in_f, int out_f) {
  __shared__ float s_code[16];
  if (threadIdx.x < 16) s_code[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int o = blockIdx.x * kGemvWarps + warp;
  if (o >= out_f) return;

  const int half = in_f / 2;
  const int n_vec = half / 16;             // 16-byte vectors per packed row
  const uint4* prow = reinterpret_cast<const uint4*>(packed + static_cast<size_t>(o) * half);
  const float* arow = absmax + static_cast<size_t>(o) * (in_f / kBlock);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  for (int v = lane; v < n_vec; v += 32) {
    const uint4 raw = __ldg(prow + v);
    const int c = v * 16;                  // column of the first high code
    // a 16-aligned run of 16 columns lies in one 64-block (in/2 % 32 == 0)
    const float s_hi = __ldg(arow + c / kBlock);
    const float s_lo = __ldg(arow + (c + half) / kBlock);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float w_hi[16], w_lo[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t byte = (words[j / 4] >> (8 * (j % 4))) & 0xffu;
      w_hi[j] = decode(s_code, byte >> 4, s_hi);
      w_lo[j] = decode(s_code, byte & 0xfu, s_lo);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bf16* xr = x + static_cast<size_t>(m) * in_f;
      float xh[16], xl[16];
      widen8(__ldg(reinterpret_cast<const uint4*>(xr + c)), xh);
      widen8(__ldg(reinterpret_cast<const uint4*>(xr + c + 8)), xh + 8);
      widen8(__ldg(reinterpret_cast<const uint4*>(xr + half + c)), xl);
      widen8(__ldg(reinterpret_cast<const uint4*>(xr + half + c + 8)), xl + 8);
      float a = acc[m];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        a = fmaf(w_hi[j], xh[j], a);
        a = fmaf(w_lo[j], xl[j], a);
      }
      acc[m] = a;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) y[static_cast<size_t>(m) * out_f + o] = __float2bfloat16(a);
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

template <int M>
cudaError_t launch_gemv(const void* x, const void* packed, const void* absmax, void* y,
                        int in_f, int out_f, cudaStream_t stream) {
  const int blocks = (out_f + kGemvWarps - 1) / kGemvWarps;
  nf4_gemv_kernel<M><<<blocks, kGemvWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<bf16*>(y), in_f, out_f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous bf16 [m, in_f]; packed: uint8 [out_f, in_f / 2] (half-row);
// absmax: f32 [out_f, in_f / 64]; y: bf16 [m, out_f]. in_f % 64 == 0, all
// pointers 16-byte aligned. Returns a cudaError_t code.
int fd_nf4_matmul(const void* x, const void* packed, const void* absmax, void* y,
                  int m, int in_f, int out_f, void* stream) {
  if (m <= 0 || out_f <= 0 || in_f <= 0 || in_f % kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch_gemv<1>(x, packed, absmax, y, in_f, out_f, s));
    case 2: return static_cast<int>(launch_gemv<2>(x, packed, absmax, y, in_f, out_f, s));
    case 3: return static_cast<int>(launch_gemv<3>(x, packed, absmax, y, in_f, out_f, s));
    case 4: return static_cast<int>(launch_gemv<4>(x, packed, absmax, y, in_f, out_f, s));
    case 5: return static_cast<int>(launch_gemv<5>(x, packed, absmax, y, in_f, out_f, s));
    case 6: return static_cast<int>(launch_gemv<6>(x, packed, absmax, y, in_f, out_f, s));
    case 7: return static_cast<int>(launch_gemv<7>(x, packed, absmax, y, in_f, out_f, s));
    case 8: return static_cast<int>(launch_gemv<8>(x, packed, absmax, y, in_f, out_f, s));
    default: break;
  }
  const int m_tiles = (m + kTileM - 1) / kTileM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((out_f + kTileN - 1) / kTileN, m_tiles);
  nf4_gemm_kernel<<<grid, kTileThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<bf16*>(y), m, in_f, out_f);
  return static_cast<int>(cudaGetLastError());
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
