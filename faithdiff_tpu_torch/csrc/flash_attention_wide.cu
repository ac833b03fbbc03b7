// Flash-attention forward for Hopper (sm_90a), bf16 in and out, at the wide
// head dims d = 192 ... 512 (multiples of 64), any layout with unit column
// stride.
//
// Replaces the wide-d instantiations of:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl), which JAX's gate admits at any d % 64 == 0
//   while kv_len * d <= 512 Ki: the VAE mid-block's single-head d = 512
//   attention at a 32 x 32 latent ([B, 1, 1024, 512]), run by the denoise
//   encoder, the VAE encode and the VAE decode of a 256 x 256 restore;
// - faithdiff_tpu/ops/attention.py::_flash_kernel_bsnd (launched by
//   _flash_attention_bsnd_impl) at those head dims: packed [b, s, n*d] rows,
//   non-causal (its gate has no K/V cap).
// One kernel serves both layouts: the wrapper (ops/attention.py) passes each
// operand's element strides of batch, head and row, so a head of a packed
// row is `d` elements into it and a contiguous plane is a head.
//
// What it computes: o = softmax(q k^T * scale) v. Scores are fp32 products
// of the bf16 operands, scaled by scale * log2 e in fp32; an online softmax
// in base 2 over K/V tiles (m, l and the accumulator in registers, the
// accumulator rescaled by alpha = 2^(m_old - m_new)); p rounded to bf16
// before p.v, as the plain version rounds its probabilities to v's dtype;
// fp32 accumulation; o = acc / l. Columns past kv_len and, under `causal`,
// above the diagonal (top-left: col > row) score -0.7 * FLT_MAX, the TPU
// kernel's DEFAULT_MASK_VALUE.
//
// What bounds it on the card: operations (4 * BH * S^2 * d flops against
// 8 * BH * S * d bytes: ~2,000 flops a byte at S = 1024, d = 512).
//
// Why this shape. The d = 64 / 128 kernels (flash_attention.cu) keep a
// 64-row fp32 accumulator of all d columns in a warpgroup's registers; at
// d = 512 that is 256 registers a thread before any score, past the 255
// limit, and Q, K and V tiles of 64 rows would take 192 KB of shared memory.
// So a block owns 64 q rows and one SLICE of kSlice output columns (128, or
// 64 where d is no multiple of 128), and the grid has d / kSlice blocks per
// q block, each recomputing the scores over the full d: at d = 512 the
// q.k^T work is done four times, 2.5x the operations of one pass, for an
// accumulator of 64 registers a thread. The products are `mma.sync`
// m16n8k16 (bf16 in, fp32 out): four warps, 16 q rows each; a warp's scores
// for a 64-key tile are 8 fragments (32 registers), and the score fragments
// are re-packed in registers as the A operand of p.v (the accumulator layout
// of m16n8 equals the A layout of m16k16 in halves). Q and the K tile sit in
// shared memory with rows padded by 8 bf16 (16 bytes), so the 32-bit
// fragment loads of 8 rows x 4 columns hit 32 different banks; the V slice
// is stored transposed (key fastest) so that its B fragments are 32-bit
// loads too. Loads are plain 16-byte vector loads; the tiles are not
// double buffered. This is the simple first design: wgmma, TMA and a
// K/V ring at these widths are later work.
//
// Shared memory a block: (64 + 64) * (d + 8) * 2 + kSlice * 72 * 2 bytes:
// d = 512: 151,552 (one block an SM); d = 256: 84,992; d = 192: 60,416.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;      // q rows a block (16 a warp)
constexpr int kBlockK = 64;      // K/V rows a tile
constexpr int kThreads = 128;    // four warps
constexpr int kPad = 8;          // bf16 of padding a shared-memory row
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

// Element strides of one operand: batch, head, row (columns are unit).
struct Strides {
  long long batch, head, row;
};

// output columns a block owns at head dim d
template <int kHeadDim>
constexpr int kSliceFor = kHeadDim % 128 == 0 ? 128 : 64;

template <int kHeadDim>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((kBlockQ + kBlockK) * (kHeadDim + kPad)
                         + kSliceFor<kHeadDim> * (kBlockK + kPad));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile: a the 16 x 16 row-major A fragment,
// (b0, b1) the 16 x 8 column-major B fragment, d the 16 x 8 fp32 fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kHeadDim, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_wide_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      int q_len, int kv_len, float scale_log2) {
  constexpr int kSlice = kSliceFor<kHeadDim>;
  constexpr int kSlices = kHeadDim / kSlice;
  constexpr int kLd = kHeadDim + kPad;        // Q and K rows
  constexpr int kLdV = kBlockK + kPad;        // V^T rows (one a column)
  constexpr int kChunks = kHeadDim / 8;       // 16-byte pieces of a row
  constexpr int kSliceChunks = kSlice / 8;
  constexpr int kOutTiles = kSlice / 8;       // n8 tiles of the accumulator
  constexpr int kKeyTiles = kBlockK / 8;      // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBlockQ][kLd]
  bf16* ks = qs + kBlockQ * kLd;                  // [kBlockK][kLd]
  bf16* vt = ks + kBlockK * kLd;                  // [kSlice][kLdV]

  const int q0 = (blockIdx.x / kSlices) * kBlockQ;
  const int c0 = (blockIdx.x % kSlices) * kSlice;
  const long long head = blockIdx.y, batch = blockIdx.z;
  const bf16* qb = q + batch * sq.batch + head * sq.head;
  const bf16* kb = k + batch * sk.batch + head * sk.head;
  const bf16* vb = v + batch * sv.batch + head * sv.head + c0;
  bf16* ob = o + batch * so.batch + head * so.head + c0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;       // fragment row group, column pair
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;

  // Q rows, zeros past q_len
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < q_len)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq.row + c);
    *reinterpret_cast<uint4*>(qs + r * kLd + c) = val;
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (kCausal) {
    // tiles holding a column <= the block's last row
    const int last = (q0 + kBlockQ + kBlockK - 1) / kBlockK;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const bf16* qw = qs + warp * 16 * kLd;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();   // Q written; the last tile's K and V reads done
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < kv_len)
        val = *reinterpret_cast<const uint4*>(kb + (k0 + r) * sk.row + c);
      *reinterpret_cast<uint4*>(ks + r * kLd + c) = val;
    }
    // the V slice transposed; consecutive threads take consecutive keys
    for (int i = tid; i < kBlockK * kSliceChunks; i += kThreads) {
      const int r = i % kBlockK, c = (i / kBlockK) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < kv_len)
        val = *reinterpret_cast<const uint4*>(vb + (k0 + r) * sv.row + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kLdV + r] = e[j];
    }
    __syncthreads();
    // a warp whose rows all lie above the tile's first column skips it
    if (kCausal && k0 > q0 + warp * 16 + 15) continue;

    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(qw + g * kLd + kk + 2 * t);
      a[1] = ld32(qw + (g + 8) * kLd + kk + 2 * t);
      a[2] = ld32(qw + g * kLd + kk + 8 + 2 * t);
      a[3] = ld32(qw + (g + 8) * kLd + kk + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const bf16* kr = ks + (8 * j + g) * kLd + kk + 2 * t;
        mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, row maxima (a row's 64 scores lie in the 4 lanes of a
    // row group: elements 0, 1 on row_lo, 2, 3 on row_hi)
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = s[j][e] * scale_log2;
        if (col >= kv_len || (kCausal && col > row)) x = kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p . v_slice, p from the score fragments in bf16
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        const bf16* vr = vt + (8 * n + g) * kLdV + 16 * kk + 2 * t;
        mma_bf16(acc[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv_lo = 1.f / l[0], inv_hi = 1.f / l[1];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_lo < q_len)
      *reinterpret_cast<uint32_t*>(ob + row_lo * so.row + col) =
          pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (row_hi < q_len)
      *reinterpret_cast<uint32_t*>(ob + row_hi * so.row + col) =
          pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
}

template <int kHeadDim, bool kCausal>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   const long long* strides, int batch, int heads, int q_len,
                   int kv_len, float scale_log2, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<kHeadDim>();
  auto kernel = flash_wide_fwd_kernel<kHeadDim, kCausal>;
  // once per instantiation and device
  static int allowed_on = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && allowed_on != device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err == cudaSuccess) allowed_on = device;
  }
  if (err != cudaSuccess) return err;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const long long q_blocks = (q_len + kBlockQ - 1) / kBlockQ;
  const long long blocks = q_blocks * (kHeadDim / kSliceFor<kHeadDim>);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), heads, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, sq, sk, sv, so, q_len,
                                            kv_len, scale_log2);
  return cudaGetLastError();
}

#define FD_WIDE_CASE(D)                                                        \
  case D:                                                                      \
    return causal ? launch<D, true>(qb, kb, vb, ob, st, batch, heads, q_len,   \
                                    kv_len, scale_log2, s)                     \
                  : launch<D, false>(qb, kb, vb, ob, st, batch, heads, q_len,  \
                                     kv_len, scale_log2, s);

}  // namespace

extern "C" {

// q [batch, heads, q_len, head_dim], k / v [batch, heads, kv_len, head_dim],
// o like q, all bf16 with unit column stride, in any layout that `strides`
// describes: 12 element strides, (batch, head, row) of q, k, v and o in this
// order, each a multiple of 8 (16 bytes), base pointers 16-byte aligned.
// head_dim 192, 256, 320, 384, 448 or 512; `scale_log2` is the softmax scale
// times log2 e; `causal` masks top-left (needs q_len == kv_len, which the
// wrapper checks). Returns a cudaError_t code.
int fd_flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* strides, int batch,
                                int heads, int q_len, int kv_len, int head_dim,
                                float scale_log2, int causal, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || q_len < 1
      || kv_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const long long*>(strides);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(o);
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

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
