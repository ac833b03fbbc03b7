// Flash-attention forward for Hopper (sm_90a) in float32: fp32 in and out,
// head dim 64, 128 or a wide one (192 ... 512, multiples of 64), any layout
// with unit column stride.
//
// Replaces the fp32 instantiation of:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl): JAX gates its kernel on shapes alone, so
//   the fp32 trainer (`cli.py train --dtype float32`) runs it at fp32, at
//   every UNet self-attention of >= 1024 tokens ([B,10,1024,64] at 512 px,
//   10 a stage-1 micro-step), contiguous [B, H, S, d] rows, causal or not,
//   and at 256 px at the VAE's single-head d = 512 attention over a 32 x 32
//   latent ([B,1,1024,512]: the VAE encode and the denoise encoder);
// - faithdiff_tpu/ops/attention.py::_flash_kernel_bsnd (launched by
//   _flash_attention_bsnd_impl) at fp32: the packed [b, s, n*d] projection
//   outputs under FAITHDIFF_BSND_ATTN=1, non-causal.
// One kernel serves both: the wrapper (ops/attention.py) passes each
// operand's element strides of batch, head and row, so a head of a packed
// row is `d` elements into it and a contiguous plane is a head.
//
// What it computes: o = softmax(q k^T * scale) v with the TPU kernels'
// arithmetic: q * (scale * log2 e) once, fp32 scores, an online softmax in
// base 2 over K/V tiles (m, l, acc carried in registers, acc rescaled by
// alpha = 2^(m_old - m_new)), fp32 accumulation, o = acc / l. Columns past
// kv_len and, under `causal`, columns above the diagonal (top-left: col >
// row) score -0.7 * FLT_MAX, as the TPU kernel's DEFAULT_MASK_VALUE.
//
// What bounds it on the card: operations. 4 * BH * S^2 * d flops against
// 16 * BH * S * d bytes of q/k/v/o: ~1,000 flops a byte at S = 4096, far
// past the ridge. The products run on the CUDA cores in full fp32 (no
// tensor cores: TF32 would keep 10 mantissa bits and miss the fp32 plain
// version), so the bound is the card's fp32 rate, 67 TFLOP/s. This first
// design is simple, not fast: a block of 128 threads owns kBlockQ q rows
// and walks K/V in tiles of kBlockK rows staged in shared memory; each
// thread holds a (kBlockQ / 16) x (kBlockK / 8) tile of scores and a
// (kBlockQ / 16) x (kSlice / 8) tile of the accumulator, columns strided by
// 8 so that shared-memory reads are conflict-free (rows padded by one
// float). A row's max and sum reduce over the 8 lanes that share it with
// shuffles; the probabilities go through a per-warp slice of shared memory
// into the P.V product.
//
// At d = 64 and 128 a block has 64 q rows, 64-row K/V tiles and all d
// output columns (kSlice = d). At the wide head dims the accumulator and
// the tiles would not fit (d = 512: 64 rows of Q, K and V are 384 KB), so a
// block has 32 q rows, 32-row tiles and one slice of kSlice = 128 output
// columns (64 where d is no multiple of 128); the grid has d / kSlice
// blocks per q block, each computing the scores over the full d again.
//
// Shared memory a block: (kBlockQ + kBlockK) * (d + 1) + kBlockK *
// (kSlice + 1) + kBlockQ * (kBlockK + 1) floats: d = 64: 66,560 bytes (3
// blocks an SM); d = 128: 115,712; d = 512: 152,064; d = 192: 61,952.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;    // 16 row groups x 8 column lanes
constexpr int kRowGroups = 16;
constexpr int kLanes = 8;        // threads sharing a row
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

// Element strides of one operand: batch, head, row (columns are unit).
struct Strides {
  long long batch, head, row;
};

// The tiling at head dim d: output columns a block (kSlice), q rows a
// block (kBlockQ), K/V rows a tile (kBlockK).
template <int kHeadDim>
struct Tiling {
  static constexpr bool kWide = kHeadDim > 128;
  static constexpr int kSlice = !kWide ? kHeadDim : kHeadDim % 128 == 0 ? 128 : 64;
  static constexpr int kBlockQ = kWide ? 32 : 64;
  static constexpr int kBlockK = kWide ? 32 : 64;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kBlockQ + kBlockK) * (kHeadDim + 1)
                       + kBlockK * (kSlice + 1) + kBlockQ * (kBlockK + 1));
};

template <int kHeadDim, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int q_len, int kv_len, float scale_log2) {
  using T = Tiling<kHeadDim>;
  constexpr int kBlockQ = T::kBlockQ, kBlockK = T::kBlockK, kSlice = T::kSlice;
  constexpr int kSlices = kHeadDim / kSlice;
  constexpr int kRowsPerThread = kBlockQ / kRowGroups;
  constexpr int kKeys = kBlockK / kLanes;    // scores a thread holds a row
  constexpr int kLd = kHeadDim + 1;
  constexpr int kLdV = kSlice + 1;
  constexpr int kLdP = kBlockK + 1;
  constexpr int kCols = kSlice / kLanes;     // accumulator columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBlockQ][kLd]
  float* ks = qs + kBlockQ * kLd;            // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;            // [kBlockK][kLdV]
  float* ps = vs + kBlockK * kLdV;           // [kBlockQ][kLdP]

  const int q0 = (blockIdx.x / kSlices) * kBlockQ;
  const int c0 = (blockIdx.x % kSlices) * kSlice;
  const long long head = blockIdx.y, batch = blockIdx.z;
  const float* qb = q + batch * sq.batch + head * sq.head;
  const float* kb = k + batch * sk.batch + head * sk.head;
  const float* vb = v + batch * sv.batch + head * sv.head + c0;
  float* ob = o + batch * so.batch + head * so.head + c0;
  const int tid = threadIdx.x;
  const int ty = tid / kLanes, tx = tid % kLanes;
  const int r0 = ty * kRowsPerThread;        // this thread's first row in the block

  // Q, scaled once (the TPU kernel's fold of scale and log2 e); zeros past q_len
  for (int i = tid; i < kBlockQ * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    const int row = q0 + r;
    qs[r * kLd + c] = row < q_len ? qb[row * sq.row + c] * scale_log2 : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (kCausal) {
    // tiles holding a column <= the block's last row
    const int last = (q0 + kBlockQ + kBlockK - 1) / kBlockK;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // Q written; the last tile's K, V and P reads done
    if constexpr (kSlice == kHeadDim) {
      // K and V rows in one loop (two loads in flight a thread)
      for (int i = tid; i < kBlockK * kHeadDim; i += kThreads) {
        const int r = i / kHeadDim, c = i % kHeadDim;
        const int row = k0 + r;
        const bool live = row < kv_len;
        ks[r * kLd + c] = live ? kb[row * sk.row + c] : 0.f;
        vs[r * kLdV + c] = live ? vb[row * sv.row + c] : 0.f;
      }
    } else {
      for (int i = tid; i < kBlockK * kHeadDim; i += kThreads) {
        const int r = i / kHeadDim, c = i % kHeadDim;
        const int row = k0 + r;
        ks[r * kLd + c] = row < kv_len ? kb[row * sk.row + c] : 0.f;
      }
      for (int i = tid; i < kBlockK * kSlice; i += kThreads) {
        const int r = i / kSlice, c = i % kSlice;
        const int row = k0 + r;
        vs[r * kLdV + c] = row < kv_len ? vb[row * sv.row + c] : 0.f;
      }
    }
    __syncthreads();

    float s[kRowsPerThread][kKeys];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kHeadDim; ++c) {
      float qv[kRowsPerThread], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(r0 + i) * kLd + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + kLanes * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + r0 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + tx + kLanes * j;
        if (col >= kv_len || (kCausal && col > row)) s[i][j] = kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        ps[(r0 + i) * kLdP + tx + kLanes * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    // a row's probabilities are written and read by the 8 lanes of one warp
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(r0 + i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[kk * kLdV + tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + r0 + i;
    if (row >= q_len) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[row * so.row + tx + kLanes * j] = acc[i][j] * inv;
  }
}

template <int kHeadDim, bool kCausal>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   const long long* strides, int batch, int heads, int q_len,
                   int kv_len, float scale_log2, cudaStream_t stream) {
  using T = Tiling<kHeadDim>;
  constexpr size_t kSmem = T::kSmemBytes;
  auto kernel = flash_f32_fwd_kernel<kHeadDim, kCausal>;
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
  const long long blocks = static_cast<long long>((q_len + T::kBlockQ - 1) / T::kBlockQ)
                           * (kHeadDim / T::kSlice);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), heads, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, sq, sk, sv, so, q_len,
                                            kv_len, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [batch, heads, q_len, head_dim], k / v [batch, heads, kv_len, head_dim],
// o like q, all fp32 with unit column stride, in any layout that `strides`
// describes: 12 element strides, (batch, head, row) of q, k, v and o in this
// order. head_dim 64, 128, 192, 256, 320, 384, 448 or 512; `scale_log2` is the softmax scale times log2 e;
// `causal` masks top-left (needs q_len == kv_len, which the wrapper checks).
// Returns a cudaError_t code.
int fd_flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                               void* o, const void* strides, int batch,
                               int heads, int q_len, int kv_len, int head_dim,
                               float scale_log2, int causal, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || q_len < 1
      || kv_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const long long*>(strides);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
#define FD_F32_CASE(D)                                                                      \
  case D:                                                                                   \
    return causal ? launch<D, true>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s) \
                  : launch<D, false>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s);
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
#undef FD_F32_CASE
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
