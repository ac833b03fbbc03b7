// Flash-attention forward for Hopper (sm_90a) in float32: fp32 in and out,
// head dim 64 or 128, any layout with unit column stride.
//
// Replaces the fp32 instantiation of:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl): JAX gates its kernel on shapes alone, so
//   the fp32 trainer (`cli.py train --dtype float32`) runs it at fp32, at
//   every UNet self-attention of >= 1024 tokens ([B,10,1024,64] at 512 px,
//   10 a stage-1 micro-step), contiguous [B, H, S, d] rows, causal or not;
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
// design is simple, not fast: a block of 128 threads owns 64 q rows and
// walks K/V in tiles of 64 rows staged in shared memory; each thread holds
// a 4 x 8 tile of scores and a 4 x d/8 tile of the accumulator, columns
// strided by 8 so that shared-memory reads are conflict-free (rows padded
// by one float). A row's max and sum reduce over the 8 lanes that share it
// with shuffles; the probabilities go through a per-warp slice of shared
// memory into the P.V product.
//
// Shared memory a block (one padded row of d + 1 floats for Q, K, V, and
// 65 for P): d = 64: 66,560 bytes (3 blocks an SM); d = 128: 115,712 bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 64;      // q rows a block
constexpr int kBlockK = 64;      // K/V rows a tile
constexpr int kThreads = 128;    // 16 row groups of 4 rows x 8 column lanes
constexpr int kRowsPerThread = 4;
constexpr int kLanes = 8;        // threads sharing a row
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

// Element strides of one operand: batch, head, row (columns are unit).
struct Strides {
  long long batch, head, row;
};

template <int kHeadDim>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBlockQ + 2 * kBlockK) * (kHeadDim + 1)
                          + kBlockQ * (kBlockK + 1));
}

template <int kHeadDim, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int q_len, int kv_len, float scale_log2) {
  constexpr int kLd = kHeadDim + 1;
  constexpr int kLdP = kBlockK + 1;
  constexpr int kCols = kHeadDim / kLanes;   // accumulator columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBlockQ][kLd]
  float* ks = qs + kBlockQ * kLd;            // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;            // [kBlockK][kLd]
  float* ps = vs + kBlockK * kLd;            // [kBlockQ][kLdP]

  const int q0 = blockIdx.x * kBlockQ;
  const long long head = blockIdx.y, batch = blockIdx.z;
  const float* qb = q + batch * sq.batch + head * sq.head;
  const float* kb = k + batch * sk.batch + head * sk.head;
  const float* vb = v + batch * sv.batch + head * sv.head;
  float* ob = o + batch * so.batch + head * so.head;
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
    for (int i = tid; i < kBlockK * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, c = i % kHeadDim;
      const int row = k0 + r;
      const bool live = row < kv_len;
      ks[r * kLd + c] = live ? kb[row * sk.row + c] : 0.f;
      vs[r * kLd + c] = live ? vb[row * sv.row + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kLanes];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kLanes; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kHeadDim; ++c) {
      float qv[kRowsPerThread], kv[kLanes];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(r0 + i) * kLd + c];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) kv[j] = ks[(tx + kLanes * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kLanes; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + r0 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
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
      for (int j = 0; j < kLanes; ++j) {
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
        const float vv = vs[kk * kLd + tx + kLanes * j];
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
  constexpr size_t kSmem = smem_bytes<kHeadDim>();
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
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, sq, sk, sv, so, q_len,
                                            kv_len, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [batch, heads, q_len, head_dim], k / v [batch, heads, kv_len, head_dim],
// o like q, all fp32 with unit column stride, in any layout that `strides`
// describes: 12 element strides, (batch, head, row) of q, k, v and o in this
// order. head_dim 64 or 128; `scale_log2` is the softmax scale times log2 e;
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
  if (head_dim == 64)
    return causal ? launch<64, true>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s)
                  : launch<64, false>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s);
  if (head_dim == 128)
    return causal ? launch<128, true>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s)
                  : launch<128, false>(qf, kf, vf, of, st, batch, heads, q_len, kv_len, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
