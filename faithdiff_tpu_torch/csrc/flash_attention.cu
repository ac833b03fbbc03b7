// Flash-attention forward for Hopper (sm_90a), bf16 in and out, head dim
// 64 or 128, in two layouts. The tile body is in flash_tile.cuh.
//
// Replaces:
// - faithdiff_tpu/ops/attention.py::_flash_kernel (launched by
//   _flash_attention_fwd_impl) with flash_fwd_kernel over contiguous
//   [BH, S, d] rows: every UNet self-attention of the restore path
//   ([2T,10,4096,64] and [2T,20,1024,64] at a 1024^2 tile, T tiles per UNet
//   call) and the LLaMA-13B causal prefill at >= 1024 tokens ([B,40,S,128]).
// - scripts/bench_attention_variants.py::kernel (launched by its `run`), the
//   benchmark copy of the TPU flash kernel with a `base2` switch and a
//   `block_k` loop, with the same flash_fwd_kernel instantiated for base e
//   and base 2 at block_k 64 and 128 (fd_attention_variant_fwd: [bh, s, 64]
//   bf16, non-causal; the card's tile depths, not the TPU's 256-2048).
// - faithdiff_tpu/ops/attention.py::_flash_kernel_bsnd (launched by
//   _flash_attention_bsnd_impl) with flash_bsnd_fwd_kernel over the packed
//   [b, s, n*d] projection outputs (the UNet's Attention under
//   FAITHDIFF_BSND_ATTN=1: [2T,4096,640] with 10 heads, [2T,1024,1280] with
//   20). Row r of head h is read at base + r * row_stride + h * d: at d=64
//   each row is 128 contiguous bytes, so loads stay coalesced 16-byte
//   vectors, and the output is written packed, in place of the head
//   transposes that the TPU kernel was built to avoid. Blocks run in
//   parallel on the card, so the TPU kernel's kv grid axis (softmax state
//   carried in scratch across grid steps) becomes the tile body's loop.
//
// What it computes: o = softmax(q k^T * scale) v with the TPU kernels'
// arithmetic (base 2, scale * log2 e folded into q; see flash_tile.cuh).
//
// What bounds it on the card: operations. At the UNet shapes it does
// 4*BH*S^2*d flops against 4*BH*S*d*2 bytes of q/k/v/o, about 1,000 flops
// per byte (S=4096, d=64), far above the H100's ~295 flop/byte ridge.
//
// Shared memory: 72 KB a block at d=64 (3 blocks an SM), 110.5 KB at d=128
// (2 blocks an SM), 112.5 KB for the d=64 variants at block_k 128 (2 blocks
// an SM); each (head dim, block_k) is its own instantiation, so d=128 does
// not lower d=64's occupancy.
#include "flash_tile.cuh"

namespace {

using fd_flash::bf16;
using fd_flash::kBlockQ;
using fd_flash::kThreads;

constexpr int kBlockK = 64;

// `scale` is the softmax scale times log2 e when kBase2, the softmax scale
// otherwise (see attend_tile).
template <int kHeadDim, int kBlockKV, bool kBase2>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int q_len, int kv_len, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t bh = blockIdx.y;
  const int64_t q_off = bh * q_len * kHeadDim, kv_off = bh * kv_len * kHeadDim;
  fd_flash::attend_tile<kHeadDim, kBlockKV, kBase2>(
      q + q_off, k + kv_off, v + kv_off, o + q_off, kHeadDim, kHeadDim,
      kHeadDim, kHeadDim, blockIdx.x * kBlockQ, q_len, kv_len, scale,
      causal != 0, smem);
}

// q [b, q_len, heads*d], k/v [b, kv_len, heads*d], each with its own batch
// and row strides (elements); o is contiguous [b, q_len, heads*d].
template <int kHeadDim>
__global__ void __launch_bounds__(kThreads)
flash_bsnd_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int heads, int q_len, int kv_len,
                      int64_t q_batch, int64_t q_row, int64_t k_batch,
                      int64_t k_row, int64_t v_batch, int64_t v_row,
                      float q_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t b = blockIdx.y / heads;
  const int64_t col = static_cast<int64_t>(blockIdx.y % heads) * kHeadDim;
  const int64_t o_row = static_cast<int64_t>(heads) * kHeadDim;
  fd_flash::attend_tile<kHeadDim, kBlockK, true>(
      q + b * q_batch + col, k + b * k_batch + col, v + b * v_batch + col,
      o + b * q_len * o_row + col, q_row, k_row, v_row, o_row,
      blockIdx.x * kBlockQ, q_len, kv_len, q_scale, false, smem);
}

template <int kHeadDim, int kBlockKV = kBlockK, bool kBase2 = true>
cudaError_t launch_bhsd(const void* q, const void* k, const void* v, void* o,
                        int bh, int q_len, int kv_len, float scale,
                        int causal, cudaStream_t stream) {
  const auto kernel = flash_fwd_kernel<kHeadDim, kBlockKV, kBase2>;
  constexpr size_t smem = fd_flash::Layout<kHeadDim, kBlockKV>::kSmemBytes;
  cudaError_t err = fd_flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), q_len, kv_len,
      scale, causal);
  return cudaGetLastError();
}

template <int kHeadDim>
cudaError_t launch_bsnd(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int q_len, int kv_len,
                        int64_t q_batch, int64_t q_row, int64_t k_batch,
                        int64_t k_row, int64_t v_batch, int64_t v_row,
                        float q_scale, cudaStream_t stream) {
  constexpr size_t smem = fd_flash::Layout<kHeadDim, kBlockK>::kSmemBytes;
  cudaError_t err = fd_flash::allow_smem(flash_bsnd_fwd_kernel<kHeadDim>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_bsnd_fwd_kernel<kHeadDim><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads, q_len,
      kv_len, q_batch, q_row, k_batch, k_row, v_batch, v_row, q_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous bf16 [bh, len, head_dim], head_dim 64 or 128.
// Returns a cudaError_t code.
int fd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                           int bh, int q_len, int kv_len, int head_dim,
                           float q_scale, int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_bhsd<64>(q, k, v, o, bh, q_len, kv_len, q_scale, causal, s);
    case 128: return launch_bhsd<128>(q, k, v, o, bh, q_len, kv_len, q_scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Packed layout: q [batch, q_len, heads*head_dim], k/v [batch, kv_len,
// heads*head_dim], bf16 with unit column stride and the given batch / row
// strides in elements (multiples of 8, base pointers 16-byte aligned); o
// contiguous [batch, q_len, heads*head_dim]. Non-causal. Returns a
// cudaError_t code.
int fd_flash_attention_bsnd_fwd(const void* q, const void* k, const void* v,
                                void* o, int batch, int heads, int head_dim,
                                int q_len, int kv_len, int64_t q_batch,
                                int64_t q_row, int64_t k_batch, int64_t k_row,
                                int64_t v_batch, int64_t v_row, float q_scale,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_bsnd<64>(q, k, v, o, batch, heads, q_len, kv_len, q_batch,
                             q_row, k_batch, k_row, v_batch, v_row, q_scale, s);
    case 128:
      return launch_bsnd<128>(q, k, v, o, batch, heads, q_len, kv_len, q_batch,
                              q_row, k_batch, k_row, v_batch, v_row, q_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The variant benchmark's kernel: q, k, v, o contiguous bf16 [bh, len, 64],
// non-causal. `scale` is the softmax scale times log2 e when base2, the
// softmax scale otherwise. block_k is 64 or 128. Returns a cudaError_t code.
int fd_attention_variant_fwd(const void* q, const void* k, const void* v,
                             void* o, int bh, int q_len, int kv_len,
                             float scale, int base2, int block_k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (block_k == 64)
    return base2 ? launch_bhsd<64, 64, true>(q, k, v, o, bh, q_len, kv_len, scale, 0, s)
                 : launch_bhsd<64, 64, false>(q, k, v, o, bh, q_len, kv_len, scale, 0, s);
  if (block_k == 128)
    return base2 ? launch_bhsd<64, 128, true>(q, k, v, o, bh, q_len, kv_len, scale, 0, s)
                 : launch_bhsd<64, 128, false>(q, k, v, o, bh, q_len, kv_len, scale, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
