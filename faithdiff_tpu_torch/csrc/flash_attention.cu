// Flash-attention forward for Hopper (sm_90a), bf16 in and out, head dim
// 64 or 128, in two layouts. The block body is in flash_tile.cuh.
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
//   20), q/k/v each with its own batch and row strides (column slices of a
//   fused projection included), the output written packed, in place of the
//   head transposes that the TPU kernel was built to avoid. Blocks run in
//   parallel on the card, so the TPU kernel's kv grid axis (softmax state
//   carried in scratch across grid steps) becomes the block body's loop.
//
// What it computes: o = softmax(q k^T * scale) v with the TPU kernels'
// arithmetic (base 2, scale * log2 e folded into q; see flash_tile.cuh).
//
// What bounds it on the card: operations. At the UNet shapes it does
// 4*BH*S^2*d flops against 4*BH*S*d*2 bytes of q/k/v/o, about 1,000 flops
// per byte (S=4096, d=64), far above the H100's ~295 flop/byte ridge. So
// the body multiplies with wgmma, keeps scores, probabilities and the
// accumulator in registers, and has a producer thread stream K/V tiles
// through a ring in shared memory with TMA (flash_tile.cuh says how).
//
// Both layouts are described to the kernel by 4-D TMA tensor maps
// (column in head, head, row, batch), encoded here at every launch from the
// geometry the Python wrapper passes (ops/attention.py::bhsd_geometry and
// ::packed_geometry): one body serves contiguous and packed rows, and the two
// __global__ kernels differ only in name. Block = 384 threads (two consumer
// warpgroups and the producer's), 128 q rows, one block an SM (232 registers
// a consumer thread, 168 a thread at launch, no spills).
// Shared memory a block, kBlockK K/V rows a tile, kStages tiles in the ring:
//   d = 64,  block_k 128, 4 stages: 2 * 16 KB Q + 4 * 32 KB = 160 KB (+ 1 KB slack)
//   d = 64,  block_k 64,  4 stages: 2 * 16 KB Q + 4 * 16 KB =  96 KB
//   d = 128, block_k 128, 3 stages:     32 KB Q + 3 * 64 KB = 224 KB
#include "flash_tile.cuh"

namespace {

using fd_flash::kBlockQ;
using fd_flash::kThreads;

// K/V rows a tile of the production kernels (the variants choose their own);
// ops/attention.py::BLOCK_K says the same, and make_map refuses a launch
// whose k / v boxes disagree
constexpr int kBlockK = 128;

// tiles in the K/V ring, and Q tiles a block holds (the next q block's beside
// the current one's where shared memory has the room)
template <int kHeadDim, int kBlockKV>
constexpr int kStagesFor = kHeadDim * kBlockKV >= 128 * 128 ? 3 : 4;
template <int kHeadDim>
constexpr int kQBuffersFor = kHeadDim <= 64 ? 2 : 1;
template <int kHeadDim, int kBlockKV>
using LayoutFor = fd_flash::Layout<kHeadDim, kBlockKV, kStagesFor<kHeadDim, kBlockKV>,
                                   kQBuffersFor<kHeadDim>>;

// `scale` is the softmax scale times log2 e when kBase2, the softmax scale
// otherwise (see attend_blocks). The grid is one-dimensional; each block
// walks its share of the q_blocks * planes work items (plane = batch * heads
// + head), causal ones longest first.
#define FD_FLASH_KERNEL(NAME)                                                    \
  template <int kHeadDim, int kBlockKV, bool kBase2, bool kCausal>               \
  __global__ void __launch_bounds__(kThreads, 1)                                 \
  NAME(const __grid_constant__ CUtensorMap map_q,                                \
       const __grid_constant__ CUtensorMap map_k,                                \
       const __grid_constant__ CUtensorMap map_v,                                \
       const __grid_constant__ CUtensorMap map_o, int heads, int q_blocks,       \
       int planes, int kv_len, float scale) {                                    \
    extern __shared__ unsigned char smem[];                                      \
    fd_flash::attend_blocks<kHeadDim, kBlockKV, kStagesFor<kHeadDim, kBlockKV>,  \
                            kQBuffersFor<kHeadDim>, kBase2, kCausal>(            \
        &map_q, &map_k, &map_v, &map_o, heads, q_blocks, planes, kv_len, scale,  \
        smem);                                                                   \
  }

FD_FLASH_KERNEL(flash_fwd_kernel)        // contiguous [BH, S, d] rows
FD_FLASH_KERNEL(flash_bsnd_fwd_kernel)   // packed [b, s, n*d] rows
#undef FD_FLASH_KERNEL

// One operand as the wrapper describes it: dims (column in head, head, row,
// batch), the byte strides of the last three, and the box of one TMA tile.
struct Geometry {
  uint64_t dims[4];
  uint64_t strides[3];
  uint64_t box[4];
};

// A bf16 tensor map with the 128-byte swizzle; rows past an extent read as
// zeros and are not written.
cudaError_t make_map(CUtensorMap* map, const void* base, const Geometry& g,
                     int box_rows) {
  const fd_hopper::EncodeTiled encode = fd_hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (g.box[0] != fd_flash::kPanelCols || g.box[1] != 1
      || g.box[2] != static_cast<uint64_t>(box_rows) || g.box[3] != 1)
    return cudaErrorInvalidValue;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.box[0]), 1,
                             static_cast<cuuint32_t>(g.box[2]), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), g.dims,
      g.strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Streaming multiprocessors of the current device.
cudaError_t sm_count(int device, int* count) {
  static int cached_device = -1, cached = 0;
  if (cached_device != device) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached_device = device;
  }
  *count = cached;
  return cudaSuccess;
}

// geometry: q, k, v, o in this order. Grid: with two Q buffers (d = 64) one
// block an SM, each walking its share of the work items (a q block of one
// plane), which hides an item's epilogue and the next one's first loads
// behind each other; with one Q buffer (d = 128, where shared memory has no
// room for a second) that overlap is not there and a fixed deal of items
// loses to the hardware's own scheduling of one block an item ([1,40,4096,128]
// 0.64 ms against 0.57 ms on an NVIDIA H100 80GB HBM3 at 700 W), so every item
// gets a block.
template <auto kKernel, int kQBuffers>
cudaError_t launch(size_t smem, int head_dim, int block_k,
                   const void* q, const void* k, const void* v, void* o,
                   const Geometry* geometry, float scale, cudaStream_t stream) {
  const Geometry& gq = geometry[0];
  const Geometry& gk = geometry[1];
  for (int i = 0; i < 4; ++i)
    if (geometry[i].dims[0] != static_cast<uint64_t>(head_dim)
        || geometry[i].dims[1] != gq.dims[1] || geometry[i].dims[3] != gq.dims[3]
        || geometry[i].dims[2] != (i == 0 || i == 3 ? gq : gk).dims[2])
      return cudaErrorInvalidValue;
  const uint64_t heads = gq.dims[1], q_len = gq.dims[2], kv_len = gk.dims[2];
  const uint64_t planes = heads * gq.dims[3];
  if (q_len == 0 || kv_len == 0 || q_len > INT32_MAX || kv_len > INT32_MAX
      || planes == 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_o;
  cudaError_t err = make_map(&map_q, q, geometry[0], fd_flash::kGroupRows);
  if (err == cudaSuccess) err = make_map(&map_k, k, geometry[1], block_k);
  if (err == cudaSuccess) err = make_map(&map_v, v, geometry[2], block_k);
  if (err == cudaSuccess) err = make_map(&map_o, o, geometry[3], fd_flash::kGroupRows);
  if (err != cudaSuccess) return err;
  // once per kernel (`launch` is instantiated per kernel) and device
  static int allowed_on = -1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess && allowed_on != device) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) allowed_on = device;
  }
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const uint64_t q_blocks = (q_len + kBlockQ - 1) / kBlockQ;
  const uint64_t items = q_blocks * planes;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(
      kQBuffers > 1 && items > uint64_t(sms) ? sms : items);
  kKernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, map_o, static_cast<int>(heads),
      static_cast<int>(q_blocks), static_cast<int>(planes),
      static_cast<int>(kv_len), scale);
  return cudaGetLastError();
}

#define FD_LAUNCH(NAME, D, BK, BASE2, CAUSAL)                                     \
  launch<NAME<D, BK, BASE2, CAUSAL>, kQBuffersFor<D>>(                            \
      LayoutFor<D, BK>::kSmemBytes, D, BK, q, k, v, o,                            \
      static_cast<const Geometry*>(geometry), scale, s)

}  // namespace

extern "C" {

// q, k, v, o: bf16 [batch * heads, len, head_dim] rows as `geometry` (four
// Geometry records: q, k, v, o) describes them, head_dim 64 or 128. `scale`
// is the softmax scale times log2 e. Returns a cudaError_t code.
int fd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                           const void* geometry, int head_dim, float scale,
                           int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return causal ? FD_LAUNCH(flash_fwd_kernel, 64, kBlockK, true, true)
                  : FD_LAUNCH(flash_fwd_kernel, 64, kBlockK, true, false);
  if (head_dim == 128)
    return causal ? FD_LAUNCH(flash_fwd_kernel, 128, kBlockK, true, true)
                  : FD_LAUNCH(flash_fwd_kernel, 128, kBlockK, true, false);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Packed layout: q [batch, q_len, heads*head_dim], k/v [batch, kv_len,
// heads*head_dim], bf16 with unit column stride and their own batch / row
// strides (multiples of 8 elements, base pointers 16-byte aligned); o
// contiguous [batch, q_len, heads*head_dim]; all four as `geometry`
// describes them. Non-causal. Returns a cudaError_t code.
int fd_flash_attention_bsnd_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* geometry, int head_dim,
                                float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return FD_LAUNCH(flash_bsnd_fwd_kernel, 64, kBlockK, true, false);
  if (head_dim == 128) return FD_LAUNCH(flash_bsnd_fwd_kernel, 128, kBlockK, true, false);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The variant benchmark's kernel: q, k, v, o contiguous bf16 [bh, len, 64],
// non-causal. `scale` is the softmax scale times log2 e when base2, the
// softmax scale otherwise. block_k is 64 or 128 (the boxes of k and v in
// `geometry` have as many rows). Returns a cudaError_t code.
int fd_attention_variant_fwd(const void* q, const void* k, const void* v,
                             void* o, const void* geometry, float scale,
                             int base2, int block_k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (block_k == 64)
    return base2 ? FD_LAUNCH(flash_fwd_kernel, 64, 64, true, false)
                 : FD_LAUNCH(flash_fwd_kernel, 64, 64, false, false);
  if (block_k == 128)
    return base2 ? FD_LAUNCH(flash_fwd_kernel, 64, 128, true, false)
                 : FD_LAUNCH(flash_fwd_kernel, 64, 128, false, false);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
