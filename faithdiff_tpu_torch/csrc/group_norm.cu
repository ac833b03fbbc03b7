// GroupNorm forward for Hopper (sm_90a), NCHW, fp32 statistics.
//
// Replaces: faithdiff_tpu/ops/groupnorm.py::_stats_kernel and
// ::_apply_kernel (the Pallas TPU pair launched by _fused_group_norm_fwd).
// They serve every norm of the restore path: UNet ResNets with the
// time-embedding `add` prologue and SiLU epilogue, Transformer2D input
// norms, and the VAE / denoise-encoder norms at full pixel resolution.
//
// What it computes, per (batch b, group g), v = x + add[b, c]:
//   S1 = sum v, S2 = sum v^2 (fp32); mean = S1/n, var = max(S2/n - mean^2, 0),
//   es = rsqrt(var + eps) * scale[c], eb = bias[c] - mean * es,
//   y = v * es + eb, then optional SiLU, cast to x's type.
// scale, bias and add are read in their own type (fp32, bf16 or fp16) and
// widened here, exactly as JAX's astype(float32) does.
//
// What bounds it on the card: bytes. About 5 flops per element against 4
// bytes (bf16 in and out); the floor is x read once plus y written once.
//
// Design. The launch plan (route, grid, cluster size, bytes per block,
// chunking) is made by ops/groupnorm.py::plan_group_norm; nothing here
// re-derives it. Every grid is 1-D: no grid dimension but x grows with the
// batch, so no batch is too large for a launch.
//
// - gn_fused_kernel, one launch, x read once from device memory. Each
//   (b, g) is one contiguous range of L = (C / G) * HW elements. A thread
//   block cluster of `cluster` blocks holds the whole group in shared
//   memory: block `rank` brings its slice in with 1-D bulk copies
//   (cp.async.bulk on mbarriers, a few pieces so that the sums start on the
//   first piece while the rest arrives), sums v and v^2 in fp32, and
//   publishes its pair in its own shared memory. After a cluster barrier,
//   one warp of each block reads every rank's pair through distributed
//   shared memory (mapa, one lane a rank) and folds them in rank order with
//   shuffles, so all blocks hold the same
//   statistics and the result is the same from run to run (no float
//   atomics). It then normalises its slice from shared memory and writes y
//   once with 16-byte stores. A second cluster barrier, waited on only at
//   the end, keeps every block's pair alive until all ranks have read it.
//   Taken when the group fits the cluster and the bulk copies' 16-byte
//   alignment holds (x aligned, HW a multiple of one 16-byte vector).
// - gn_stats_kernel + gn_apply_kernel, the two-pass route for groups too
//   large for a cluster (the VAE and the denoise encoder at full pixel
//   resolution: one 4-channel group at 1024x1536 px is 6.3 M elements) and
//   for shapes a bulk copy cannot take. Pass 1 splits each group into
//   chunks, one block each, and writes one partial (S1, S2) pair per chunk;
//   pass 2 runs one block per (b, c, HW segment), folds its group's
//   partials in a fixed order and normalises its segment. Loads and stores
//   are 16-byte vectors when HW allows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;        // two-pass kernels
constexpr int kFusedThreads = 256;   // fused kernel
constexpr int kMaxPieces = 4;        // bulk copies per fused block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// element i of a parameter vector of type code `dt` (0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ float load_param(const void* p, int dt, long long i) {
  switch (dt) {
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// v * sigmoid(v) with the fast exponential and division: a few
// instructions where the IEEE forms cost tens, within a bf16 step of
// v / (1 + exp(-v)); tends to -0 as v -> -inf
__device__ __forceinline__ float silu_f(float v) { return __fdividef(v, 1.f + __expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fixed-order block reduction of two sums; the result is valid in thread 0
template <int kBlock>
__device__ float2 block_sum2(float a, float b) {
  __shared__ float red[kBlock / 32][2];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[warp][0] = a;
    red[warp][1] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlock / 32; ++w) {
      r.x += red[w][0];
      r.y += red[w][1];
    }
  }
  return r;
}

// ---- cluster primitives (inline PTX) ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory word in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// global -> this block's shared memory, `bytes` (a multiple of 16, both
// addresses 16-byte aligned) counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Grid (B*G*cluster) blocks in clusters of `cluster` (at most 32); cluster
// bg = b*G + g holds group (b, g). Dynamic shared memory, in this order:
// the slice (slice_len elements, a multiple of 16 bytes), kMaxPieces
// mbarriers, the block's (S1, S2), (mean, rstd), then add, scale and bias
// of the group's cpg channels, widened to fp32.
template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
gn_fused_kernel(const T* __restrict__ x, const void* __restrict__ add, int add_dt,
                const void* __restrict__ scale, int scale_dt,
                const void* __restrict__ bias, int bias_dt, T* __restrict__ y,
                int HW, int C, int cpg, int G, int L, int slice_len, int piece_len,
                float n, float eps, int silu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(slice_len) * sizeof(T));
  float* part = reinterpret_cast<float*>(bars + kMaxPieces);
  float* stat = part + 2;
  float* s_add = stat + 2;
  float* s_scale = s_add + cpg;
  float* s_bias = s_scale + cpg;

  const uint32_t rank = cluster_rank(), nrank = cluster_size();
  const int bg = blockIdx.x / nrank;
  const int b = bg / G, g = bg % G;
  const int start = static_cast<int>(rank) * slice_len;
  const int len = max(0, min(L, start + slice_len) - start);
  const int n_pieces = (len + piece_len - 1) / piece_len;
  const T* xg = x + static_cast<long long>(bg) * L + start;
  T* yg = y + static_cast<long long>(bg) * L + start;
  const long long c0 = static_cast<long long>(g) * cpg;
  const unsigned hw = static_cast<unsigned>(HW);

  if (threadIdx.x == 0) {
    for (int p = 0; p < n_pieces; ++p) fd_hopper::mbar_init(fd_hopper::smem_u32(&bars[p]), 1);
    fd_hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < n_pieces; ++p) {
      const int off = p * piece_len;
      const uint32_t bytes = static_cast<uint32_t>(min(piece_len, len - off)) * sizeof(T);
      const uint32_t bar = fd_hopper::smem_u32(&bars[p]);
      fd_hopper::mbar_expect_tx(bar, bytes);
      bulk_load(fd_hopper::smem_u32(xs + off), xg + off, bytes, bar);
    }
  }
  // the group's channel parameters, fetched while the slice streams in
  for (int k = threadIdx.x; k < cpg; k += kFusedThreads) {
    s_add[k] = add ? load_param(add, add_dt, static_cast<long long>(b) * C + c0 + k) : 0.f;
    s_scale[k] = load_param(scale, scale_dt, c0 + k);
    s_bias[k] = load_param(bias, bias_dt, c0 + k);
  }
  __syncthreads();

  // sums over the slice, piece by piece as the copies land; a vector of V
  // elements never straddles a channel (HW % V == 0)
  float s1 = 0.f, s2 = 0.f;
  for (int p = 0; p < n_pieces; ++p) {
    fd_hopper::mbar_wait(fd_hopper::smem_u32(&bars[p]), 0);
    const int end = min(len, (p + 1) * piece_len);
    for (int i = p * piece_len + threadIdx.x * V; i < end; i += kFusedThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const float a = s_add[static_cast<unsigned>(start + i) / hw];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f(e[j]) + a;
        s1 += v;
        s2 += v * v;
      }
    }
  }
  const float2 r = block_sum2<kFusedThreads>(s1, s2);
  if (threadIdx.x == 0) {
    part[0] = r.x;
    part[1] = r.y;
  }
  cluster_arrive();          // publishes this block's pair to the cluster
  cluster_wait();
  if (threadIdx.x < 32) {
    // lane q reads rank q's pair; lane 0 folds them in rank order, so
    // every block of the cluster holds the same sums
    const uint32_t lane = threadIdx.x;
    float p1 = 0.f, p2 = 0.f;
    if (lane < nrank) {
      const uint32_t theirs = map_rank(fd_hopper::smem_u32(part), lane);
      p1 = ld_cluster(theirs);
      p2 = ld_cluster(theirs + 4);
    }
    float t1 = 0.f, t2 = 0.f;
    for (uint32_t q = 0; q < nrank; ++q) {
      t1 += __shfl_sync(0xffffffffu, p1, q);
      t2 += __shfl_sync(0xffffffffu, p2, q);
    }
    if (lane == 0) {
      const float mean = t1 / n;
      const float var = fmaxf(t2 / n - mean * mean, 0.f);
      stat[0] = mean;
      stat[1] = rsqrtf(var + eps);
    }
  }
  cluster_arrive();          // done reading the other ranks' pairs
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];

  for (int i = threadIdx.x * V; i < len; i += kFusedThreads * V) {
    uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    T* e = reinterpret_cast<T*>(&raw);
    const unsigned k = static_cast<unsigned>(start + i) / hw;
    const float a = s_add[k];
    const float es = rstd * s_scale[k];
    const float eb = s_bias[k] - mean * es;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = (to_f(e[j]) + a) * es + eb;
      if (silu) v = silu_f(v);
      e[j] = from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(yg + i) = raw;
  }
  cluster_wait();            // no block leaves while a rank may still read its pair
}

// grid (B*G*n_chunks): block i sums chunk i % n_chunks of group
// bg = i / n_chunks, the contiguous range x[bg * L, (bg + 1) * L),
// L = (C / G) * HW.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, const void* __restrict__ add, int add_dt,
                float* __restrict__ partial, long long L, long long HW, int C,
                int cpg, int G, long long chunk_len, int n_chunks) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  const long long bg = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const long long b = bg / G, g = bg % G;
  const T* xg = x + bg * L;
  const long long add0 = b * C + g * cpg;
  const long long start = static_cast<long long>(chunk) * chunk_len;
  const long long end = min(L, start + chunk_len);
  float s1 = 0.f, s2 = 0.f;
  for (long long i = start + static_cast<long long>(threadIdx.x) * V; i < end;
       i += static_cast<long long>(kThreads) * V) {
    // V elements never straddle a channel
    const float a = add ? load_param(add, add_dt, add0 + i / HW) : 0.f;
    if constexpr (kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xg + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f(e[j]) + a;
        s1 += v;
        s2 += v * v;
      }
    } else {
      const float v = to_f(xg[i]) + a;
      s1 += v;
      s2 += v * v;
    }
  }
  const float2 r = block_sum2<kThreads>(s1, s2);
  if (threadIdx.x == 0) {
    const long long p = (bg * n_chunks + chunk) * 2;
    partial[p] = r.x;
    partial[p + 1] = r.y;
  }
}

// grid (B*C*n_segments): block i folds group g = c / cpg's partials, then
// normalises segment i % n_segments of row bc = i / n_segments = b*C + c.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const void* __restrict__ add, int add_dt,
                const float* __restrict__ partial, const void* __restrict__ scale,
                int scale_dt, const void* __restrict__ bias, int bias_dt,
                T* __restrict__ y, long long HW, int C, int cpg, int G, int n_chunks,
                float n, float eps, int silu, long long seg_len, int n_segments) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  __shared__ float s_es, s_eb;
  const long long bc = blockIdx.x / n_segments;
  const int seg = blockIdx.x % n_segments;
  const long long b = bc / C;
  const int c = static_cast<int>(bc % C);
  const long long bg = b * G + c / cpg;
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n_chunks; i += 32) {
      s1 += partial[(bg * n_chunks + i) * 2];
      s2 += partial[(bg * n_chunks + i) * 2 + 1];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      const float mean = s1 / n;
      const float var = fmaxf(s2 / n - mean * mean, 0.f);
      const float es = rsqrtf(var + eps) * load_param(scale, scale_dt, c);
      s_es = es;
      s_eb = load_param(bias, bias_dt, c) - mean * es;
    }
  }
  __syncthreads();
  const float es = s_es, eb = s_eb;
  const float a = add ? load_param(add, add_dt, bc) : 0.f;
  const T* xr = x + bc * HW;
  T* yr = y + bc * HW;
  const long long start = static_cast<long long>(seg) * seg_len;
  const long long end = min(HW, start + seg_len);
  for (long long i = start + static_cast<long long>(threadIdx.x) * V; i < end;
       i += static_cast<long long>(kThreads) * V) {
    if constexpr (kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = (to_f(e[j]) + a) * es + eb;
        if (silu) v = silu_f(v);
        e[j] = from_f<T>(v);
      }
      *reinterpret_cast<uint4*>(yr + i) = raw;
    } else {
      float v = (to_f(xr[i]) + a) * es + eb;
      if (silu) v = silu_f(v);
      yr[i] = from_f<T>(v);
    }
  }
}

struct Params {
  const void* add;
  int add_dt;
  const void* scale;
  int scale_dt;
  const void* bias;
  int bias_dt;
};

template <typename T>
int launch_fused(const void* x, Params p, void* y, long long B, long long C,
                 long long HW, int G, long long grid, int cluster, long long slice_len,
                 long long piece_len, int smem_bytes, float eps, int silu,
                 cudaStream_t stream) {
  const int cpg = static_cast<int>(C / G);
  const long long L = cpg * HW;
  if (grid <= 0 || grid > INT32_MAX || cluster <= 0 || cluster > 32 || grid % cluster
      || L > INT32_MAX || slice_len <= 0 || piece_len <= 0
      || (slice_len + piece_len - 1) / piece_len > kMaxPieces)
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory and cluster-size limits once per
  // device, or again when a launch needs more shared memory
  static int set_device = -1, set_bytes = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device != set_device || smem_bytes > set_bytes)) {
    err = cudaFuncSetAttribute(gn_fused_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gn_fused_kernel<T>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      set_bytes = device == set_device ? std::max(set_bytes, smem_bytes) : smem_bytes;
      set_device = device;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, gn_fused_kernel<T>, static_cast<const T*>(x), p.add, p.add_dt, p.scale,
      p.scale_dt, p.bias, p.bias_dt, static_cast<T*>(y), static_cast<int>(HW),
      static_cast<int>(C), cpg, G, static_cast<int>(L), static_cast<int>(slice_len),
      static_cast<int>(piece_len), static_cast<float>(L), eps, silu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stats(const void* x, Params p, float* partial, long long C, long long HW,
                 int G, long long grid, long long chunk_len, int n_chunks, int vec,
                 cudaStream_t stream) {
  if (grid <= 0 || grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = static_cast<int>(C / G);
  const long long L = cpg * HW;
  const T* xt = static_cast<const T*>(x);
  const unsigned blocks = static_cast<unsigned>(grid);
  if (vec) {
    gn_stats_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, p.add, p.add_dt, partial, L, HW, static_cast<int>(C), cpg, G, chunk_len,
        n_chunks);
  } else {
    gn_stats_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, p.add, p.add_dt, partial, L, HW, static_cast<int>(C), cpg, G, chunk_len,
        n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x, Params p, const float* partial, void* y, long long C,
                 long long HW, int G, int n_chunks, long long grid, long long seg_len,
                 int n_segments, float eps, int silu, int vec, cudaStream_t stream) {
  if (grid <= 0 || grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = static_cast<int>(C / G);
  const float n = static_cast<float>(cpg * HW);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const unsigned blocks = static_cast<unsigned>(grid);
  if (vec) {
    gn_apply_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xt, p.add, p.add_dt, partial, p.scale, p.scale_dt, p.bias, p.bias_dt, yt, HW,
        static_cast<int>(C), cpg, G, n_chunks, n, eps, silu, seg_len, n_segments);
  } else {
    gn_apply_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xt, p.add, p.add_dt, partial, p.scale, p.scale_dt, p.bias, p.bias_dt, yt, HW,
        static_cast<int>(C), cpg, G, n_chunks, n, eps, silu, seg_len, n_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Type codes: 0 float32, 1 bfloat16, 2 float16. x, y: contiguous [B, C, HW]
// of type `dtype`; add: [B, C] or null, scale, bias: [C], each of its own
// type code. partial: fp32 [B*G, n_chunks, 2] (S1, S2 per chunk). `grid`,
// `cluster`, the slice, piece, chunk and segment lengths and `smem_bytes`
// come from the launch plan. Each call launches one kernel on `stream` and
// returns a cudaError_t code (0 on success).
int fd_group_norm_fused(int dtype, const void* x, const void* add, int add_dt,
                        const void* scale, int scale_dt, const void* bias,
                        int bias_dt, void* y, long long B, long long C, long long HW,
                        int G, long long grid, int cluster, long long slice_len,
                        long long piece_len, int smem_bytes, float eps, int silu,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{add, add_dt, scale, scale_dt, bias, bias_dt};
  switch (dtype) {
    case 0: return launch_fused<float>(x, p, y, B, C, HW, G, grid, cluster, slice_len, piece_len, smem_bytes, eps, silu, s);
    case 1: return launch_fused<__nv_bfloat16>(x, p, y, B, C, HW, G, grid, cluster, slice_len, piece_len, smem_bytes, eps, silu, s);
    case 2: return launch_fused<__half>(x, p, y, B, C, HW, G, grid, cluster, slice_len, piece_len, smem_bytes, eps, silu, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int fd_group_norm_stats(int dtype, const void* x, const void* add, int add_dt,
                        float* partial, long long C, long long HW, int G,
                        long long grid, long long chunk_len, int n_chunks, int vec,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{add, add_dt, nullptr, 0, nullptr, 0};
  switch (dtype) {
    case 0: return launch_stats<float>(x, p, partial, C, HW, G, grid, chunk_len, n_chunks, vec, s);
    case 1: return launch_stats<__nv_bfloat16>(x, p, partial, C, HW, G, grid, chunk_len, n_chunks, vec, s);
    case 2: return launch_stats<__half>(x, p, partial, C, HW, G, grid, chunk_len, n_chunks, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int fd_group_norm_apply(int dtype, const void* x, const void* add, int add_dt,
                        const float* partial, const void* scale, int scale_dt,
                        const void* bias, int bias_dt, void* y, long long C,
                        long long HW, int G, int n_chunks, long long grid,
                        long long seg_len, int n_segments, float eps, int silu,
                        int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{add, add_dt, scale, scale_dt, bias, bias_dt};
  switch (dtype) {
    case 0: return launch_apply<float>(x, p, partial, y, C, HW, G, n_chunks, grid, seg_len, n_segments, eps, silu, vec, s);
    case 1: return launch_apply<__nv_bfloat16>(x, p, partial, y, C, HW, G, n_chunks, grid, seg_len, n_segments, eps, silu, vec, s);
    case 2: return launch_apply<__half>(x, p, partial, y, C, HW, G, n_chunks, grid, seg_len, n_segments, eps, silu, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
