// LayerNorm forward for Hopper (sm_90a) over the last dim, fp32 statistics.
//
// Replaces: no Pallas kernel. The JAX package's LayerNorm
// (faithdiff_tpu/models/layers.py::LayerNorm) is one XLA fusion there; in
// eager PyTorch the same formula is a chain of 16 kernels on fp32
// temporaries, about 60 bytes moved an element. It serves every LayerNorm
// of the UNet's transformer blocks (three a block) and of the FaithDiff
// information transformer (two a layer), and of the CLIP towers and the
// IQA nets.
//
// What it computes, per row x of d elements:
//   S1 = sum x_j, S2 = sum x_j^2 (fp32); mean = S1/d, var = max(S2/d - mean^2, 0),
//   y_j = (x_j - mean) * rsqrt(var + eps) * w_j + b_j, cast to x's type.
// w and b are read in their own type (fp32, bf16 or fp16) and widened here,
// as JAX's astype(float32) does.
//
// What bounds it on the card: bytes. About 8 flops an element against
// 4 bytes (bf16 in and out); the floor is x read once plus y written once.
//
// Design. ops/layernorm.py::plan_layer_norm makes the launch plan (threads
// a row, vectors a thread, 16-byte or element loads, the grid); nothing
// here re-derives it. Blocks of kThreads threads on a 1-D grid, so any row
// count launches. A row is held by `tpr` threads (a power of two, 1 to
// kThreads), kThreads / tpr rows a block. Thread t of a row holds the
// vectors t, t + tpr, ..., `items` of them (at most kMaxItems) of
// kVec = 16 / sizeof(T) elements, in registers as they were loaded: 16-byte
// loads where the plan allows (x and the row stride on 16 bytes, d a whole
// number of vectors), else element loads masked at d. Each thread sums its
// elements in order; the row's threads fold their two sums with xor
// shuffles (every lane ends with the same bits), then, where a row spans
// warps, warp by warp in order through shared memory: the same bits on
// every launch, no atomics. The thread then normalises what it holds and
// writes y once, with 16-byte stores where it loaded 16 bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxItems = 8;
// resident blocks an SM the 16-byte kernels are compiled for: 4 (at most 64
// registers a thread) up to 5 vectors a thread, fewer above, where 64
// registers would spill. More rows in flight hide device-memory latency:
// at [12288, 1280] bf16 on an H100, 2 blocks an SM ran 1.49x the bytes
// bound, 4 blocks 1.45x, 4 blocks with evict-first loads of x 1.31x
// (torch's own copy of x: 1.21x)
constexpr int blocks_per_sm(int items) { return items <= 5 ? 4 : items <= 7 ? 3 : 2; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// N consecutive parameters of type P from p (16-byte aligned where N
// elements fill whole 16- or 8-byte words), widened to fp32
template <typename P, int N>
__device__ __forceinline__ void load_span(const P* p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(P));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(P));
#pragma unroll
    for (int q = 0; q < N / kPer; ++q) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[q * kPer + j] = to_f(e[j]);
    }
  } else if constexpr (kBytes % 8 == 0) {
    constexpr int kPer = 8 / static_cast<int>(sizeof(P));
#pragma unroll
    for (int q = 0; q < N / kPer; ++q) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p) + q);
      const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[q * kPer + j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(p[j]);
  }
}

// x is read once: evict-first, so that it leaves L2 to y and the weights
__device__ __forceinline__ uint4 load_x(const uint4* p) { return __ldcs(p); }

// element i of a parameter vector of type code `dt` (0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ float load_param(const void* p, int dt, int i) {
  switch (dt) {
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// parameters e0 .. e0 + N - 1 of type code `dt`: one span (VECTOR: N
// divides d, p on 16 bytes) or elements, 0 past d
template <int N, bool VECTOR>
__device__ __forceinline__ void load_params(const void* p, int dt, int e0, int d,
                                            float (&out)[N]) {
  if constexpr (VECTOR) {
    switch (dt) {
      case 1: load_span(static_cast<const __nv_bfloat16*>(p) + e0, out); break;
      case 2: load_span(static_cast<const __half*>(p) + e0, out); break;
      default: load_span(static_cast<const float*>(p) + e0, out); break;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = e0 + j < d ? load_param(p, dt, e0 + j) : 0.f;
  }
}

// VECTOR: 16-byte loads and stores, ITEMS vectors a thread (the plan's
// `items`). Else element loads masked at d, ITEMS = kMaxItems and the
// plan's `items` a bound checked at run time: one instance a type.
template <typename T, int ITEMS, bool VECTOR>
__global__ void __launch_bounds__(kThreads, VECTOR ? blocks_per_sm(ITEMS) : 1)
layer_norm_fwd_kernel(const T* __restrict__ x, long long row_stride,
                      const void* __restrict__ w, int w_dt,
                      const void* __restrict__ b, int b_dt, T* __restrict__ y,
                      long long rows, int d, int tpr, int items, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if constexpr (VECTOR) items = ITEMS;
  const int t = threadIdx.x & (tpr - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / tpr) + threadIdx.x / tpr;
  const bool valid = row < rows;
  const T* xr = x + (valid ? row : 0) * row_stride;

  // the thread's vectors, as loaded (zeros past d and in rows past the end)
  uint4 raw[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    const int e0 = (t + k * tpr) * kVec;
    if (k < items && valid && e0 < d) {
      if constexpr (VECTOR) {
        raw[k] = load_x(reinterpret_cast<const uint4*>(xr + e0));
      } else {
        T* e = reinterpret_cast<T*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (e0 + j < d) e[j] = xr[e0 + j];
      }
    }
  }

  // the thread's sums in order, then the row's fold
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k < items) {
      const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float v = to_f(e[j]);
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
  }
  for (int o = (tpr < 32 ? tpr : 32) / 2; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (tpr > 32) {  // uniform over the block
    __shared__ float red[kThreads / 32][2];
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
      red[warp][0] = s1;
      red[warp][1] = s2;
    }
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr / 32);
    s1 = red[first][0];
    s2 = red[first][1];
    for (int i = 1; i < tpr / 32; ++i) {
      s1 += red[first + i][0];
      s2 += red[first + i][1];
    }
  }
  const float mean = s1 / static_cast<float>(d);
  const float var = fmaxf(s2 / static_cast<float>(d) - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  if (!valid) return;
  T* yr = y + row * static_cast<long long>(d);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e0 = (t + k * tpr) * kVec;
    if (k < items && e0 < d) {
      float wv[kVec], bv[kVec];
      load_params<kVec, VECTOR>(w, w_dt, e0, d, wv);
      load_params<kVec, VECTOR>(b, b_dt, e0, d, bv);
      // x again from the registers it was loaded into: the empty asm hides
      // the first widening from the compiler, so it keeps `raw` alive
      // between the sums and here (4 registers a vector), not the widened
      // values (8 a bf16 vector): more rows in flight an SM
      uint4 held = raw[k];
      asm volatile("" : "+r"(held.x), "+r"(held.y), "+r"(held.z), "+r"(held.w));
      const T* e = reinterpret_cast<const T*>(&held);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        o[j] = from_f<T>(fmaf((to_f(e[j]) - mean) * rstd, wv[j], bv[j]));
      if constexpr (VECTOR) {
        *reinterpret_cast<uint4*>(yr + e0) = out;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (e0 + j < d) yr[e0 + j] = o[j];
      }
    }
  }
}

constexpr int vec_of(int dtype) { return dtype == 0 ? 4 : 8; }

template <typename T>
cudaError_t launch(const void* x, long long row_stride, const void* w, int w_dt,
                   const void* b, int b_dt, void* y, long long rows, int d, int tpr,
                   int items, int vector, long long grid, float eps,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const unsigned blocks = static_cast<unsigned>(grid);
#define FD_LN_VECTOR(n)                                                          \
  case n:                                                                         \
    layer_norm_fwd_kernel<T, n, true><<<blocks, kThreads, 0, stream>>>(           \
        xt, row_stride, w, w_dt, b, b_dt, yt, rows, d, tpr, items, eps);          \
    break;
  if (vector) {
    switch (items) {
      FD_LN_VECTOR(1) FD_LN_VECTOR(2) FD_LN_VECTOR(3) FD_LN_VECTOR(4)
      FD_LN_VECTOR(5) FD_LN_VECTOR(6) FD_LN_VECTOR(7) FD_LN_VECTOR(8)
      default: return cudaErrorInvalidValue;
    }
  } else {
    layer_norm_fwd_kernel<T, kMaxItems, false><<<blocks, kThreads, 0, stream>>>(
        xt, row_stride, w, w_dt, b, b_dt, yt, rows, d, tpr, items, eps);
  }
#undef FD_LN_VECTOR
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Type codes: 0 float32, 1 bfloat16, 2 float16. x: `rows` rows of `d`
// elements of type `dtype`, unit column stride, `row_stride` elements
// apart; y: contiguous [rows, d] of the same type; w, b: [d], each of its
// own type code. `tpr` (threads a row), `items` (vectors a thread),
// `vector` (16-byte loads and stores) and `grid` come from the launch plan.
// Launches one kernel on `stream` of CUDA device `device` (made current for
// the launch, then restored) and returns a cudaError_t code (0 on success).
int fd_layer_norm(int dtype, const void* x, long long row_stride, const void* w,
                  int w_dt, const void* b, int b_dt, void* y, long long rows, int d,
                  int tpr, int items, int vector, long long grid, float eps,
                  int device, void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vec_of(dtype);
  if (rows <= 0 || d <= 0 || row_stride < 0 || tpr < 1 || tpr > kThreads
      || (tpr & (tpr - 1)) || items < 1 || items > kMaxItems
      || static_cast<long long>(tpr) * items * vec < d || grid <= 0 || grid > INT32_MAX
      || grid * (kThreads / tpr) < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && (d % vec || row_stride % vec || !aligned16(x) || !aligned16(y)
                 || !aligned16(w) || !aligned16(b)))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(x, row_stride, w, w_dt, b, b_dt, y, rows, d, tpr, items, vector, grid, eps, s); break;
    case 1: err = launch<__nv_bfloat16>(x, row_stride, w, w_dt, b, b_dt, y, rows, d, tpr, items, vector, grid, eps, s); break;
    default: err = launch<__half>(x, row_stride, w, w_dt, b, b_dt, y, rows, d, tpr, items, vector, grid, eps, s); break;
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
