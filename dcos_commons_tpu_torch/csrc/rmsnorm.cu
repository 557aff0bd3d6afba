// Kernel K1: RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dcos_commons_tpu/ops/rmsnorm.py::_kernel
// (launched by _pallas_rms_norm): y = x * rsqrt(mean(x^2) + eps) * w over
// the last axis of x [rows, d], statistics in f32, output in x's dtype
// (f32, bf16 or f16; w of the same dtype).
//
// What bounds it on the H100: memory.  Each element is read once and
// written once (2 bytes each way in bf16) for about four flops, two
// orders of magnitude under the card's flop/byte ridge, so the least
// time is the bytes over 3.35 TB/s.  At the decode step's [8, 2048] and
// the train worker's [4096, 2048] that is 0.02-10 us of device work, so
// the host's cost of a launch decides the time: the kernel has a plain C
// entry point called through ctypes, not a Python launcher.
//
// Design: one warp a row, 8 rows (256 threads) a block.  Each lane loads
// its share of the row with 16-byte vector loads, all issued before the
// first is used (at d = 2048 bf16: 8 loads a lane, held in registers),
// sums their squares in f32, reduces across the warp with
// __shfl_xor_sync (no shared memory, no __syncthreads), and stores the
// scaled row once, each vector of w read beside it.  A width that is not
// a multiple of the vector, a pointer that is not 16-byte aligned, or a
// row wider than 32 x kMaxVec = 512 vectors (4096 bf16 or f16 elements,
// 2048 f32) takes a scalar loop in the same kernel (NV = 0), which reads
// the row twice, the second time from L1.  Any row count works (the TPU
// launcher needed rows % 256 == 0 and fell back otherwise).
//
// The backward recomputes through autograd on the plain version, as the
// JAX package's custom VJP does (no backward kernel exists there).
//
// Plain C interface for ctypes (see ops/rmsnorm.py): rmsnorm_fwd returns
// a cudaError_t, 0 on success; the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 8;             // rows of a block, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kMaxVec = 16;          // 16-byte vectors a lane may hold

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// NV > 0: each lane holds up to NV 16-byte vectors of its row in
// registers (vector v of the row at lane v % 32); NV == 0: the scalar
// loop.  The products in the plain version's order:
// (x * rsqrt(mean + eps)) * w.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rms_norm_rows(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int rows, int d, float eps) {
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;

  if constexpr (NV == 0) {
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float f = to_float(xr[c]);
      ss += f * f;
    }
    const float inv = rsqrtf(warp_sum(ss) / d + eps);
    for (int c = lane; c < d; c += 32)
      yr[c] = from_float<T>(to_float(xr[c]) * inv * to_float(w[c]));
  } else {
    constexpr int E = 16 / sizeof(T);  // elements of a vector
    const int n_vec = d / E;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4 buf[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      buf[i] = v < n_vec ? xv[v] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float f = to_float(e[k]);
        ss += f * f;
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / d + eps);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < n_vec) {
        const uint4 wb = wv[v];
        const T* xe = reinterpret_cast<const T*>(&buf[i]);
        const T* we = reinterpret_cast<const T*>(&wb);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < E; ++k)
          oe[k] = from_float<T>(to_float(xe[k]) * inv * to_float(we[k]));
        yv[v] = out;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(y);
  // vectors a lane holds: the fewest of 1, 2, 4, 8, 16 that cover the
  // row; 0 (the scalar loop) when the row does not split into aligned
  // vectors or is too wide
  int nv = 0;
  if (d % E == 0 && (any & 15) == 0) {
    const int n_vec = d / E;
    for (int c = 1; c <= kMaxVec && nv == 0; c *= 2)
      if (n_vec <= 32 * c) nv = c;
  }
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  const dim3 grid((rows + kRows - 1) / kRows);
  switch (nv) {
    case 1:
      rms_norm_rows<T, 1><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows, d,
                                                          eps);
      break;
    case 2:
      rms_norm_rows<T, 2><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows, d,
                                                          eps);
      break;
    case 4:
      rms_norm_rows<T, 4><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows, d,
                                                          eps);
      break;
    case 8:
      rms_norm_rows<T, 8><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows, d,
                                                          eps);
      break;
    case 16:
      rms_norm_rows<T, 16><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows,
                                                           d, eps);
      break;
    default:
      rms_norm_rows<T, 0><<<grid, kThreads, 0, stream>>>(xt, wt, yt, rows, d,
                                                          eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x and y [rows, d]
// contiguous, w [d], all of that dtype; rows >= 1.  Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype the kernel does not take).
int rmsnorm_fwd(const void* x, const void* w, void* y, int rows, int d,
                int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (dtype == 2) return launch<__half>(x, w, y, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
