// Kernel K2: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dcos_commons_tpu/ops/attention.py::_fwd_kernel
// (launched by _pallas_attention): o = softmax(scale * q k^T) v per
// (batch*head), scale = head_dim^-0.5 on f32 scores, causal mask
// top-left aligned (query i sees keys j <= i, also when seq_q != seq_k),
// optional lse = m + log(l) per query row, stored as [bh, seq_q] f32.
//
// What bounds it on the H100: at serving prompt lengths (s ~ 100..1000,
// head_dim 128) the work is 4*s*s*hd flops per head (halved by the causal
// skip) against 4*s*hd*2 bytes of q, k, v, o — s/2 flops a byte in bf16,
// past the memory ridge for s above a few hundred, so the tensor-core
// rate is the bound.  This first version does not reach it: it computes
// in f32 FMA on the CUDA cores (no mma/wgmma, no TMA), which is a later
// PR's work.  What its design does keep: the s x s score matrix never
// leaves the block.  One block of 128 threads owns a 64-row Q tile; K
// and V stream through shared memory in 64-row tiles; an online softmax
// (running max m, sum l, f32 accumulator in registers) folds each tile
// in; K tiles wholly in the future of the Q tile are never loaded.  The
// ragged edges of seq_q and seq_k are masked inside the kernel, so any
// prompt length runs (the TPU launcher needed seq % block == 0).
//
// Plain C interface for ctypes (see ops/attention.py): flash_fwd returns
// a cudaError_t, 0 on success; the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 x 8 grid of threads over each tile
constexpr float kNeg = -1e30f;  // the JAX kernel's initial running max
#define kNegInf __uint_as_float(0xff800000u)  // -inf: a masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles with a padded row (HD + 1 floats: rows fall on
  // different banks), V tile, the score tile (64 + 1 columns) and the
  // per-row m, l, alpha
  return sizeof(float) * (2 * kBlockQ * (HD + 1) + kBlockK * HD +
                          kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq_q, int seq_k,
                     int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LS = kBlockK + 1;
  constexpr int kRows = kBlockQ / 8;   // rows per thread: ty + 8 * r
  constexpr int kKeys = kBlockK / 16;  // keys per thread: tx + 16 * c
  constexpr int kCols = HD / 16;       // output columns: tx + 16 * c

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * LD;
  float* vs = ks + kBlockK * LD;
  float* ss = vs + kBlockK * HD;
  float* m_s = ss + kBlockQ * LS;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * seq_q * HD;
  const T* kb = k + bh * seq_k * HD;
  const T* vb = v + bh * seq_k * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int qi = q0 + r;
    qs[r * LD + c] = qi < seq_q ? to_float(qb[(size_t)qi * HD + c]) : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  int n_tiles = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) {
    // the tile's last real query row sees keys up to its own index
    const int last = min(q0 + kBlockQ, seq_q);
    n_tiles = min(n_tiles, (last + kBlockK - 1) / kBlockK);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const int kj = k0 + r;
      const bool in = kj < seq_k;
      ks[r * LD + c] = in ? to_float(kb[(size_t)kj * HD + c]) : 0.f;
      vs[r * HD + c] = in ? to_float(vb[(size_t)kj * HD + c]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's 8 rows x 4 keys; masked keys get -inf so
    // their probability is exactly 0 whatever the running max is
    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qs[(ty + 8 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kv[c] = ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 8 * r;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int key = tx + 16 * c;
        const int kj = k0 + key;
        const bool valid = kj < seq_k && (!causal || q0 + row >= kj);
        ss[row * LS + key] = valid ? s[r][c] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one thread per row: new max, p = exp(s - m), the
    // rescale factor alpha for what was accumulated before
    if (tid < kBlockQ) {
      float* row = ss + tid * LS;
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int j = 0; j < kBlockK; ++j) m_new = fmaxf(m_new, row[j]);
      float sum = 0.f;
      for (int j = 0; j < kBlockK; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's 8 rows x HD/16 columns
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float alpha = a_s[ty + 8 * r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ss[(ty + 8 * r) * LS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] += pv[r] * vv[c];
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 8 * r;
    const int qi = q0 + row;
    if (qi >= seq_q) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    T* ob = o + (bh * seq_q + qi) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) ob[tx + 16 * c] = from_float<T>(acc[r][c] / l);
  }
  if (lse != nullptr && tid < kBlockQ && q0 + tid < seq_q) {
    lse[bh * seq_q + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int seq_q, int seq_k, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq_q, seq_k, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q [bh, seq_q, head_dim], k and v
// [bh, seq_k, head_dim], o like q, all contiguous; lse [bh, seq_q] f32
// or null.  Returns a cudaError_t (cudaErrorInvalidValue for a dtype or
// head_dim the kernel does not take).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int bh, int seq_q, int seq_k, int head_dim, int dtype,
              int causal, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse_f, bh, seq_q, seq_k,
                                     causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse_f, bh, seq_q, seq_k,
                                      causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
