// Kernels K3 and K4: flash-attention backward for Hopper (sm_90a).
//
// K3 (flash_dq_kernel) replaces the TPU kernel
// dcos_commons_tpu/ops/attention.py::_dq_kernel, K4 (flash_dkv_kernel)
// replaces ::_dkv_kernel; both were launched by _pallas_attention_bwd.
// From the forward's saved lse [bh, seq_q] f32 and di = rowsum(do * o)
// [bh, seq_q] f32 (computed by the caller, as the JAX package computes
// it outside its kernels):
//
//   s  = scale * q k^T                 (f32, q streamed unscaled)
//   p  = exp(s - lse), exactly 0 where masked
//   dp = do v^T
//   ds = p * (dp - di)
//   dq = scale * ds k                  K3: one block per (bh, Q tile)
//   dv = p^T do,  dk = scale * ds^T q  K4: one block per (bh, K tile)
//
// ds (K3) and p, ds (K4) are rounded to the operand dtype before their
// products, as the TPU kernels round them (ds.astype(k.dtype),
// p.astype(do.dtype), ds.astype(q.dtype)); every sum is f32.  The
// causal mask is top-left aligned (query i sees keys j <= i).  K3's
// K loop ends at the Q tile's last real row; K4's Q loop starts at the
// first Q tile that can see its K tile, so tiles wholly in the future
// are never loaded.  The ragged edges of seq_q and seq_k are masked in
// both kernels: any length runs (the TPU launcher needed
// seq % block == 0 and fell back otherwise).
//
// Two kernels and no atomics, as the JAX package has: every output
// element is written by exactly one block, so results are the same run
// to run.  K3 recomputes s and dp for each (Q, K) tile pair that K4
// also computes; FlashAttention-2's single kernel with atomic dq saves
// that at the price of determinism, and is left out on purpose.
//
// What bounds them on the H100: K3 does 6*hd flops per visible (q, k)
// pair and K4 8*hd, against 4-6 tensors of [bh, s, hd] bytes, so at
// training lengths (s = 2048, hd = 128) both are past the memory ridge
// and the tensor-core rate is the bound.  This first version does not
// reach it: it computes in f32 FMA on the CUDA cores (no mma/wgmma, no
// TMA), which is a later PR's work.  What its design does keep: the
// s x s probability and gradient matrices never leave the block.
//
// Tiles and registers: 64-row Q and K tiles, 256 threads as a 16 x 16
// grid.  Each thread owns 4 rows x hd/16 columns of each f32
// accumulator (K3: dq, 32 registers at hd 128; K4: dk and dv, 64) and
// 4 x 4 entries of s and dp.  A 128-thread block would hold 128
// accumulator registers a thread in K4 before anything else.  Tiles
// stage in shared memory as f32 with a padded row (hd + 1 floats, so
// rows fall on different banks): K3 149,248 bytes and K4 165,888 at
// hd 128, opted in with cudaFuncSetAttribute; one block per SM.
//
// Plain C interface for ctypes (see ops/attention.py): each entry
// point returns a cudaError_t, 0 on success; the caller raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 64;     // rows of a Q tile and of a K tile
constexpr int kThreads = 256;  // 16 x 16 grid of threads over each tile
constexpr int kLS = kBlock + 1;

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
// x rounded to T and read back: the operand-dtype cast before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [r0, r0 + kBlock) of a [seq, HD] matrix into a padded f32 tile;
// rows past seq read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int seq) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int row = r0 + r;
    dst[r * LD + c] = row < seq ? to_float(src[(size_t)row * HD + c]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int seq) {
  if (threadIdx.x < kBlock) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < seq ? src[row] : 0.f;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles, the ds tile, lse and di
  return sizeof(float) *
         (4 * kBlock * (HD + 1) + kBlock * kLS + 2 * kBlock);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the p^T and ds^T tiles, lse and di
  return sizeof(float) *
         (4 * kBlock * (HD + 1) + 2 * kBlock * kLS + 2 * kBlock);
}

// K3: dq for one 64-row Q tile, streaming K/V tiles
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq,
                    int seq_q, int seq_k, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int kCols = HD / 16;  // accumulator columns: tx + 16 * c

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* dss = vs + kBlock * LD;
  float* lse_s = dss + kBlock * kLS;
  float* di_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlock;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * seq_k * HD;
  const T* vb = v + bh * seq_k * HD;

  load_tile<T, HD>(qs, q + bh * seq_q * HD, q0, seq_q);
  load_tile<T, HD>(dos, dout + bh * seq_q * HD, q0, seq_q);
  load_rows(lse_s, lse + bh * seq_q, q0, seq_q);
  load_rows(di_s, di + bh * seq_q, q0, seq_q);

  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  int n_tiles = (seq_k + kBlock - 1) / kBlock;
  if (causal) {
    // the tile's last real query row sees keys up to its own index
    const int last = min(q0 + kBlock, seq_q);
    n_tiles = min(n_tiles, (last + kBlock - 1) / kBlock);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the previous tile's K and ds are consumed
    load_tile<T, HD>(ks, kb, k0, seq_k);
    load_tile<T, HD>(vs, vb, k0, seq_k);
    __syncthreads();

    // s and dp for this thread's 4 rows (ty + 16 r) x 4 keys (tx + 16 c)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = qs[(ty + 16 * r) * LD + d];
        dov[r] = dos[(ty + 16 * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = ks[(tx + 16 * c) * LD + d];
        vv[c] = vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qv[r] * kv[c];
          dp[r][c] += dov[r] * vv[c];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      const int qi = q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const int kj = k0 + key;
        const bool valid =
            qi < seq_q && kj < seq_k && (!causal || qi >= kj);
        const float p = valid ? expf(s[r][c] * scale - lse_s[row]) : 0.f;
        dss[row * kLS + key] = round_to<T>(p * (dp[r][c] - di_s[row]));
      }
    }
    __syncthreads();

    // acc += ds K for this thread's 4 rows x HD/16 columns
    for (int j = 0; j < kBlock; ++j) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dss[(ty + 16 * r) * kLS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] += dsv[r] * kv[c];
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= seq_q) continue;
    T* out = dq + (bh * seq_q + qi) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[tx + 16 * c] = from_float<T>(acc[r][c] * scale);
  }
}

// K4: dk and dv for one 64-row K tile, streaming Q/dO/lse/di tiles
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int seq_q, int seq_k, int causal,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int kCols = HD / 16;

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* pt = dos + kBlock * LD;   // p^T [key][query]
  float* dst = pt + kBlock * kLS;  // ds^T [key][query]
  float* lse_s = dst + kBlock * kLS;
  float* di_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlock;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * seq_q * HD;
  const T* dob = dout + bh * seq_q * HD;
  const float* lseb = lse + bh * seq_q;
  const float* dib = di + bh * seq_q;

  load_tile<T, HD>(ks, k + bh * seq_k * HD, k0, seq_k);
  load_tile<T, HD>(vs, v + bh * seq_k * HD, k0, seq_k);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // Q tiles strictly before this K tile see none of it
  const int t_start = causal ? k0 / kBlock : 0;
  const int n_tiles = (seq_q + kBlock - 1) / kBlock;

  for (int t = t_start; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
    load_tile<T, HD>(qs, qb, q0, seq_q);
    load_tile<T, HD>(dos, dob, q0, seq_q);
    load_rows(lse_s, lseb, q0, seq_q);
    load_rows(di_s, dib, q0, seq_q);
    __syncthreads();

    // s and dp for this thread's 4 keys (ty + 16 r) x 4 queries
    // (tx + 16 c)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = ks[(ty + 16 * r) * LD + d];
        vv[r] = vs[(ty + 16 * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = qs[(tx + 16 * c) * LD + d];
        dov[c] = dos[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qv[c] * kv[r];
          dp[r][c] += dov[c] * vv[r];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = ty + 16 * r;
      const int kj = k0 + key;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int query = tx + 16 * c;
        const int qi = q0 + query;
        const bool valid =
            qi < seq_q && kj < seq_k && (!causal || qi >= kj);
        const float p =
            valid ? expf(s[r][c] * scale - lse_s[query]) : 0.f;
        pt[key * kLS + query] = round_to<T>(p);
        dst[key * kLS + query] = round_to<T>(p * (dp[r][c] - di_s[query]));
      }
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T Q for this thread's 4 keys x HD/16 columns
    for (int i = 0; i < kBlock; ++i) {
      float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = pt[(ty + 16 * r) * kLS + i];
        dsv[r] = dst[(ty + 16 * r) * kLS + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dos[i * LD + tx + 16 * c];
        qv[c] = qs[i * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[r][c] += pv[r] * dov[c];
          dk_acc[r][c] += dsv[r] * qv[c];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= seq_k) continue;
    T* dko = dk + (bh * seq_k + kj) * HD;
    T* dvo = dv + (bh * seq_k + kj) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      // q was streamed unscaled, so dk takes the single scale here
      dko[tx + 16 * c] = from_float<T>(dk_acc[r][c] * scale);
      dvo[tx + 16 * c] = from_float<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int bh, int seq_q, int seq_k, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlock - 1) / kBlock, bh);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), seq_q, seq_k, causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_k + kBlock - 1) / kBlock, bh);
  flash_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), seq_q, seq_k, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q and dout [bh, seq_q, head_dim],
// k and v [bh, seq_k, head_dim], lse and di [bh, seq_q] f32, dq like q,
// all contiguous.  Returns a cudaError_t (cudaErrorInvalidValue for a
// dtype or head_dim the kernel does not take).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di, void* dq,
                 int bh, int seq_q, int seq_k, int head_dim, int dtype,
                 int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dq<float, 64>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                                causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq<float, 128>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                                 causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, d, dq, bh, seq_q,
                                        seq_k, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, d, dq, bh, seq_q,
                                         seq_k, causal, s);
  return cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk and dv like k.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di, void* dk,
                  void* dv, int bh, int seq_q, int seq_k, int head_dim,
                  int dtype, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv<float, 64>(q, k, v, dout, l, d, dk, dv, bh, seq_q,
                                 seq_k, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv<float, 128>(q, k, v, dout, l, d, dk, dv, bh, seq_q,
                                  seq_k, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, d, dk, dv, bh,
                                         seq_q, seq_k, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, d, dk, dv, bh,
                                          seq_q, seq_k, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
