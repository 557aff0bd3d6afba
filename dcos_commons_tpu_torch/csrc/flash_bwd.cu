// Kernels K3 and K4: flash-attention backward for Hopper (sm_90a).
//
// K3 (dq) replaces the TPU kernel
// dcos_commons_tpu/ops/attention.py::_dq_kernel, K4 (dk, dv) replaces
// ::_dkv_kernel; both were launched by _pallas_attention_bwd.  From the
// forward's saved lse [bh, seq_q] f32 and di = rowsum(do * o) [bh, seq_q]
// f32 (computed by the caller, as the JAX package computes it outside its
// kernels):
//
//   s  = scale * q k^T                 (f32, q streamed unscaled)
//   p  = exp(s - lse), exactly 0 where masked
//   dp = do v^T
//   ds = p * (dp - di)
//   dq = scale * ds k                  K3: one block per (bh, Q tile)
//   dv = p^T do,  dk = scale * ds^T q  K4: one block per (bh, K tile)
//
// In bf16, ds (K3) and p, ds (K4) are rounded to bf16 before their
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
// and the tensor-core rate is the bound.  Two designs:
//
// bf16 (every K3 and K4 launch of the training path): the products run
// on the tensor cores through wgmma, with tiles loaded by TMA; see the
// notes at flash_dkv_wgmma (K4) and flash_dq_wgmma (K3) below.
//
// f32 (only the f32 parity checks; TF32 would break their limits): the
// first design, kept exact, f32 FMA on the CUDA cores (no mma/wgmma, no
// TMA).  What it keeps: the s x s probability and gradient matrices
// never leave the block.  64-row Q and K tiles, 256 threads as a 16 x 16
// grid.  Each thread owns 4 rows x hd/16 columns of each f32 accumulator
// (K3: dq, 32 registers at hd 128; K4: dk and dv, 64) and 4 x 4 entries
// of s and dp.  Tiles stage in shared memory as f32 with a padded row
// (hd + 1 floats, so rows fall on different banks): K3 149,248 bytes and
// K4 165,888 at hd 128, opted in with cudaFuncSetAttribute; one block
// per SM.
//
// Plain C interface for ctypes (see ops/attention.py): each entry
// point returns a cudaError_t, 0 on success; the caller raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a Q tile and of a K tile
constexpr int kThreads = 256;  // 16 x 16 grid of threads over each tile
constexpr int kLS = kBlock + 1;

// rows [r0, r0 + kBlock) of a [seq, HD] matrix into a padded tile; rows
// past seq read as 0
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int seq) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int row = r0 + r;
    dst[r * LD + c] = row < seq ? src[(size_t)row * HD + c] : 0.f;
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

// K3 in f32: dq for one 64-row Q tile, streaming K/V tiles
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq, int seq_q, int seq_k, int causal,
                 float scale) {
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
  const float* kb = k + bh * seq_k * HD;
  const float* vb = v + bh * seq_k * HD;

  load_tile<HD>(qs, q + bh * seq_q * HD, q0, seq_q);
  load_tile<HD>(dos, dout + bh * seq_q * HD, q0, seq_q);
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
    load_tile<HD>(ks, kb, k0, seq_k);
    load_tile<HD>(vs, vb, k0, seq_k);
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
        dss[row * kLS + key] = p * (dp[r][c] - di_s[row]);
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
    float* out = dq + (bh * seq_q + qi) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[tx + 16 * c] = acc[r][c] * scale;
  }
}

// K4 in f32: dk and dv for one 64-row K tile, streaming Q/dO/lse/di
// tiles
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, int seq_q,
                  int seq_k, int causal, float scale) {
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
  const float* qb = q + bh * seq_q * HD;
  const float* dob = dout + bh * seq_q * HD;
  const float* lseb = lse + bh * seq_q;
  const float* dib = di + bh * seq_q;

  load_tile<HD>(ks, k + bh * seq_k * HD, k0, seq_k);
  load_tile<HD>(vs, v + bh * seq_k * HD, k0, seq_k);

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
    load_tile<HD>(qs, qb, q0, seq_q);
    load_tile<HD>(dos, dob, q0, seq_q);
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
        pt[key * kLS + query] = p;
        dst[key * kLS + query] = p * (dp[r][c] - di_s[query]);
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
    float* dko = dk + (bh * seq_k + kj) * HD;
    float* dvo = dv + (bh * seq_k + kj) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      // q was streamed unscaled, so dk takes the single scale here
      dko[tx + 16 * c] = dk_acc[r][c] * scale;
      dvo[tx + 16 * c] = dv_acc[r][c];
    }
  }
}

template <int HD>
cudaError_t launch_dq_fma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* di, void* dq, int bh, int seq_q,
                          int seq_k, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_fma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlock - 1) / kBlock, bh);
  flash_dq_fma<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      di, static_cast<float*>(dq), seq_q, seq_k, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_fma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* di, void* dk, void* dv, int bh,
                           int seq_q, int seq_k, int causal,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_fma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_k + kBlock - 1) / kBlock, bh);
  flash_dkv_fma<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      di, static_cast<float*>(dk), static_cast<float*>(dv), seq_q, seq_k,
      causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ---- K4 in bf16: wgmma + TMA ----------------------------------------------
//
// One block of two warpgroups owns (bh, a 128-row K tile), 64 K rows
// each.  There is no producer warpgroup: one thread of warpgroup 0 issues
// every TMA load, each as soon as both warpgroups have released the
// stage.  ptxas decides whether to pipeline the wgmmas against the
// registers a thread has at launch, and a producer costs the consumers
// those: with a producer warpgroup (384 threads, 168 registers a thread
// at launch) it serialised every wgmma of this kernel and spilled,
// though setmaxnreg gave the consumers 240; a producer warp (288
// threads) leaves 168 too, as 9 warps put 3 on one of the SM's four
// register files.  At 256 threads a thread has the ~220 the products
// need.  K and V are loaded once; 64-row Q and dO tiles stream through a
// 3-stage ring (full and empty barriers per stage; loads run two tiles
// ahead of the issuing warpgroup), each consumed in two halves of 32
// queries: S^T and dP^T at 16 f32 registers each beside dK and dV's 64
// + 64 (at 64 queries they spilled).  Working transposed, as
// FlashAttention-3's backward does, the K rows are the rows of every
// product, so dK and dV stay in registers for the whole loop:
//
//   S^T  = K Q^T,  dP^T = V dO^T      wgmma m64n32k16, A and B in smem
//   P^T  = exp(S^T scale - lse)       lse and di indexed by column
//   dS^T = P^T (dP^T - di)
//   dV  += bf16(P^T) dO,  dK += bf16(dS^T) Q
//                                     wgmma m64nHDk16, A from registers,
//                                     dO and Q as MN-major B operands
//
// lse (times log2 e) and di come padded to 64-row tiles
// ([bh, round_up(seq_q, 64)], from the wrapper) and ride with each stage
// as two 256-byte bulk copies: read from shared memory, their latency
// is hidden like the tiles' (as plain global loads they cost 30% of the
// kernel at the training shape).  Every dK and dV element has one
// writer: no atomics, the same bits run to run.

constexpr int kTileKV = 128;      // K rows of a block: two consumers x 64
constexpr int kTileQ = 64;        // Q rows of a ring stage
constexpr int kStages = 3;
constexpr int kDkvThreads = 256;  // two warpgroups
constexpr int kKVHalf = kTileKV * 128;  // a [128][64] bf16 column half
constexpr int kQHalf = kTileQ * 128;    // a [64][64] bf16 column half
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V, the Q and dO ring, the lse and di ring, 7 barriers, slack to
  // align the base to 1024
  return (size_t)(HD / 64) * (2 * kKVHalf + 2 * kStages * kQHalf) +
         2 * kStages * kTileQ * sizeof(float) + 64 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse2,
                    const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int seq_q, int seq_k,
                    int causal, float scale) {
  constexpr int H = HD / 64;  // column halves of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = base;
  uint8_t* vs = ks + H * kKVHalf;
  uint8_t* qs = vs + H * kKVHalf;              // [stage][half]
  uint8_t* dos = qs + kStages * H * kQHalf;    // [stage][half]
  float* lse_s = reinterpret_cast<float*>(dos + kStages * H * kQHalf);
  float* di_s = lse_s + kStages * kTileQ;  // [stage][64] each
  uint64_t* bars = reinterpret_cast<uint64_t*>(di_s + kStages * kTileQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int k0 = blockIdx.x * kTileKV;
  const int bh = blockIdx.y;
  const int n_q_tiles = (seq_q + kTileQ - 1) / kTileQ;
  // Q tiles strictly before this K tile see none of it
  const int t0 = causal ? min(k0 / kTileQ, n_q_tiles) : 0;
  const int n_iter = n_q_tiles - t0;
  const size_t rows = (size_t)bh * n_q_tiles * kTileQ;  // padded lse, di

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kDkvThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the Q and dO tiles of iteration i into stage i % kStages, once both
  // warpgroups have released that stage's previous tile
  const bool issuer = threadIdx.x == 0;
  auto load_q_do = [&](int i) {
    const int s = i % kStages;
    const int q0 = (t0 + i) * kTileQ;
    if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
    hopper::mbar_arrive_expect_tx(&full[s], 2 * H * kQHalf +
                                                2 * kTileQ * sizeof(float));
    for (int h = 0; h < H; ++h) {
      hopper::tma_load_3d(qs + (s * H + h) * kQHalf, &tm_q, &full[s], 64 * h,
                          q0, bh);
      hopper::tma_load_3d(dos + (s * H + h) * kQHalf, &tm_do, &full[s],
                          64 * h, q0, bh);
    }
    hopper::bulk_load(lse_s + s * kTileQ, lse2 + rows + q0,
                      kTileQ * sizeof(float), &full[s]);
    hopper::bulk_load(di_s + s * kTileQ, di + rows + q0,
                      kTileQ * sizeof(float), &full[s]);
  };
  if (issuer && n_iter > 0) {
    hopper::mbar_arrive_expect_tx(kv_full, 2 * H * kKVHalf);
    for (int h = 0; h < H; ++h) {
      hopper::tma_load_3d(ks + h * kKVHalf, &tm_k, kv_full, 64 * h, k0, bh);
      hopper::tma_load_3d(vs + h * kKVHalf, &tm_v, kv_full, 64 * h, k0, bh);
    }
    for (int i = 0; i < min(kStages, n_iter); ++i) load_q_do(i);
  }

  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kv0 = k0 + 64 * (threadIdx.x / 128);   // first K row owned
  const int r_in = 16 * (tid / 32) + lane / 4;         // rows r_in, r_in + 8
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t kv_off = (kv0 - k0) * 128;  // the slab's rows in each half

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_iter > 0) hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (t0 + it) * kTileQ;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const float* lse_st = lse_s + s * kTileQ;
    const float* di_st = di_s + s * kTileQ;
    // the stage's 64 queries in two halves of 32, to keep S^T and dP^T
    // at 16 registers each beside dK and dV (64 + 64); not unrolled, so
    // one half's registers are live at a time
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int qh = q0 + 32 * half;
      // warpgroup-uniform: no query of the half in range, or (causal)
      // every query before this slab's first K row
      if (qh >= seq_q || (causal && qh + 31 < kv0)) continue;
      uint8_t* q_h = qs + s * H * kQHalf + 32 * half * 128;
      uint8_t* do_h = dos + s * H * kQHalf + 32 * half * 128;

      // S^T = K Q^T and dP^T = V dO^T over head_dim in k16 steps
      float st[16], dpt[16];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a_byte = (kk / 4) * kKVHalf + kv_off + (kk % 4) * 32;
        const int b_byte = (kk / 4) * kQHalf + (kk % 4) * 32;
        const uint64_t a = hopper::desc_sw128(ks + a_byte, 16, 1024);
        const uint64_t b = hopper::desc_sw128(q_h + b_byte, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_zero(st, a, b);
        else
          hopper::wgmma_ss(st, a, b);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a_byte = (kk / 4) * kKVHalf + kv_off + (kk % 4) * 32;
        const int b_byte = (kk / 4) * kQHalf + (kk % 4) * 32;
        const uint64_t a = hopper::desc_sw128(vs + a_byte, 16, 1024);
        const uint64_t b = hopper::desc_sw128(do_h + b_byte, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_zero(dpt, a, b);
        else
          hopper::wgmma_ss(dpt, a, b);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T and dS^T in place: row = K index, column = query index
      const bool edge = qh + 32 > seq_q || kv0 + 64 > seq_k ||
                        (causal && qh < kv0 + 63);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 32 * half + 8 * i + c0 + e;  // in the stage
          const int qi = q0 + col;
          const bool q_in = qi < seq_q;
          const float shift = lse_st[col];
          const float d = di_st[col];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = 4 * i + 2 * j + e;
            const int kj = kv0 + r_in + 8 * j;
            float p = hopper::exp2_ftz(fmaf(st[idx], scale_log2, -shift));
            if (edge && !(q_in && kj < seq_k && (!causal || qi >= kj)))
              p = 0.f;
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - d);
          }
        }

      // bf16(P^T) and bf16(dS^T) as A fragments (the TPU kernel's
      // p.astype(do.dtype) and ds.astype(q.dtype)); the next products
      // reduce over the half's 32 queries: k16 step kk = its rows
      // 16 kk .. 16 kk + 15 of the dO and Q tiles
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        hopper::pack_a(pa[kk], st, kk);
        hopper::pack_a(da[kk], dpt, kk);
      }
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(da[kk]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        hopper::wgmma_rs_tb(
            dv_acc, pa[kk],
            hopper::desc_sw128(do_h + kk * 2048, kQHalf, 1024));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        hopper::wgmma_rs_tb(
            dk_acc, da[kk],
            hopper::desc_sw128(q_h + kk * 2048, kQHalf, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
    }
    hopper::mbar_arrive(&empty[s]);
    if (issuer && it + kStages < n_iter) load_q_do(it + kStages);
  }

  // q was streamed unscaled, so dk takes the single scale here; a K tile
  // that no query sees writes zeros
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kj = kv0 + r_in + 8 * j;
    if (kj >= seq_k) continue;
    const size_t off = ((size_t)bh * seq_k + kj) * HD + c0;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i) =
          __floats2bfloat162_rn(dk_acc[4 * i + 2 * j] * scale,
                                dk_acc[4 * i + 2 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i) =
          __floats2bfloat162_rn(dv_acc[4 * i + 2 * j],
                                dv_acc[4 * i + 2 * j + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dk, void* dv, int bh,
                             int seq_q, int seq_k, int causal,
                             cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = hopper::make_map(&tm_q, q, bh, seq_q, HD, kTileQ)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_do, dout, bh, seq_q, HD, kTileQ)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_k, k, bh, seq_k, HD, kTileKV)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_v, v, bh, seq_k, HD, kTileKV)) !=
          cudaSuccess)
    return err;
  constexpr size_t smem = dkv_wgmma_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_dkv_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_k + kTileKV - 1) / kTileKV, bh);
  flash_dkv_wgmma<HD><<<grid, kDkvThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq_q, seq_k, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ---- K3 in bf16: wgmma + TMA ----------------------------------------------
//
// K2's orientation (Q rows own every product, so dQ stays in registers
// for the whole loop) with K4's register plan: one block of two
// warpgroups owns (bh, a 128-row Q tile), 64 Q rows each, and no
// producer warpgroup (a producer costs the consumers the launch-time
// registers ptxas needs to pipeline their wgmmas; see K4 above).  One
// thread of warpgroup 0 issues every TMA load: the Q and dO tiles once,
// then 64-row K and V tiles through a 3-stage ring (full and empty
// barriers per stage; loads run two tiles ahead of the issuing
// warpgroup).  Per K tile each warpgroup computes
//
//   S  = Q K^T,  dP = dO V^T          wgmma m64n64k16, A and B in smem
//   P  = exp2(S scale log2 e - lse log2 e), exactly 0 where masked
//   dS = P (dP - di)                  rounded to bf16 in place: the
//                                     accumulator fragment is the A
//                                     fragment of the next product
//   dQ += bf16(dS) K                  wgmma m64nHDk16, A from registers,
//                                     K as an MN-major B operand (K2's
//                                     P V with V -> K)
//
// S and dP take 32 f32 registers each beside dQ's HD / 2.  lse and di
// belong to Q rows, so each thread loads its two rows' values once per
// block with plain global loads.  A warpgroup whose 64 rows all lie
// before a K tile (the causal diagonal of the 128-row tile) or past
// seq_q skips that tile's products but still releases its stage.  The
// blocks of a head start with the longest Q tile, as K2's do.  Every dQ
// element has one writer: no atomics, the same bits run to run.

constexpr int kDqTileQ = 128;   // Q rows of a block: two warpgroups x 64
constexpr int kDqTileK = 64;    // K/V rows of a ring stage
constexpr int kDqThreads = 256;  // two warpgroups
constexpr int kDqQHalf = kDqTileQ * 128;  // a [128][64] bf16 column half
constexpr int kDqKHalf = kDqTileK * 128;  // a [64][64] bf16 column half

template <int HD>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO, the K and V ring, 7 barriers, slack to align the base to 1024
  return (size_t)(HD / 64) * (2 * kDqQHalf + 2 * kStages * kDqKHalf) + 64 +
         1024;
}

template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dq, int seq_q, int seq_k,
                   int causal, float scale) {
  constexpr int H = HD / 64;  // column halves of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* dos = qs + H * kDqQHalf;
  uint8_t* ks = dos + H * kDqQHalf;              // [stage][half]
  uint8_t* vs = ks + kStages * H * kDqKHalf;     // [stage][half]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * H * kDqKHalf);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqTileQ;  // longest first
  const int bh = blockIdx.y;
  int n_tiles = (seq_k + kDqTileK - 1) / kDqTileK;
  if (causal) {
    // the tile's last real query row sees keys up to its own index
    const int last = min(q0 + kDqTileQ, seq_q);
    n_tiles = min(n_tiles, (last + kDqTileK - 1) / kDqTileK);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kDqThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the K and V tiles of iteration t into stage t % kStages, once both
  // warpgroups have released that stage's previous tile
  const bool issuer = threadIdx.x == 0;
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    if (t >= kStages) hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
    hopper::mbar_arrive_expect_tx(&full[s], 2 * H * kDqKHalf);
    for (int h = 0; h < H; ++h) {
      hopper::tma_load_3d(ks + (s * H + h) * kDqKHalf, &tm_k, &full[s],
                          64 * h, t * kDqTileK, bh);
      hopper::tma_load_3d(vs + (s * H + h) * kDqKHalf, &tm_v, &full[s],
                          64 * h, t * kDqTileK, bh);
    }
  };
  if (issuer && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(q_full, 2 * H * kDqQHalf);
    for (int h = 0; h < H; ++h) {
      hopper::tma_load_3d(qs + h * kDqQHalf, &tm_q, q_full, 64 * h, q0, bh);
      hopper::tma_load_3d(dos + h * kDqQHalf, &tm_do, q_full, 64 * h, q0,
                          bh);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t);
  }

  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int m0 = q0 + 64 * (threadIdx.x / 128);   // first Q row owned
  const int r_in = 16 * (tid / 32) + lane / 4;    // rows r_in, r_in + 8
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_off = (m0 - q0) * 128;  // the slab's rows in each half

  // this thread's two rows: lse in base 2 and di (0 past seq_q, where
  // Q and dO read as zero, so ds is 0 there and the row is never stored)
  float lse2[2], di_r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = m0 + r_in + 8 * j;
    const size_t at = (size_t)bh * seq_q + row;
    lse2[j] = row < seq_q ? lse[at] * kLog2e : 0.f;
    di_r[j] = row < seq_q ? di[at] : 0.f;
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kDqTileK;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    // warpgroup-uniform: the slab has rows in range, and (causal) its
    // last row sees the tile's first key
    if (m0 < seq_q && !(causal && k0 > m0 + 63)) {
      uint8_t* k_st = ks + s * H * kDqKHalf;
      uint8_t* v_st = vs + s * H * kDqKHalf;

      // S = Q K^T and dP = dO V^T over head_dim in k16 steps
      float sc[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a_byte = (kk / 4) * kDqQHalf + q_off + (kk % 4) * 32;
        const int b_byte = (kk / 4) * kDqKHalf + (kk % 4) * 32;
        const uint64_t a = hopper::desc_sw128(qs + a_byte, 16, 1024);
        const uint64_t b = hopper::desc_sw128(k_st + b_byte, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_zero(sc, a, b);
        else
          hopper::wgmma_ss(sc, a, b);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a_byte = (kk / 4) * kDqQHalf + q_off + (kk % 4) * 32;
        const int b_byte = (kk / 4) * kDqKHalf + (kk % 4) * 32;
        const uint64_t a = hopper::desc_sw128(dos + a_byte, 16, 1024);
        const uint64_t b = hopper::desc_sw128(v_st + b_byte, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_zero(dp, a, b);
        else
          hopper::wgmma_ss(dp, a, b);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P and dS in place: row = query, column = key.  The mask only on
      // the ragged last tile and on tiles that cross the diagonal
      const bool edge = k0 + kDqTileK > seq_k || (causal && k0 + 63 > m0);
#pragma unroll
      for (int i = 0; i < kDqTileK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * i + 2 * j + e;
            const int key = k0 + 8 * i + c0 + e;
            const int row = m0 + r_in + 8 * j;
            float p = hopper::exp2_ftz(fmaf(sc[idx], scale_log2, -lse2[j]));
            if (edge && (key >= seq_k || (causal && key > row))) p = 0.f;
            dp[idx] = p * (dp[idx] - di_r[j]);
          }

      // bf16(dS) as A fragments (the TPU kernel's ds.astype(k.dtype));
      // dQ += dS K reduces over the tile's 64 keys: k16 step kk = K rows
      // 16 kk .. 16 kk + 15
      uint32_t da[kDqTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqTileK / 16; ++kk) hopper::pack_a(da[kk], dp, kk);
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kDqTileK / 16; ++kk) hopper::fence_regs(da[kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqTileK / 16; ++kk)
        hopper::wgmma_rs_tb(
            acc, da[kk],
            hopper::desc_sw128(k_st + kk * 2048, kDqKHalf, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(&empty[s]);
    if (issuer && t + kStages < n_tiles) load_kv(t + kStages);
  }

  // k was streamed unscaled, so dq takes the single scale here
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = m0 + r_in + 8 * j;
    if (row >= seq_q) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * seq_q + row) * HD + c0;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * j] * scale, acc[4 * i + 2 * j + 1] * scale);
  }
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, void* dq, int bh, int seq_q,
                            int seq_k, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = hopper::make_map(&tm_q, q, bh, seq_q, HD, kDqTileQ)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_do, dout, bh, seq_q, HD, kDqTileQ)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_k, k, bh, seq_k, HD, kDqTileK)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_v, v, bh, seq_k, HD, kDqTileK)) !=
          cudaSuccess)
    return err;
  constexpr size_t smem = dq_wgmma_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_dq_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kDqTileQ - 1) / kDqTileQ, bh);
  flash_dq_wgmma<HD><<<grid, kDqThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, di, static_cast<__nv_bfloat16*>(dq),
      seq_q, seq_k, causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (wgmma + TMA kernels).
// q and dout [bh, seq_q, head_dim], k and v [bh, seq_k, head_dim], lse
// and di [bh, seq_q] f32, dq like q, all contiguous, bf16 base pointers
// 16-byte aligned.  Returns a cudaError_t (cudaErrorInvalidValue for a
// dtype or head_dim the kernel does not take, or a tensor map the
// driver refuses).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di, void* dq,
                 int bh, int seq_q, int seq_k, int head_dim, int dtype,
                 int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dq_fma<64>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                             causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq_fma<128>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                              causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                               causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, l, d, dq, bh, seq_q, seq_k,
                                causal, s);
  return cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk and dv like k.  bf16: lse and di padded to whole
// 64-row tiles, [bh, round_up(seq_q, 64)] f32 with zeros past seq_q and
// lse multiplied by log2(e) (ops/attention.py makes them).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di, void* dk,
                  void* dv, int bh, int seq_q, int seq_k, int head_dim,
                  int dtype, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv_fma<64>(q, k, v, dout, l, d, dk, dv, bh, seq_q, seq_k,
                              causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv_fma<128>(q, k, v, dout, l, d, dk, dv, bh, seq_q,
                               seq_k, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, l, d, dk, dv, bh, seq_q, seq_k,
                                causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, l, d, dk, dv, bh, seq_q,
                                 seq_k, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
