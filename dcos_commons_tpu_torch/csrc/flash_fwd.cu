// Kernel K2: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dcos_commons_tpu/ops/attention.py::_fwd_kernel
// (launched by _pallas_attention): o = softmax(scale * q k^T) v per
// (batch*head), scale = head_dim^-0.5 on f32 scores, causal mask
// top-left aligned (query i sees keys j <= i, also when seq_q != seq_k),
// optional lse = m + log(l) per query row, stored as [bh, seq_q] f32.
//
// What bounds it on the H100: 4*s*s*hd flops per head (halved by the
// causal skip) against 4*s*hd*2 bytes of q, k, v, o: s/2 flops a byte in
// bf16, past the memory ridge for s above a few hundred, so the
// tensor-core rate is the bound.  Two designs behind one entry point:
//
// bf16 (every launch of the serving and training paths): the products
// run on the tensor cores through wgmma, the tiles arrive through TMA.
// One block of three warpgroups owns (bh, a 128-row Q tile).
// Warpgroup 0 is the producer: one thread loads the Q tile once and
// streams 128-row K and V tiles through a 2-stage shared-memory ring,
// each stage guarded by a full barrier (K and V apart, so Q K^T starts
// before V lands) and an empty barrier the consumers release; it gives
// its registers up (setmaxnreg) to warpgroups 1 and 2, the consumers,
// which own 64 query rows each.  Per K tile a consumer computes S = Q K^T
// (wgmma m64n128k16, both operands in shared memory), scales and masks
// it in f32 (the causal mask only on the diagonal tile, the edge mask
// only on the ragged last one: -inf, so p is exactly 0), runs the online
// softmax in registers (a row's max reduced over the 4 threads sharing
// it with shuffles; its sum kept per thread and reduced once at the
// end), rounds P to bf16 in place -- the accumulator fragment is the A
// fragment of the next wgmma (hopper.cuh) -- and adds P V with A from
// registers and V as an MN-major B operand.  K tiles wholly in the
// future of the Q tile are never loaded; the blocks of a head start with
// the longest (last) Q tile.  Rows out of range read as zero through the
// 3-D tensor maps and are never stored.  Shared memory at hd 128: Q 32
// KB + K and V 2 x 2 x 32 KB = 160 KB, one block an SM.
//
// f32 (only the f32 parity checks; TF32 would break their limits): the
// first design, kept exact.  One block of 128 threads owns a 64-row Q
// tile; K and V stream through shared memory as f32 in 64-row tiles;
// the scores and P V are f32 FMA on the CUDA cores.
//
// The ragged edges of seq_q and seq_k are masked inside both kernels, so
// any prompt length runs (the TPU launcher needed seq % block == 0).
//
// Plain C interface for ctypes (see ops/attention.py): flash_fwd returns
// a cudaError_t, 0 on success; the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

namespace {

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int kTileQ = 128;     // Q rows of a block: two consumers x 64
constexpr int kTileK = 128;     // K/V rows of a ring stage
constexpr int kStages = 2;
constexpr int kWsThreads = 384;  // producer + two consumer warpgroups
constexpr int kHalfBytes = kTileK * 128;  // a [128][64] bf16 column half
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  // Q, the K and V ring, 7 barriers, and slack to align the base to 1024
  return (size_t)(1 + 2 * kStages) * (HD / 64) * kHalfBytes + 64 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int seq_q, int seq_k, int causal, float scale) {
  constexpr int H = HD / 64;  // column halves of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* ks = qs + H * kHalfBytes;            // [stage][half]
  uint8_t* vs = ks + kStages * H * kHalfBytes;  // [stage][half]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * H * kHalfBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest first
  const int q0 = q_tile * kTileQ;
  const int bh = blockIdx.y;
  int n_tiles = (seq_k + kTileK - 1) / kTileK;
  if (causal) {
    // the tile's last real query row sees keys up to its own index
    const int last = min(q0 + kTileQ, seq_q);
    n_tiles = min(n_tiles, (last + kTileK - 1) / kTileK);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tm_q);
      hopper::tma_prefetch(&tm_k);
      hopper::tma_prefetch(&tm_v);
      hopper::mbar_arrive_expect_tx(q_full, H * kHalfBytes);
      for (int h = 0; h < H; ++h)
        hopper::tma_load_3d(qs + h * kHalfBytes, &tm_q, q_full, 64 * h, q0,
                            bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], H * kHalfBytes);
        for (int h = 0; h < H; ++h)
          hopper::tma_load_3d(ks + (s * H + h) * kHalfBytes, &tm_k, &k_full[s],
                              64 * h, t * kTileK, bh);
        hopper::mbar_arrive_expect_tx(&v_full[s], H * kHalfBytes);
        for (int h = 0; h < H; ++h)
          hopper::tma_load_3d(vs + (s * H + h) * kHalfBytes, &tm_v, &v_full[s],
                              64 * h, t * kTileK, bh);
      }
    }
    return;
  }

  // consumers: 64 query rows each
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int m0 = q0 + 64 * (threadIdx.x / 128 - 1);  // first row owned
  const int r_in = 16 * (tid / 32) + lane / 4;       // rows r_in, r_in + 8
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_off = (m0 - q0) * 128;  // the slab's rows in each half

  float acc[HD / 2];
  float sc[kTileK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // running max in raw-score units from the JAX kernel's -1e30 start, so
  // a row masked so far keeps alpha = 1 and p = 0; running sums per
  // thread, over its own columns
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const int k0 = t * kTileK;
    hopper::mbar_wait(&k_full[s], phase);

    // S = Q K^T over head_dim in k16 steps
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int byte = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      const uint64_t a = hopper::desc_sw128(qs + q_off + byte, 16, 1024);
      const uint64_t b =
          hopper::desc_sw128(ks + s * H * kHalfBytes + byte, 16, 1024);
      if (kk == 0)
        hopper::wgmma_ss_zero(sc, a, b);
      else
        hopper::wgmma_ss(sc, a, b);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    if (k0 + kTileK > seq_k || (causal && k0 + kTileK - 1 > m0)) {
#pragma unroll
      for (int i = 0; i < kTileK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * i + c0 + e;
            const int row = m0 + r_in + 8 * j;
            if (key >= seq_k || (causal && key > row))
              sc[4 * i + 2 * j + e] = __uint_as_float(0xff800000u);  // -inf
          }
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = m_run[j];
#pragma unroll
      for (int i = 0; i < kTileK / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * j], sc[4 * i + 2 * j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float alpha = hopper::exp2_ftz((m_run[j] - mx) * scale_log2);
      m_run[j] = mx;
      const float shift = mx * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTileK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = hopper::exp2_ftz(
              fmaf(sc[4 * i + 2 * j + e], scale_log2, -shift));
          sc[4 * i + 2 * j + e] = p;
          sum += p;
        }
      l_run[j] = l_run[j] * alpha + sum;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i + 2 * j] *= alpha;
        acc[4 * i + 2 * j + 1] *= alpha;
      }
    }

    // P (bf16, as the TPU kernel's p.astype(v.dtype)) as A fragments
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) hopper::pack_a(pa[kk], sc, kk);

    hopper::mbar_wait(&v_full[s], phase);
    // O += P V, V MN-major: k16 step kk reads V rows 16 kk .. 16 kk + 15
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      hopper::wgmma_rs_tb(
          acc, pa[kk],
          hopper::desc_sw128(vs + s * H * kHalfBytes + kk * 2048, kHalfBytes,
                             1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_run[j];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = m0 + r_in + 8 * j;
    if (row >= seq_q) continue;
    __nv_bfloat16* out = o + ((size_t)bh * seq_q + row) * HD + c0;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * j] / l, acc[4 * i + 2 * j + 1] / l);
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * seq_q + row] = m_run[j] * scale + logf(l);
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int seq_q, int seq_k, int causal,
                         cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = hopper::make_map(&tm_q, q, bh, seq_q, HD, kTileQ)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_k, k, bh, seq_k, HD, kTileK)) !=
          cudaSuccess ||
      (err = hopper::make_map(&tm_v, v, bh, seq_k, HD, kTileK)) !=
          cudaSuccess)
    return err;
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kTileQ - 1) / kTileQ, bh);
  flash_fwd_wgmma<HD><<<grid, kWsThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, seq_q, seq_k,
      causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ---- f32: FMA on the CUDA cores -------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 x 8 grid of threads over each tile
constexpr float kNeg = -1e30f;  // the JAX kernel's initial running max
#define kNegInf __uint_as_float(0xff800000u)  // -inf: a masked score

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles with a padded row (HD + 1 floats: rows fall on
  // different banks), V tile, the score tile (64 + 1 columns) and the
  // per-row m, l, alpha
  return sizeof(float) * (2 * kBlockQ * (HD + 1) + kBlockK * HD +
                          kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int seq_q, int seq_k, int causal,
                  float scale) {
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
  const float* qb = q + bh * seq_q * HD;
  const float* kb = k + bh * seq_k * HD;
  const float* vb = v + bh * seq_k * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int qi = q0 + r;
    qs[r * LD + c] = qi < seq_q ? qb[(size_t)qi * HD + c] : 0.f;
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
      ks[r * LD + c] = in ? kb[(size_t)kj * HD + c] : 0.f;
      vs[r * HD + c] = in ? vb[(size_t)kj * HD + c] : 0.f;
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
    float* ob = o + (bh * seq_q + qi) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) ob[tx + 16 * c] = acc[r][c] / l;
  }
  if (lse != nullptr && tid < kBlockQ && q0 + tid < seq_q) {
    lse[bh * seq_q + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq_q, int seq_k, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_fma<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq_q, seq_k,
      causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma + TMA kernel).
// q [bh, seq_q, head_dim], k and v [bh, seq_k, head_dim], o like q, all
// contiguous, bf16 base pointers 16-byte aligned; lse [bh, seq_q] f32 or
// null.  Returns a cudaError_t (cudaErrorInvalidValue for a dtype or
// head_dim the kernel does not take, or a tensor map the driver
// refuses).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int bh, int seq_q, int seq_k, int head_dim, int dtype,
              int causal, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_fma<64>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_fma<128>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_wgmma<64>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_wgmma<128>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
