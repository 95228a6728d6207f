// Flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_kernel (entry
// flash_attention_fwd): forward GQA attention with an online softmax whose
// running max m, running sum l and output accumulator acc stay in float32;
// causal, sliding-window and chunked-local masks; whole key tiles that the
// mask empties are skipped; keys at or past seq_len are masked; a row that
// no key reaches gives 0.
//
// Design.  One block of 256 threads per (query tile of block_q <= 64 rows,
// batch*head); a loop over the key tiles of block_k <= 64 rows inside the
// block takes the place of the TPU's sequential grid axis.  The query tile
// (scaled by 1/sqrt(hd) after the cast to f32, as the TPU kernel does) and
// each key/value tile are staged in shared memory as f32; the 64 x 64 score
// tile is split 4 x 4 per thread (rows tr + 16 i, columns tc + 16 j), so a
// row's max and sum are 16-lane shuffles inside one half-warp, and each
// thread keeps the same four rows of acc (4 x D/16 registers) with their
// m and l.  Scalar fmaf products, expf (no fast math).  The operands are
// read in place in the JAX layout (B, S, H, hd) -- rows strided by H*hd --
// so the wrapper makes no transposed copies.  The kv head of query head hh
// is hh / (H / KV) (the TPU index map's (bh % H) // G).  Head dims are
// padded in shared memory to D in {32, 64, 128, 256}; at D = 256 the block
// takes 213,760 bytes of dynamic shared memory, one block per SM.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the serving path's
// shape (B=4, S=512, H=8, KV=1, hd=256, bf16, causal) one call must move
// 18.9 MB (q and o 8.4 MB each, k and v 1.05 MB each), 5.6 us, and do
// 4.3 GFLOP of products, 4.4 us: bound by bytes.  This first design runs
// the products on the CUDA cores in f32 (67 TFLOP/s at most), re-reads k
// and v once per query head and query tile, and keeps one block of 8 warps
// per SM, so it is far from that bound; wgmma, TMA staging and sharing a
// kv tile across the G query heads of a group are the way there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;      // rows of a query tile and of a key tile, at most
constexpr int THREADS = 256;  // 16 x 16 threads over a TILE x TILE score tile
constexpr int RPT = TILE / 16;  // rows (and columns) of the score tile per thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, s, h, kvh, hd;
  int causal, window, chunk;  // window/chunk 0: none
  int block_q, block_k;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <int D> constexpr int smem_bytes() {
  // q and k tiles with rows padded to D + 1 floats (conflict-free column
  // walks), the v tile, the probability tile padded to TILE + 1
  return (2 * TILE * (D + 1) + TILE * D + TILE * (TILE + 1)) *
         static_cast<int>(sizeof(float));
}

// The TPU kernel's whole-tile skip test: true unless every (row, col) of the
// tile is masked, so skipping is exact.
__device__ __forceinline__ bool tile_live(const Params& p, int q_start,
                                          int k_start) {
  if (!p.causal) return true;
  bool live = k_start <= q_start + p.block_q - 1;
  if (p.window) live = live && k_start + p.block_k - 1 >= q_start - (p.window - 1);
  if (p.chunk) live = live && k_start + p.block_k - 1 >= (q_start / p.chunk) * p.chunk;
  return live;
}

__device__ __forceinline__ bool allowed(const Params& p, int row, int col) {
  if (col >= p.s) return false;  // kv padding
  if (!p.causal) return true;
  bool ok = col <= row;
  if (p.window) ok = ok && row - col < p.window;
  if (p.chunk) ok = ok && row / p.chunk == col / p.chunk;
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;
  constexpr int PS = TILE + 1;
  constexpr int CPT = D / 16;  // acc columns per thread
  float* qs = smem;
  float* ks = qs + TILE * QS;
  float* vs = ks + TILE * QS;
  float* ps = vs + TILE * D;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hh = bh % p.h;
  const int kv_head = hh / (p.h / p.kvh);
  // the last (causally heaviest) query tiles are scheduled first
  const int q_start = (gridDim.y - 1 - blockIdx.y) * p.block_q;

  const long long q_row = static_cast<long long>(p.h) * p.hd;
  const long long kv_row = static_cast<long long>(p.kvh) * p.hd;
  const T* qb = static_cast<const T*>(p.q) +
                (static_cast<long long>(bi) * p.s * p.h + hh) * p.hd;
  const T* kb = static_cast<const T*>(p.k) +
                (static_cast<long long>(bi) * p.s * p.kvh + kv_head) * p.hd;
  const T* vb = static_cast<const T*>(p.v) +
                (static_cast<long long>(bi) * p.s * p.kvh + kv_head) * p.hd;
  T* ob = static_cast<T*>(p.o) +
          (static_cast<long long>(bi) * p.s * p.h + hh) * p.hd;

  for (int idx = tid; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q_start + r;
    float x = 0.f;
    if (r < p.block_q && row < p.s && c < p.hd)
      x = to_f32(qb[row * q_row + c]) * p.scale;
    qs[r * QS + c] = x;
  }

  float acc[RPT][CPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  const int n_k = (p.s + p.block_k - 1) / p.block_k;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k_start = kt * p.block_k;
    if (!tile_live(p, q_start, k_start)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int idx = tid; idx < TILE * D; idx += THREADS) {
      const int j = idx / D, c = idx % D, col = k_start + j;
      float kx = 0.f, vx = 0.f;
      if (j < p.block_k && col < p.s && c < p.hd) {
        kx = to_f32(kb[col * kv_row + c]);
        vx = to_f32(vb[col * kv_row + c]);
      }
      ks[j * QS + c] = kx;
      vs[j * D + c] = vx;
    }
    __syncthreads();

    float sc[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) sc[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < p.hd; ++c) {
      float qv[RPT], kv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(tr + 16 * i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) kv[jj] = ks[(tc + 16 * jj) * QS + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < RPT; ++jj)
          sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr + 16 * i, row = q_start + r;
      float m_cur = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) {
        const int j = tc + 16 * jj;
        if (!(j < p.block_k && allowed(p, row, k_start + j))) sc[i][jj] = NEG_INF;
        m_cur = fmaxf(m_cur, sc[i][jj]);
      }
      // the row's 16 threads are lanes tc of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[i], m_cur);
      // fully masked so far: keep the accumulators exactly zero
      const bool any = m_new > NEG_INF / 2;
      const float alpha = any ? expf(m[i] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) {
        const float pv = any ? expf(sc[i][jj] - m_new) : 0.f;
        ps[r * PS + tc + 16 * jj] = pv;
        psum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

    for (int j = 0; j < p.block_k; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(tr + 16 * i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = vs[j * D + tc + 16 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + 16 * i, row = q_start + r;
    if (r >= p.block_q || row >= p.s) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = tc + 16 * cc;
      if (c < p.hd) ob[row * q_row + c] = from_f32<T>(acc[i][cc] / denom);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.b * p.h, (p.s + p.block_q - 1) / p.block_q);
  flash_attn_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  q/o: (B, S, H, hd), k/v:
// (B, S, KV, hd), contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// hd <= 256, 1 <= block_q, block_k <= 64 (the wrapper checks).
int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int h, int kvh, int hd, int causal,
                      int window, int chunk, int block_q, int block_k,
                      float scale, int dtype, void* stream) {
  const Params p{q, k, v, o, b, s, h, kvh, hd, causal, window, chunk,
                 block_q, block_k, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dim<__nv_bfloat16>(p, st)
                    : launch_dim<float>(p, st);
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
