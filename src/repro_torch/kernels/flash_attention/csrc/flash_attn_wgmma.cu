// Flash attention forward on Hopper's tensor cores (sm_90a): wgmma + TMA.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_kernel (entry
// flash_attention_fwd) for bfloat16 operands whose head dim is a multiple
// of 8 and at most 256; flash_attn.cu (the SIMT kernel) takes everything
// else.  Same function: forward GQA attention (the kv head of query head hh
// is hh / (H / KV)) with an online softmax whose running max m, running sum
// l and output accumulator stay in float32; causal, sliding-window and
// chunked-local masks; whole key tiles that the mask empties are skipped by
// the TPU kernel's own test; keys at or past seq_len are masked; a row that
// no key reaches gives 0 (NEG_INF = -1e30, the m_new > NEG_INF / 2 guard,
// divide by 1 where l == 0).
//
// Numerics.  Scores are the bf16 products summed in f32 by the tensor
// cores; the 1/sqrt(hd) scale is applied to them in f32 after the product
// (the JAX kernel scales q in f32 before it: a rounding difference only).
// l sums the f32 probabilities.  The P.V product takes P as two bf16 A
// operands, its bf16 rounding and the rest rounded to bf16 (each p to
// 2^-18 of itself; the JAX kernel keeps p in f32).  Rounding P once to bf16
// moves a bf16 output of 4 or more by one step (0.031) against the plain
// version at qwen2-72b's activations.  The arithmetic is emulated on the CPU
// in tests/test_torch_flash_route.py against the JAX attention_ref.
//
// Design.  One block of 256 threads per (128 query rows, batch*head), the
// causally heaviest query tiles launched first; two warpgroups, each owning
// 64 query rows; key tiles of 64 rows.
//   * Loads by TMA over the whole tensors in place: tensor maps of dims
//     (hd, heads, S, B) with boxes of 64 bf16 x 64 rows under 128-byte
//     swizzle, so a head of 256 is four boxes and out-of-bounds zero fill
//     pads hd up to a multiple of 64 and the ragged last tile past S.  Q is
//     loaded once; K and V go through a two-stage ring: thread 0 issues the
//     next live tile's loads before the current tile's products, and each
//     stage's arrival is an mbarrier transaction count.
//   * S = Q.K^T by wgmma m64n64k16 (bf16 in, f32 accumulate), both operands
//     K-major from shared memory through 128-byte-swizzle descriptors.
//   * Softmax in registers: a row's 16 values per thread and its 4 threads
//     in the accumulator layout (shuffles over lane bits 0-1).  The mask is
//     applied only on tiles that the diagonal, the window edge, the chunk
//     edge or the S padding crosses.  A warpgroup skips the products of a
//     tile that its own 64 rows do not reach (the same test at 64 rows).
//   * O += P.V by wgmma with P from registers (the f32 score accumulator
//     converted in place to bf16 pairs has wgmma's A-fragment layout; two
//     products a k16 step, P's bf16 pairs and then the rest's) and V
//     MN-major from shared memory (transpose bit); O stays in f32 registers,
//     64 x D per warpgroup.
//   * The output goes back through the warpgroup's Q buffer (swizzled as a
//     TMA box) and a TMA store, which drops rows past S and columns past hd.
// Shared memory at D = 256: Q 64 KB plus two stages of K and V, 128 KB: one
// block per SM; at D <= 128 it is 96 KB or less, room for two blocks.  The
// launch bounds ask the registers for two there, 128 a thread (O alone
// takes D / 2, P's two operands 32): at D = 128 that costs 36 bytes of
// spill stores, and one block an SM took 1.45x the time at qwen2's heads.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the serving shape (B=4,
// S=512, H=8, KV=1, hd=256, causal) one call moves 18.9 MB, 5.6 us, and does
// 4.3 GFLOP, 4.4 us: bound by bytes.  At B=1, S=8192 it does 2.75e11 FLOP,
// 0.278 ms: bound by operations.  Left for later: a producer warp with
// setmaxnreg, one k/v tile shared by the G query heads of a group, and
// persistent blocks.
//
// Single file, no local includes: kernels/_build.py names a library by a
// hash of this file's bytes alone.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;         // query rows of a block
constexpr int WG_ROWS = 64;     // query rows of a warpgroup
constexpr int BK = 64;          // key rows of a tile
constexpr int THREADS = 256;    // two warpgroups
constexpr int ATOM = 64;        // bf16 columns of a 128-byte swizzle atom
constexpr int BOX_BYTES = 64 * 128;  // one TMA box: 64 rows x 128 bytes

struct Params {
  int s, h, kvh, hd;
  int causal, window, chunk;  // window/chunk 0: none
  float scale;
};

// Shared memory, as byte offsets from a 1024-aligned base: Q [2 wg][NA
// boxes], K and V [2 stages][NA boxes], then the mbarriers (q, k[2], v[2]).
template <int NA> struct Layout {
  static constexpr int Q = 0;
  static constexpr int K = Q + 2 * NA * BOX_BYTES;
  static constexpr int V = K + 2 * NA * BOX_BYTES;
  static constexpr int BAR = V + 2 * NA * BOX_BYTES;
  static constexpr int BYTES = BAR + 5 * 8 + 1024;  // + alignment slack
};

// The TPU kernel's whole-tile test for ``rows`` query rows from q_start and
// the BK keys from k_start: true unless every (row, col) pair is masked.
__device__ __forceinline__ bool tile_live(const Params& p, int q_start,
                                          int rows, int k_start) {
  if (!p.causal) return true;
  bool live = k_start <= q_start + rows - 1;
  if (p.window) live = live && k_start + BK - 1 >= q_start - (p.window - 1);
  if (p.chunk) live = live && k_start + BK - 1 >= (q_start / p.chunk) * p.chunk;
  return live;
}

// False when every pair of the tile is allowed, so the elementwise mask can
// be left out: no key past S, and under causal the tile lies wholly below
// the diagonal, inside the window and inside one chunk.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q_start,
                                                int rows, int k_start) {
  const int q_end = q_start + rows - 1, k_end = k_start + BK - 1;
  if (k_end >= p.s) return true;
  if (!p.causal) return false;
  if (k_end > q_start) return true;
  if (p.window && q_end - k_start >= p.window) return true;
  if (p.chunk && k_start / p.chunk != q_end / p.chunk) return true;
  return false;
}

__device__ __forceinline__ bool allowed(const Params& p, int row, int col) {
  if (col >= p.s) return false;  // kv padding
  if (!p.causal) return true;
  bool ok = col <= row;
  if (p.window) ok = ok && row - col < p.window;
  if (p.chunk) ok = ok && row / p.chunk == col / p.chunk;
  return ok;
}

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// A shared-memory matrix descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D32_OPERANDS                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define D32_REGS                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64 f32) = A.B (+ d when accumulate): A 64 x 16 and B 16 x 64
// bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32_OPERANDS
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 64 f32) += A.B: A 64 x 16 bf16 from registers (four b32 of bf16
// pairs a thread), B 16 x 64 bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32_OPERANDS
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What the bf16 pair ``pair`` of (lo, hi) leaves out, as a bf16 pair: the
// differences are exact in f32, and pair + rest holds each value to 2^-18
// of itself.
__device__ __forceinline__ uint32_t bf16_rest(float lo, float hi,
                                              uint32_t pair) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  return bf16_pair(lo - __low2float(v), hi - __high2float(v));
}

// -- the kernel ------------------------------------------------------------

// NA = 64-column boxes per head row (the head dim padded to D = 64 NA).
template <int NA>
__global__ void __launch_bounds__(THREADS, NA <= 2 ? 2 : 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o,
                            const Params p) {
  using L = Layout<NA>;
  constexpr int KSTEPS = NA * ATOM / 16;  // k16 steps of Q.K^T
  constexpr uint32_t KV_BYTES = NA * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q, sk = base + L::K, sv = base + L::V;
  const uint32_t bar_q = base + L::BAR;
  // bar_k(st) = bar_q + 8 + 8 st, bar_v(st) = bar_q + 24 + 8 st

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x, bi = bh / p.h, hh = bh % p.h;
  const int kv_head = hh / (p.h / p.kvh);
  // the last (causally heaviest) query tiles are scheduled first
  const int q_block = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_wg = q_block + wg * WG_ROWS;
  const bool wg_rows = q_wg < p.s;  // this warpgroup holds a real row
  const bool two_wg = q_block + WG_ROWS < p.s;

  // the block's live key tiles, a contiguous range [lo, hi]
  const int n_k = (p.s + BK - 1) / BK;
  int lo = 0, hi = n_k - 1;
  while (lo <= hi && !tile_live(p, q_block, BQ, lo * BK)) ++lo;
  while (hi >= lo && !tile_live(p, q_block, BQ, hi * BK)) --hi;
  const int n_live = hi - lo + 1;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int kt, int st) {
    const uint32_t bk = bar_q + 8 + 8 * st, bv = bar_q + 24 + 8 * st;
    mbar_expect(bk, KV_BYTES);
    mbar_expect(bv, KV_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const uint32_t off = (st * NA + a) * BOX_BYTES;
      tma_load(sk + off, &tm_k, bk, a * ATOM, kv_head, kt * BK, bi);
      tma_load(sv + off, &tm_v, bv, a * ATOM, kv_head, kt * BK, bi);
    }
  };
  if (tid == 0) {
    mbar_expect(bar_q, (two_wg ? 2 : 1) * KV_BYTES);
    for (int w = 0; w < (two_wg ? 2 : 1); ++w) {
      for (int a = 0; a < NA; ++a)
        tma_load(sq + (w * NA + a) * BOX_BYTES, &tm_q, bar_q, a * ATOM, hh,
                 q_block + w * WG_ROWS, bi);
    }
    if (n_live > 0) load_kv(lo, 0);
  }
  __syncwarp();

  // accumulator layout (m64nNk16, per warpgroup): element j of a 64-column
  // chunk sits at row r0 + 8 ((j / 2) % 2), column 8 (j / 4) + 2 (lane % 4)
  // + j % 2
  const int r0 = warp * 16 + lane / 4;
  const int row0 = q_wg + r0, row1 = row0 + 8;
  const int col_lane = 2 * (lane % 4);
  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[a][j] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const uint64_t q_desc = sw128_desc(sq + wg * NA * BOX_BYTES, 16, 1024);
  const uint64_t k_desc = sw128_desc(sk, 16, 1024);
  const uint64_t v_desc = sw128_desc(sv, BOX_BYTES, 1024);

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_live; ++i) {
    const int st = i & 1, k_start = (lo + i) * BK;
    const uint32_t parity = (i >> 1) & 1;
    if (tid == 0 && i + 1 < n_live) load_kv(lo + i + 1, st ^ 1);
    __syncwarp();
    const bool live = wg_rows && tile_live(p, q_wg, WG_ROWS, k_start);

    // P as bf16 pairs, the A fragments of four k16 steps: pa its bf16
    // rounding, pl the rest (p - pa) rounded to bf16
    uint32_t pa[16], pl[16];
    float al0 = 1.f, al1 = 1.f;
    mbar_wait(bar_q + 8 + 8 * st, parity);
    if (live) {
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        // box kk / 4, 32 bytes (16 columns) per step inside the atom
        const uint32_t off = ((kk / 4) * BOX_BYTES + (kk % 4) * 32) >> 4;
        wgmma_ss(s, q_desc + off, k_desc + ((st * NA * BOX_BYTES) >> 4) + off,
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= p.scale;
      if (tile_needs_mask(p, q_wg, WG_ROWS, k_start)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int row = (j / 2) % 2 ? row1 : row0;
          const int col = k_start + 8 * (j / 4) + col_lane + j % 2;
          if (!allowed(p, row, col)) s[j] = NEG_INF;
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if ((j / 2) % 2) mx1 = fmaxf(mx1, s[j]);
        else mx0 = fmaxf(mx0, s[j]);
      }
      // a row's four threads are lanes differing in bits 0-1
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // fully masked so far: keep the accumulators exactly zero
      const bool any0 = mn0 > NEG_INF / 2, any1 = mn1 > NEG_INF / 2;
      al0 = any0 ? expf(m0 - mn0) : 1.f;
      al1 = any1 ? expf(m1 - mn1) : 1.f;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const bool second = (j / 2) % 2;
        const float mn = second ? mn1 : mn0;
        const bool any = second ? any1 : any0;
        const float x0 = any ? expf(s[j] - mn) : 0.f;
        const float x1 = any ? expf(s[j + 1] - mn) : 0.f;
        if (second) ps1 += x0 + x1;
        else ps0 += x0 + x1;
        pa[j / 2] = bf16_pair(x0, x1);
        pl[j / 2] = bf16_rest(x0, x1, pa[j / 2]);
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[a][j] *= (j / 2) % 2 ? al1 : al0;
    }

    mbar_wait(bar_q + 24 + 8 * st, parity);
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          // box a of this stage, key rows 16 kk.. (2048 bytes a step)
          const uint32_t off = ((st * NA + a) * BOX_BYTES + kk * 2048) >> 4;
          wgmma_rs(o[a], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3], v_desc + off);
          wgmma_rs(o[a], pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                   pl[4 * kk + 3], v_desc + off);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int a = 0; a < NA; ++a) reg_fence(o[a]);
    }
    __syncthreads();  // every product of this stage is done: it may refill
  }

  if (!wg_rows) return;
  // a row's sum over its four threads
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = l0 == 0.f ? 1.f : l0, den1 = l1 == 0.f ? 1.f : l1;
  // O in bf16 into this warpgroup's Q buffer, laid out as the TMA box
  // (16-byte chunk c of row r at chunk c ^ (r % 8)), then one TMA store
  const uint32_t out = sq + wg * NA * BOX_BYTES;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int second = (j / 2) % 2;
      const int r = r0 + 8 * second, chunk = j / 4;
      const float den = second ? den1 : den0;
      const uint32_t addr = out + a * BOX_BYTES + r * 128 +
                            ((chunk ^ (r % 8)) * 16) + (lane % 4) * 4;
      const uint32_t v = bf16_pair(o[a][j] / den, o[a][j + 1] / den);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (wg == 0)  // the warpgroup's own named barrier (0 is __syncthreads')
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;" ::: "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_store(&tm_o, out + a * BOX_BYTES, a * ATOM, hh, q_wg, bi);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// -- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes of this file beside cudaError_t's (which are positive).
constexpr int ERR_NO_ENCODE = -1;        // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE_BASE = -1000;   // - 1000 - CUresult of the encode

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map over a contiguous (B, S, heads, hd) bf16 tensor as dims (hd, heads,
// S, B), boxes of 64 columns x 1 head x 64 rows, 128-byte swizzle, zero fill
// out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
             int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {ATOM, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE - static_cast<int>(res);
}

template <int NA>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_attn_wgmma_kernel<NA>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<NA>::BYTES);
}

template <int NA>
int launch(const CUtensorMap (&maps)[4], const Params& p, int b,
           cudaStream_t stream) {
  const int smem = Layout<NA>::BYTES;
  const cudaError_t err = allow_smem<NA>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * p.h, (p.s + BQ - 1) / BQ);
  flash_attn_wgmma_kernel<NA><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t of the launch, or one of this file's negative
// codes.  q/o: (B, S, H, hd), k/v: (B, S, KV, hd), contiguous bfloat16 on
// 16-byte boundaries; hd a multiple of 8 and at most 256 (the wrapper
// checks).
int flash_attn_wgmma_launch(const void* q, const void* k, const void* v,
                            void* o, int b, int s, int h, int kvh, int hd,
                            int causal, int window, int chunk, float scale,
                            void* stream) {
  CUtensorMap maps[4];
  int code = make_map(&maps[0], q, b, s, h, hd);
  if (code == 0) code = make_map(&maps[1], k, b, s, kvh, hd);
  if (code == 0) code = make_map(&maps[2], v, b, s, kvh, hd);
  if (code == 0) code = make_map(&maps[3], o, b, s, h, hd);
  if (code != 0) return code;
  const Params p{s, h, kvh, hd, causal, window, chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int na = (hd + ATOM - 1) / ATOM;
  if (na == 1) return launch<1>(maps, p, b, st);
  if (na == 2) return launch<2>(maps, p, b, st);
  if (na == 3) return launch<3>(maps, p, b, st);
  return launch<4>(maps, p, b, st);
}

// The dynamic shared memory of the kernel instance for head dim hd and how
// many of its blocks one SM holds; returns 0 or a cudaError_t.
int flash_attn_wgmma_occupancy(int hd, int* smem_bytes, int* blocks_per_sm) {
  const int na = (hd + ATOM - 1) / ATOM;
  const void* fn = na == 1   ? (const void*)flash_attn_wgmma_kernel<1>
                   : na == 2 ? (const void*)flash_attn_wgmma_kernel<2>
                   : na == 3 ? (const void*)flash_attn_wgmma_kernel<3>
                             : (const void*)flash_attn_wgmma_kernel<4>;
  const cudaError_t err = na == 1   ? allow_smem<1>()
                          : na == 2 ? allow_smem<2>()
                          : na == 3 ? allow_smem<3>()
                                    : allow_smem<4>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = na == 1   ? Layout<1>::BYTES
                : na == 2 ? Layout<2>::BYTES
                : na == 3 ? Layout<3>::BYTES
                          : Layout<4>::BYTES;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, THREADS, *smem_bytes));
}

const char* flash_attn_wgmma_error_string(int code) {
  if (code == ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (code <= ERR_ENCODE_BASE)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 1000 - "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
