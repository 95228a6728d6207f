// The threefry2x32 counter hash for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package draws its random numbers with
// XLA's threefry (jax/_src/prng.py, threefry2x32_p), which the port
// reproduces bit for bit so that one seed gives the reference's trials.
// The port's random module (repro_torch/random.py) hashes through this
// kernel for every split, fold_in and bits of a CUDA key.
//
// One thread per (key, counter): key kk of n_keys, counter j < n, hashes the
// pair (0, count_lo + j) -- the iota of a split or of bits when count_lo =
// 0 (the high word of jax's 64-bit iota is 0 below 2^32 counters), the
// fold_in datum when n = 1 -- with the key's two words.
// Keys and outputs are int64 holding uint32 (the port's idiom), so the
// wrapper converts nothing.  The output is the two words, interleaved as
// (n_keys, n, 2) (a split's keys), or their xor as (n_keys, n) (the
// 32-bit bits of _threefry_random_bits_partitionable).
//
// What bounds it on the H100: integer operations.  A hash is about 80
// 32-bit integer operations (20 rounds of an add, a rotate -- one funnel
// shift -- and an xor; five key injections of three adds) for 8-16 bytes
// of output; the card's integer rate retires that far faster than a
// launch's fixed cost at the sizes the simulation draws (10^2-10^6
// counters), so the design is the plainest one: no shared memory, no loop
// over elements, the rounds unrolled by the compiler.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

__global__ void threefry_kernel(const long long* __restrict__ keys,
                                long long* __restrict__ out, long long total,
                                long long n, uint32_t count_lo,
                                int xor_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const long long kk = i / n;
  const long long j = i - kk * n;
  uint32_t x0 = 0u;
  uint32_t x1 = count_lo + static_cast<uint32_t>(j);
  threefry2x32(static_cast<uint32_t>(keys[2 * kk]),
               static_cast<uint32_t>(keys[2 * kk + 1]), x0, x1);
  if (xor_out) {
    out[i] = static_cast<long long>(x0 ^ x1);
  } else {
    out[2 * i] = static_cast<long long>(x0);
    out[2 * i + 1] = static_cast<long long>(x1);
  }
}

constexpr int kThreads = 256;

}  // namespace

// keys: (n_keys, 2) int64 holding uint32; out: (n_keys, n, 2) int64, or
// (n_keys, n) when xor_out.  Returns the launch's cudaError_t (0 when it
// was taken).
extern "C" int threefry_launch(const long long* keys, long long* out,
                               long long n_keys, long long n,
                               unsigned count_lo, int xor_out,
                               void* stream) {
  if (n_keys < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n_keys * n;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  threefry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      keys, out, total, n, count_lo, xor_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
