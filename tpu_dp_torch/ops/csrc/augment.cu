// The crop and flip draws of the on-device augmentation, hand-written for
// Hopper (sm_90a). Built by tpu_dp_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (tpu_dp_torch/ops/augment.py).
//
// Replaces XLA ops, not a TPU kernel: the JAX package draws these with
// jax.random inside its compiled step (tpu_dp/data/augment.py:30-36, keyed in
// tpu_dp/train/step.py). For row r of the global batch and the step key s
// (the train step's device counter times the microbatch count, plus the
// microbatch index), with jax_threefry_partitionable on:
//
//   key            = fold_in(PRNGKey(seed), s)    = tf(seed_key; 0, s)
//   k_off, k_flip  = split(key)                   = tf(key; 0, 0), tf(key; 0, 1)
//   k_hi, k_lo     = split(k_off)                 (randint's two words)
//   offsets[r, c]  = randint over [0, span): hi = bits(k_hi; 2r + c),
//                    lo = bits(k_lo; 2r + c),
//                    ((hi % span) * mult + lo % span) % span in uint32,
//                    mult = ((2^16 % span)^2 mod 2^32) % span
//   flips[r]       = uniform(k_flip; r) < 0.5: the f32 in [1, 2) whose
//                    mantissa is bits(k_flip; r) >> 9, minus 1
//
// where tf is threefry2x32 (20 rounds) and bits(k; j) = tf(k; j >> 32, j)
// xored word with word. All of it is uint32 arithmetic, so the kernel is the
// plain version (tpu_dp_torch/data/augment.py, int64 torch ops masked to 32
// bits) bit for bit.
//
// Bound on an H100: a call writes 17 bytes a row (two int64 offsets, one
// bool) and runs about ten threefry blocks a row (~100 integer ops each):
// at the train step's 128 rows that is nanoseconds of work at either peak,
// so the floor is the launch itself. The design is one launch per
// microbatch, one thread per row, the whole key chain recomputed in each
// thread's registers (nothing shared, nothing in device memory but the
// output), and the step read from the device counter the step already
// keeps, so a CUDA graph of the step draws for the step each replay runs.
// The plain version is four dependent threefry levels of ~170 elementwise
// launches each on a card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[r & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.bits (32-bit, partitionable) of element j under key k.
__device__ __forceinline__ uint32_t bits_at(uint2 k, uint64_t j) {
  const uint2 b = threefry2x32(k, static_cast<uint32_t>(j >> 32),
                               static_cast<uint32_t>(j));
  return b.x ^ b.y;
}

__global__ void crop_flip_draws_kernel(const int64_t* __restrict__ step,
                                       int64_t accum, int64_t micro,
                                       uint32_t seed_hi, uint32_t seed_lo,
                                       int64_t row0, int n, uint32_t span,
                                       int64_t* __restrict__ offsets,
                                       bool* __restrict__ flips) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = static_cast<uint32_t>(step[0] * accum + micro);
  const uint2 key = threefry2x32(make_uint2(seed_hi, seed_lo), 0u, s);
  const uint2 k_off = threefry2x32(key, 0u, 0u);
  const uint2 k_flip = threefry2x32(key, 0u, 1u);
  const uint2 k_hi = threefry2x32(k_off, 0u, 0u);
  const uint2 k_lo = threefry2x32(k_off, 0u, 1u);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint64_t row = static_cast<uint64_t>(row0 + i);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint64_t j = 2 * row + c;
    const uint32_t hi = bits_at(k_hi, j), lo = bits_at(k_lo, j);
    offsets[2 * i + c] = static_cast<int64_t>(
        ((hi % span) * mult + lo % span) % span);
  }
  const uint32_t u = (bits_at(k_flip, row) >> 9) | 0x3F800000u;
  flips[i] = __uint_as_float(u) - 1.0f < 0.5f;
}

}  // namespace

// offsets int64 [n][2] in [0, span), flips bool [n]: rows [row0, row0 + n)
// of the step key step[0] * accum + micro under PRNGKey(seed) = (seed_hi,
// seed_lo). Returns 0 or a CUDA error code (-2: bad arguments).
extern "C" int tpu_dp_crop_flip_draws(const int64_t* step, int64_t accum,
                                      int64_t micro, uint32_t seed_hi,
                                      uint32_t seed_lo, int64_t row0, int n,
                                      uint32_t span, int64_t* offsets,
                                      bool* flips, void* stream) {
  if (n <= 0 || span == 0 || row0 < 0 || step == nullptr ||
      offsets == nullptr || flips == nullptr)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  crop_flip_draws_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      step, accum, micro, seed_hi, seed_lo, row0, n, span, offsets, flips);
  return static_cast<int>(cudaGetLastError());
}
