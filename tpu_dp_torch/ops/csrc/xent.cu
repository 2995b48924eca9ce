// Per-example softmax cross-entropy, forward and backward, hand-written for
// Hopper (sm_90a). Built by tpu_dp_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (tpu_dp_torch/ops/xent.py).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` in
// tpu_dp/ops/xent.py (launched through pl.pallas_call by `_fwd_local` and
// `_bwd_local`):
//
//   forward   loss[b]       = logsumexp(l[b, :]) - l[b, label[b]]      f32
//   backward  dlogits[b, c] = (softmax(l[b, :])[c] - [c == label[b]]) * ct_b
//                             stored in the logits' dtype
//
// with every per-row quantity (max, sum of exp, log, softmax) in f32, as the
// TPU kernels compute it. The label's one-hot compares class indices, as the
// TPU kernels' iota compare does, so a label outside [0, C) matches no class:
// its loss is logsumexp(l[b, :]) and its gradient softmax * ct.
//
// The training loss is the batch mean (`mean_softmax_xent`), and it takes one
// launch each way. Up to `one_cta` rows (the wrapper's ONE_CTA_MAX_ROWS) and
// C <= 32 it is ONE block, so nothing crosses blocks and nothing but the
// output is written:
//   - forward: four threads per row, each holding a quarter of the row's
//     lanes in registers; thread 0 of a row adds the row's loss to its sum,
//     rows in order; the warp sums its threads' sums by shuffles, and
//     thread 0 sums the warps' sums from shared memory in warp order and
//     divides by B. No partials buffer, no ticket, no second phase; the
//     order is fixed, so the mean is bit-identical from launch to launch
//     and replay to replay;
//   - backward: the same rows per thread, each row read once, softmax -
//     onehot computed once per element and scaled by ct[0] * (1 / B) in f32
//     (the scalar cotangent read from the device, as autograd's
//     MeanBackward computes it on a card: a division by a host scalar is a
//     multiply by its f32 reciprocal there).
// Four threads per row, not a warp: one block has one SM's shuffle rate,
// and a warp per row spends 15 shuffles a row (a thread per row, on the
// other hand, leaves a [128, 10] launch four warps to hide its latencies
// with). The row's threads replay the warp-per-row kernels' butterfly sums
// add for add, so each row's loss and gradient are bit-identical on both
// routes, and the mean's gradient is the per-example kernel's behind
// MeanBackward, bit for bit. Above `one_cta` rows, or past 32 classes, the
// forward's mean variant keeps the multi-block route: each block's <= 8 row
// losses are summed in row order into the block's partial, and the last
// block to arrive (an integer ticket, ordered_reduce.cuh) sums the partials
// in block order and divides by B.
// The backward takes the cotangent with a stride and a divisor there: the
// per-example loss passes stride 1 and divisor 1 (ct_b = ct[b]), the mean
// its scalar cotangent with stride 0 and divisor B.
//
// Bound on an H100: at CIFAR head sizes (C = 10 or 100, B = 128) a call moves
// a few KB (logits read once, loss or gradient written once), nanoseconds at
// 3.35 TB/s; the floor is the launch itself (a few microseconds, measured as
// `tpu_dp_empty_kernel`'s device time), not bytes or operations. The design
// therefore does one pass per direction with nothing in device memory beyond
// the output: one warp per row, lanes striding over the classes, max and sum
// folded with warp shuffles (multi-block route), or four threads per row
// (one-CTA route). The TPU kernels' (block, C) VMEM tile padded to 128 lanes
// has no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ordered_reduce.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block (multi-block route)
constexpr int kOneCtaMaxThreads = 1024;  // the one-CTA block
constexpr int kOneCtaMaxC = 32;  // classes of a row: one warp's lanes

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The row's max and sum of exp(l - max); every lane returns both.
template <typename T>
__device__ __forceinline__ void row_max_sum(const T* r, int C, int lane,
                                            float& m, float& s) {
  m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, load_f32(r + c));
  m = warp_max(m);
  s = 0.f;
  for (int c = lane; c < C; c += 32) s += expf(load_f32(r + c) - m);
  s = warp_sum(s);
}

// Per-example: loss [B]. kMean: loss may be null; partials [gridDim.x] f32
// scratch, ticket one zero int32, mean the f32 scalar.
template <typename T, typename L, bool kMean>
__global__ void __launch_bounds__(kWarps * 32)
xent_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                float* loss, float* partials, int* ticket, float* mean, int B,
                int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  float l = 0.f;
  if (row < B) {  // whole warps
    const T* r = logits + (long long)row * C;
    const long long label = (long long)labels[row];
    float m, s;
    row_max_sum(r, C, lane, m, s);
    // The label's logit, gathered by comparing the class index.
    float tl = 0.f;
    for (int c = lane; c < C; c += 32)
      if (c == label) tl = load_f32(r + c);
    tl = warp_sum(tl);
    l = (logf(s) + m) - tl;
    if (lane == 0 && loss != nullptr) loss[row] = l;
  }
  if (!kMean) return;
  __shared__ float rows[kWarps];
  if (lane == 0) rows[warp] = l;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = min(kWarps, B - (int)blockIdx.x * kWarps);
    float t = 0.f;
    for (int w = 0; w < n; ++w) t += rows[w];  // row order
    partials[blockIdx.x] = t;
  }
  if (!tpu_dp::drew_last(tpu_dp::draw_ticket(ticket), gridDim.x)) return;
  if (threadIdx.x == 0) {
    *mean = tpu_dp::ordered_sum(partials, 1, gridDim.x) / (float)B;
    tpu_dp::reset_counter(ticket);
  }
}

// ct_b = ct[b * ct_stride] * (1 / div): stride 1 and div 1 for a
// per-example cotangent, stride 0 and div B for the batch mean's.
template <typename T, typename L>
__global__ void __launch_bounds__(kWarps * 32)
xent_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                const float* __restrict__ ct, int ct_stride, int div,
                T* __restrict__ dlogits, int B, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const T* r = logits + (long long)row * C;
  T* d = dlogits + (long long)row * C;
  const long long label = (long long)labels[row];
  float m, s;
  row_max_sum(r, C, lane, m, s);
  const float g = ct[(long long)row * ct_stride] * (1.f / (float)div);
  for (int c = lane; c < C; c += 32) {
    const float p = expf(load_f32(r + c) - m) / s;
    const float onehot = (c == label) ? 1.f : 0.f;
    store_from_f32(d + c, (p - onehot) * g);
  }
}

// The one-CTA route: four threads per row (kRowThreads, adjacent lanes),
// thread q holding the per-example kernels' lanes q, q + 4, ..., q + 28 of
// the row (kRowLanes values, -inf or 0 past C). Their warp_sum is a
// butterfly over xor 16, 8, 4, 2, 1: levels 16, 8 and 4 pair lanes of one
// thread, so the thread adds them in the butterfly's order, and levels 2 and
// 1 are shuffles between the row's threads -- the same adds in the same
// order, so a row's loss and gradient are bit-identical on both routes and
// the mean's gradient is the per-example kernel's behind MeanBackward, bit
// for bit. Every thread of the block runs the shuffles (rows past B compute
// on padding and are not used), so the full-warp masks hold.
constexpr int kRowThreads = 4;
constexpr int kRowLanes = 32 / kRowThreads;

// The butterfly of a thread's lanes (levels 16, 8, 4), then of the row's
// threads (levels 2, 1).
__device__ __forceinline__ float row_sum(float (&v)[kRowLanes]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j + 4];  // lanes 16 apart
  v[0] = v[0] + v[2];                                  // 8 apart
  v[1] = v[1] + v[3];
  float t = v[0] + v[1];                               // 4 apart
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  return t;
}

__device__ __forceinline__ float row_max(float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
}

// This thread's lanes of row r (valid: the row exists) into x, the row's
// max m and sum of exp(x - m) s (every thread of the row gets both).
template <typename T>
__device__ __forceinline__ void row_lanes(const T* r, bool valid, int C,
                                          int q, float (&x)[kRowLanes],
                                          float& m, float& s) {
#pragma unroll
  for (int j = 0; j < kRowLanes; ++j) {
    const int c = q + kRowThreads * j;
    x[j] = valid && c < C ? load_f32(r + c) : -INFINITY;
  }
  m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kRowLanes; ++j) m = fmaxf(m, x[j]);
  m = row_max(m);
  float e[kRowLanes];
#pragma unroll
  for (int j = 0; j < kRowLanes; ++j)
    e[j] = q + kRowThreads * j < C ? expf(x[j] - m) : 0.f;
  s = row_sum(e);
}

// The batch mean in one block of min(1024, 4 B rounded up to 32) threads
// (B <= the wrapper's ONE_CTA_MAX_ROWS, C <= 32): each pass takes
// blockDim.x / 4 rows; thread 0 of a row adds the row's loss to its sum, in
// row order across passes; the warp sums its threads' sums by the
// butterfly, and thread 0 sums the warps' sums from shared memory in warp
// order and divides by B. loss [B] may be null.
template <typename T, typename L>
__global__ void __launch_bounds__(kOneCtaMaxThreads)
xent_fwd_mean_one_cta(const T* __restrict__ logits,
                      const L* __restrict__ labels, float* loss, float* mean,
                      int B, int C) {
  const int q = threadIdx.x % kRowThreads;
  const int per_pass = blockDim.x / kRowThreads;
  float acc = 0.f;
  for (int base = 0; base < B; base += per_pass) {
    const int row = base + threadIdx.x / kRowThreads;
    const bool valid = row < B;
    const T* r = logits + (long long)row * C;
    float x[kRowLanes], m, s;
    row_lanes(r, valid, C, q, x, m, s);
    const long long label = valid ? (long long)labels[row] : -1;
    float t[kRowLanes];
#pragma unroll
    for (int j = 0; j < kRowLanes; ++j) {
      const int c = q + kRowThreads * j;
      t[j] = c < C && c == label ? x[j] : 0.f;
    }
    const float tl = row_sum(t);
    const float l = (logf(s) + m) - tl;
    if (valid && q == 0) {
      if (loss != nullptr) loss[row] = l;
      acc += l;
    }
  }
  acc = warp_sum(acc);
  __shared__ float warps[kOneCtaMaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += warps[w];
    *mean = sum / (float)B;
  }
}

// The batch mean's gradient in one block: the forward's rows per thread,
// each row read once; d = (softmax - onehot) * (ct[0] * (1 / B)).
template <typename T, typename L>
__global__ void __launch_bounds__(kOneCtaMaxThreads)
xent_bwd_mean_one_cta(const T* __restrict__ logits,
                      const L* __restrict__ labels,
                      const float* __restrict__ ct, T* __restrict__ dlogits,
                      int B, int C) {
  const int q = threadIdx.x % kRowThreads;
  const int per_pass = blockDim.x / kRowThreads;
  const float g = ct[0] * (1.f / (float)B);
  for (int base = 0; base < B; base += per_pass) {
    const int row = base + threadIdx.x / kRowThreads;
    const bool valid = row < B;
    float x[kRowLanes], m, s;
    row_lanes(logits + (long long)row * C, valid, C, q, x, m, s);
    if (!valid) continue;  // after the row's shuffles
    const long long label = (long long)labels[row];
    T* d = dlogits + (long long)row * C;
#pragma unroll
    for (int j = 0; j < kRowLanes; ++j) {
      const int c = q + kRowThreads * j;
      if (c < C) {
        const float p = expf(x[j] - m) / s;
        const float onehot = (c == label) ? 1.f : 0.f;
        store_from_f32(d + c, (p - onehot) * g);
      }
    }
  }
}

// No body: its device time under the profiler is the floor of a launch.
__global__ void empty_kernel() {}

int one_cta_threads(int B) {
  const long long n = (long long)B * kRowThreads;
  return n >= kOneCtaMaxThreads ? kOneCtaMaxThreads
                                : (int)(n + 31) / 32 * 32;
}

template <typename T, typename L>
int launch_one_cta_fwd(const void* logits, const void* labels, float* loss,
                       float* mean, int B, int C, cudaStream_t s) {
  xent_fwd_mean_one_cta<T, L><<<1, one_cta_threads(B), 0, s>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), loss,
      mean, B, C);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_one_cta_bwd(const void* logits, const void* labels,
                       const float* ct, void* dlogits, int B, int C,
                       cudaStream_t s) {
  xent_bwd_mean_one_cta<T, L><<<1, one_cta_threads(B), 0, s>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), ct,
      static_cast<T*>(dlogits), B, C);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_fwd(const void* logits, const void* labels, float* loss,
               float* partials, int* ticket, float* mean, int B, int C,
               cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  if (mean == nullptr)
    xent_fwd_kernel<T, L, false><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels), loss,
        nullptr, nullptr, nullptr, B, C);
  else
    xent_fwd_kernel<T, L, true><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels), loss,
        partials, ticket, mean, B, C);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const void* logits, const void* labels, const float* ct,
               int ct_stride, int div, void* dlogits, int B, int C,
               cudaStream_t s) {
  xent_bwd_kernel<T, L><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), ct,
      ct_stride, div, static_cast<T*>(dlogits), B, C);
  return (int)cudaGetLastError();
}

// fn(T{}, L{}) for the logits' and labels' types: dtype 0 = f32 logits, 1 =
// bf16; label64 1 = int64 labels, 0 = int32. -1 for a dtype that does not
// exist.
template <typename Fn>
int by_types(int dtype, int label64, Fn&& fn) {
  if (dtype == 0)
    return label64 ? fn(float{}, int64_t{}) : fn(float{}, int32_t{});
  if (dtype == 1)
    return label64 ? fn(__nv_bfloat16{}, int64_t{})
                   : fn(__nv_bfloat16{}, int32_t{});
  return -1;
}

}  // namespace

// dtype: 0 = f32 logits, 1 = bf16 logits; label64: int64 (1) or int32 (0)
// labels. logits [B][C] contiguous, labels [B]. Per-example (mean null):
// loss [B] f32. Batch mean: mean the f32 scalar, loss [B] or null; with
// one_cta (B at most the wrapper's ONE_CTA_MAX_ROWS, C <= 32) one block and
// no scratch, else partials f32 scratch of ceil(B / 8) floats and ticket one
// int32 that is zero (and is left zero). Returns 0 or a CUDA error code (-1
// for a dtype that does not exist or a missing pointer, -2 for a bad shape).
extern "C" int tpu_dp_xent_fwd(int dtype, int label64, const void* logits,
                               const void* labels, float* loss,
                               float* partials, int* ticket, float* mean,
                               int one_cta, int B, int C, void* stream) {
  if (B <= 0 || C <= 0 || (one_cta && (mean == nullptr || C > kOneCtaMaxC)))
    return -2;
  if (mean == nullptr ? loss == nullptr
                      : (!one_cta && (partials == nullptr ||
                                      ticket == nullptr)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_types(dtype, label64, [&](auto t, auto y) {
    using T = decltype(t);
    using L = decltype(y);
    return one_cta ? launch_one_cta_fwd<T, L>(logits, labels, loss, mean, B,
                                              C, s)
                   : launch_fwd<T, L>(logits, labels, loss, partials, ticket,
                                      mean, B, C, s);
  });
}

// ct f32, read at b * ct_stride (1: a [B] cotangent; 0: a scalar one) and
// multiplied by 1 / div (1, or B for the mean); dlogits [B][C] in the
// logits' dtype. one_cta (the mean's scalar cotangent: stride 0, div B;
// C <= 32): one block.
extern "C" int tpu_dp_xent_bwd(int dtype, int label64, const void* logits,
                               const void* labels, const float* ct,
                               int ct_stride, int div, void* dlogits,
                               int one_cta, int B, int C, void* stream) {
  if (B <= 0 || C <= 0 || div <= 0 || ct_stride < 0 ||
      (one_cta && (ct_stride != 0 || div != B || C > kOneCtaMaxC)))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_types(dtype, label64, [&](auto t, auto y) {
    using T = decltype(t);
    using L = decltype(y);
    return one_cta ? launch_one_cta_bwd<T, L>(logits, labels, ct, dlogits, B,
                                              C, s)
                   : launch_bwd<T, L>(logits, labels, ct, ct_stride, div,
                                      dlogits, B, C, s);
  });
}

// The launch floor: an empty kernel on one block of `threads`. Returns 0
// or a CUDA error code.
extern "C" int tpu_dp_empty_kernel(int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  empty_kernel<<<1, threads, 0, s>>>();
  return (int)cudaGetLastError();
}
