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
//   backward  dlogits[b, c] = (softmax(l[b, :])[c] - [c == label[b]]) * ct[b]
//                             stored in the logits' dtype
//
// with every per-row quantity (max, sum of exp, log, softmax) in f32, as the
// TPU kernels compute it. The label's one-hot compares class indices, as the
// TPU kernels' iota compare does, so a label outside [0, C) matches no class:
// its loss is logsumexp(l[b, :]) and its gradient softmax * ct.
//
// Bound on an H100: at CIFAR head sizes (C = 10 or 100, B = 128) a call moves
// a few KB (logits read once, loss or gradient written once), nanoseconds at
// 3.35 TB/s; the floor is the launch latency (a few microseconds), not bytes
// or operations. The design therefore does one pass per direction with no
// intermediate in device memory: one warp per row, lanes striding over the
// classes (C = 100 loops four times), max and sum folded with warp shuffles.
// The TPU kernels' (block, C) VMEM tile padded to 128 lanes has no
// counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

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

template <typename T, typename L>
__global__ void __launch_bounds__(kWarps * 32)
xent_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                float* __restrict__ loss, int B, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave together
  const T* r = logits + (long long)row * C;
  const long long label = (long long)labels[row];
  float m, s;
  row_max_sum(r, C, lane, m, s);
  // The label's logit, gathered by comparing the class index.
  float tl = 0.f;
  for (int c = lane; c < C; c += 32)
    if (c == label) tl = load_f32(r + c);
  tl = warp_sum(tl);
  if (lane == 0) loss[row] = (logf(s) + m) - tl;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kWarps * 32)
xent_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                const float* __restrict__ ct, T* __restrict__ dlogits, int B,
                int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const T* r = logits + (long long)row * C;
  T* d = dlogits + (long long)row * C;
  const long long label = (long long)labels[row];
  float m, s;
  row_max_sum(r, C, lane, m, s);
  const float g = ct[row];
  for (int c = lane; c < C; c += 32) {
    const float p = expf(load_f32(r + c) - m) / s;
    const float onehot = (c == label) ? 1.f : 0.f;
    store_from_f32(d + c, (p - onehot) * g);
  }
}

template <typename T, typename L>
int launch_fwd(const void* logits, const void* labels, float* loss, int B,
               int C, cudaStream_t s) {
  xent_fwd_kernel<T, L><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), loss, B,
      C);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const void* logits, const void* labels, const float* ct,
               void* dlogits, int B, int C, cudaStream_t s) {
  xent_bwd_kernel<T, L><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), ct,
      static_cast<T*>(dlogits), B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32 logits, 1 = bf16 logits; label64: int64 (1) or int32 (0)
// labels. logits [B][C] contiguous, labels [B], loss [B] f32. Returns 0 or a
// CUDA error code (-1 for a dtype that does not exist, -2 for a bad shape).
extern "C" int tpu_dp_xent_fwd(int dtype, int label64, const void* logits,
                               const void* labels, float* loss, int B, int C,
                               void* stream) {
  if (B <= 0 || C <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return label64 ? launch_fwd<float, int64_t>(logits, labels, loss, B, C, s)
                   : launch_fwd<float, int32_t>(logits, labels, loss, B, C, s);
  if (dtype == 1)
    return label64
               ? launch_fwd<__nv_bfloat16, int64_t>(logits, labels, loss, B,
                                                    C, s)
               : launch_fwd<__nv_bfloat16, int32_t>(logits, labels, loss, B,
                                                    C, s);
  return -1;
}

// ct [B] f32; dlogits [B][C] in the logits' dtype.
extern "C" int tpu_dp_xent_bwd(int dtype, int label64, const void* logits,
                               const void* labels, const float* ct,
                               void* dlogits, int B, int C, void* stream) {
  if (B <= 0 || C <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return label64 ? launch_bwd<float, int64_t>(logits, labels, ct, dlogits,
                                                B, C, s)
                   : launch_bwd<float, int32_t>(logits, labels, ct, dlogits,
                                                B, C, s);
  if (dtype == 1)
    return label64 ? launch_bwd<__nv_bfloat16, int64_t>(logits, labels, ct,
                                                        dlogits, B, C, s)
                   : launch_bwd<__nv_bfloat16, int32_t>(logits, labels, ct,
                                                        dlogits, B, C, s);
  return -1;
}
