// Cross-block sums in a fixed order, in one launch, without float atomics:
// the "last block finishes the sum" pattern shared by conv_block.cu (the
// BatchNorm moments of `emit_stats`) and xent.cu (the batch-mean loss).
//
// Every block writes its partial row to device memory and takes a ticket
// with an integer atomicAdd on a counter; the block that draws the last
// ticket sums the rows in index order -- never arrival order -- so the
// result does not depend on which block finishes last. Two launches on the
// same input give bit-identical sums.
//
// Counters are int32 in device memory owned by the caller, zero before the
// launch; the block that finishes a counter's sum sets it back to 0 before
// it exits, so the next launch on the stream (or the next replay of a CUDA
// graph that captured this one) finds it zeroed. A counter must not be
// shared by two launches that can run at once: the wrappers keep one
// buffer per (device, stream).

#pragma once

#include <cuda_runtime.h>

namespace tpu_dp {

// fence.acq_rel at GPU scope: cumulative, so after a __syncthreads it
// orders every thread's earlier stores of the block before thread 0's next
// write (release), and thread 0's earlier reads before every thread's next
// read (acquire). Lighter than __threadfence() (fence.sc).
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Thread 0's ticket at `counter` (0 in the other threads) for a 1-D block,
// after the block's stores that the last block will read: a barrier, then
// thread 0's release fence and integer atomicAdd (the barrier-then-fence
// pattern of CUTLASS's grid barriers). The result is needed only by
// `drew_last`, so work may run between the two while the atomic is in
// flight.
__device__ __forceinline__ int draw_ticket(int* counter) {
  __syncthreads();
  if (threadIdx.x != 0) return 0;
  fence_acq_rel_gpu();
  return atomicAdd(counter, 1);
}

// True, in every thread of the block, when `ticket` (from `draw_ticket`)
// was the last of the n blocks that arrive at the counter; thread 0 then
// fences (acquire) before the barrier. The other blocks' stores must be
// read with strong loads (`load_relaxed_gpu_if`), never through the
// non-coherent path (__ldg, `const __restrict__`) or a plain load, which
// may return stale lines.
__device__ __forceinline__ bool drew_last(int ticket, int n) {
  int last = 0;
  if (threadIdx.x == 0) {
    last = ticket == n - 1;
    if (last) fence_acq_rel_gpu();
  }
  return __syncthreads_or(last) != 0;
}

// The counter's sum is complete: back to 0 for the next launch. Called by
// one thread of the block that finished it.
__device__ __forceinline__ void reset_counter(int* counter) {
  atomicExch(counter, 0);
}

// *p if `pred`, else 0: a value another block of this launch wrote, read
// with a strong relaxed load at GPU scope (served by L2, never a stale L1
// line), volatile and clobbering memory so the compiler keeps it after the
// barrier of `drew_last` (CUDA's __ldcg is a plain asm the compiler may
// move). One predicated load, no branch, so a row of them stays
// straight-line code.
__device__ __forceinline__ float load_relaxed_gpu_if(const float* p,
                                                     bool pred) {
  float v = 0.f;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.relaxed.gpu.global.f32 %0, [%1];\n}\n"
      : "+f"(v)
      : "l"(p), "r"((int)pred)
      : "memory");
  return v;
}

// sum over r = 0, 1, ..., n - 1 of p[r * stride], in that order, in f32
// from 0 (the plain twins replay it with rows added one at a time). Up to
// kU loads are issued before the first add: predicated, not branched
// around, and held by the empty asm until all are issued, so the compiler
// cannot put each add right behind its load and make the loads wait one
// after another. Rows past n - 1 are not loaded (repeated strong loads of
// one line queue in L2).
template <int kU = 32>
__device__ __forceinline__ float ordered_sum(const float* p, long long stride,
                                             int n) {
  float t = 0.f;
  for (int r0 = 0; r0 < n; r0 += kU) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      v[u] = load_relaxed_gpu_if(p + (long long)(r0 + u) * stride,
                                 r0 + u < n);
#pragma unroll
    for (int u = 0; u < kU; ++u) asm volatile("" : "+f"(v[u]));
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (r0 + u < n) t = __fadd_rn(t, v[u]);
  }
  return t;
}

}  // namespace tpu_dp
