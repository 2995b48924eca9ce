// Fused affine + residual + ReLU + 3x3 stride-1 conv, hand-written for Hopper
// (sm_90a). Built by tpu_dp_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (tpu_dp_torch/ops/conv_block.py).
//
// Replaces the TPU kernel `_conv_kernel` in tpu_dp/ops/conv_block.py
// (launched through pl.pallas_call by `_run_local`), every variant:
//
//   z = act(x * scale + shift [+ residual])      f32, rounded to bf16
//   y = conv3x3_SAME(z, W)                        bf16 operands, f32 accumulator
//   y is rounded to bf16 and stored as x's dtype; `emit_z` also stores z
//   (the bf16-rounded value, as x's dtype); `emit_stats` also produces the
//   per-channel BatchNorm moments [sum(y), sum(y^2)] of the rounded y, in f32.
//
// The training backward reuses the same kernel for its input-grad conv
// (dz = conv3x3_SAME(ct, flip_hw(W).swap_io) with activate off, scale 1 and
// shift 0): the wrapper only repacks the weight.
//
// What computes the same thing, not how: the TPU kernel packs the conv as one
// [rows,3C]x[3C,3C] MXU matmul realigned with pltpu.roll to fill the MXU. Here
// it is an implicit GEMM on Hopper's warpgroup tensor-core instruction
// (wgmma.mma_async, bf16 in, f32 accumulators in registers): M = output
// pixels, N = output channels, K = 9 taps x C input channels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): a ResNet-18 call is
// 2*B*H*W*9*C*C flops, 2.42 GFLOP at B=32 and 9.66 GFLOP at B=128 at every
// stage (the channel count doubles as the area quarters): 9.8 us of
// tensor-core time at B=128. Stage 0 (32x32x64) moves x, y (+z, +residual)
// at 33.6 MB each in f32 at B=128 and is memory-bound; the later stages move
// less and are compute-bound. So z stays out of device memory (it is made in
// shared memory from x, and written out only when `emit_z` asks for it, by
// exactly one channel block per pixel), x, residual and y cross device
// memory once, and the moments come from the accumulators in the epilogue.
//
// Block: two warpgroups (256 threads). The block's output tile is BM
// consecutive pixels in flattened (b, h, w) order (whole rows of one image,
// or whole images when H*W < BM) by BN output channels. With BM = 128 each
// warpgroup owns 64 pixels x BN channels (wgmma m64nBNk16); with BM = 64 the
// two share the pixels and split the channels (m64n(BN/2)k16). For each
// 64-channel chunk of the input:
//   1. the threads build the bf16 z tile with its 1-pixel halo in shared
//      memory (affine, residual and ReLU in f32 with unfused multiply then
//      add, rounded to bf16; halo pixels outside the image are 0, i.e. the
//      SAME padding applies to z after the activation) -- once per chunk,
//      2-4 items of 8 channels in flight per thread;
//   2. for each of the 9 taps, every warp gathers its A fragments from the
//      halo tile with ldmatrix (per-lane row addresses: a 64-row wgmma tile
//      crosses image rows, or images at 4x4, so a tap's rows have no uniform
//      stride for a shared-memory descriptor) and issues register-A wgmmas
//      (k16 each) against the tap's weight tile, two k16 steps per group;
//      the next group's gather overlaps the group in flight
//      (wgmma.wait_group 1).
// The weights stream through a ring of 6 (BN = 128) or 8 (BN = 64) stages,
// 64-96 KB in flight against L2 latency, one [BN c_out][64 c_in] tile per
// (chunk, tap): thread 0 issues one TMA load per stage (cp.async.bulk.tensor,
// 128-byte swizzle = the K-major layout wgmma's B descriptor reads) with
// mbarrier full/empty handshakes, running 4-6 taps ahead of the MMAs and
// through the z prologue. The tensor map is encoded once per (weight
// pointer, C, BN) and cached. There is no separate producer warp: wgmma
// kernels get registers per warpgroup, so a 288-thread block counts as
// three and is capped at 168 registers a thread, which spilled.
// Tiles with m64n64 or smaller accumulators per warpgroup run two blocks per
// SM (<= 128 registers), so one block's prologue and epilogue overlap the
// other's MMAs; (128, 128) runs one.
//
// Weight traffic from L2 per launch is (B*H*W/BM) * 9*C*C*2 bytes: 151 MB at
// every stage at B=128 with the earlier 64-pixel tile, 75.5 MB now at
// stages 0-2 (BM = 128) and 151 MB at stage 3 (BM = 64, see below). z is
// rebuilt by each of the C/BN channel blocks: once at stages 0-1, twice at
// stage 2, 8 times at stage 3 (B=128).
//
// Tile per launch (`pick_tile`): the first of (BM, BN) = (128, 128),
// (128, 64), (64, 64) whose shape fits and whose grid fills the card (128
// blocks, one wave on 132 SMs, times the blocks an SM holds of that tile);
// else the fitting tile with the most blocks. At B=128: stage 0 (128, 64)
// 1024 blocks, stage 1 (128, 128) 256, stage 2 (128, 128) 128, stage 3
// (64, 64) 256. At B=32: (128, 64) 256 / (64, 64) 256 / (64, 64) 128 /
// (64, 64) 64 blocks.
//
// Moments without float atomics: the TPU grid runs in order and carries the
// sum from step to step; Hopper's blocks run in no order, and atomics would
// make the sum's rounding change from run to run. Each block folds its
// pixels' rounded y per channel with a fixed xor-shuffle tree over the
// accumulator fragments, then its warps in a fixed order through shared
// memory, and writes its row partials[blockIdx.x][2][C]. The cross-block sum
// is folded into the same launch (ordered_reduce.cuh): the blocks of each
// group of `group` consecutive blockIdx.x take integer tickets, and the
// last of a group to arrive sums the group's rows in index order into a
// group row; the last group-finisher of a blockIdx.y column sums the group
// rows in order into stats[2][C]. With one group (stage 3 at B=128, the
// small ragged batches) the group-finisher writes stats itself. A block
// sums its moments, writes its row and draws its ticket (a barrier, then
// one release fence and the atomic in thread 0) before it stores y, so the
// fence waits on the row alone and the ticket's round trip overlaps y's
// stores. One thread owns one of the 2*BN columns and
// walks its rows with 32 loads in flight: one L2 round trip per level. The order is fixed by the indices,
// not by arrival, so two launches on the same input give bit-identical
// stats; `ordered_stats_sum` in conv_block.py replays it in torch ops. The
// tail runs after the accumulators are dead. Eval and input-grad launches
// (stats off) skip it.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "ordered_reduce.cuh"

namespace {

constexpr int kChunk = 64;        // input channels per chunk: one 128-byte row
constexpr int kRow = kChunk + 8;  // z halo row in bf16 (144 bytes: no bank
                                  // conflicts for ldmatrix on consecutive rows)
// Weight ring depth: 64-96 KB in flight, enough to cover L2 latency.
__host__ __device__ constexpr int ring_stages(int bn) {
  return bn == 128 ? 6 : 8;
}
constexpr int kThreads = 256;     // two warpgroups
constexpr int kMaxSmem = 232448;  // per block on an H100
constexpr int kFillBlocks = 128;  // about one wave on 132 SMs

struct Args {
  const void* x;
  const float* scale;
  const float* shift;
  const void* res;
  void* y;
  void* z;
  float* partials;  // [gridDim.x + groups (if > 1)][2][C]: rows, group rows
  float* stats;     // [2][C]
  int* tickets;     // [gridDim.y][groups + 1], zero at launch and at exit
  int B, H, W, C, rows;  // rows: image rows in a tile (H when H*W < BM)
  int has_res, emit_z, activate, stats_on;
  int group;             // rows per level-1 group of the stats fold
};

template <typename T> struct Vec8;

template <> struct Vec8<float> {
  __device__ static void load(const float* p, float v[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const __nv_bfloat16 q[8]) {
    float4 a, b;
    a.x = __bfloat162float(q[0]); a.y = __bfloat162float(q[1]);
    a.z = __bfloat162float(q[2]); a.w = __bfloat162float(q[3]);
    b.x = __bfloat162float(q[4]); b.y = __bfloat162float(q[5]);
    b.z = __bfloat162float(q[6]); b.w = __bfloat162float(q[7]);
    *reinterpret_cast<float4*>(p) = a;
    *reinterpret_cast<float4*>(p + 4) = b;
  }
};

template <> struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  }
  __device__ static void store(__nv_bfloat16* p, const __nv_bfloat16 q[8]) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
  }
};

__device__ __forceinline__ void store_pair(float* p, __nv_bfloat16 a,
                                           __nv_bfloat16 b) {
  *reinterpret_cast<float2*>(p) =
      make_float2(__bfloat162float(a), __bfloat162float(b));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 a,
                                           __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// handshake that never completes traps (the launch fails with an error)
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// One TMA tile load of the weight map at (c_in = c0, row = c1) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile stored with the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-aligned).
// Advancing K by 16 bf16 (32 bytes) adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset: one 8-row atom
  d |= (uint64_t)1 << 62;             // SWIZZLE_128B
  return d;
}

// D[64 x N] += A[64 x 16] (registers) * B[16 x N] (shared, K-major).
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Blocks per SM: two for the tiles whose warpgroups hold m64n64 or smaller
// accumulators (<= 128 registers a thread), so one block's z prologue and
// epilogue overlap the other's MMAs; one for m64n128.
__host__ __device__ constexpr int min_blocks(int bm, int bn) {
  return bn * (bm / 64) / 2 <= 64 ? 2 : 1;
}

// x, res, y, z: [B,H,W,C] of T, NHWC contiguous. The weight map views the
// packed weight [9][C][C] bf16 ([tap][c_out][c_in]) as rows tap*C + c_out of
// C input channels. scale, shift: [C] f32. Stats only: partials holds the
// blocks' [sum(y), sum(y^2)] rows ([gridDim.x][2][C] f32) and, after them,
// the group rows; stats [2][C] f32 is their ordered sum.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, min_blocks(BM, BN))
conv_block_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr int kWgM = BM / 64;          // warpgroups along the pixels
  constexpr int kNw = BN * kWgM / 2;     // output channels per warpgroup
  constexpr int kAcc = kNw / 2;          // f32 accumulators per thread
  constexpr int kStageBytes = BN * 128;  // one [BN][64] bf16 weight tile
  constexpr int kRowGroups = 4 * kWgM;   // 16-pixel warp rows in the tile
  constexpr int kStages = ring_stages(BN);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring_s = (raw_s + 1023u) & ~1023u;  // swizzle atoms
  unsigned char* ring = smem_raw + (ring_s - raw_s);
  __nv_bfloat16* zs =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * kStageBytes);
  const int W = a.W, H = a.H, C = a.C, rows = a.rows;
  const int hw = H * W;
  const int n_img = BM / (rows * W);  // images in the tile (>= 1)
  const int zs_px = n_img * (rows + 2) * (W + 2);
  float* red = reinterpret_cast<float*>(zs + zs_px * kRow);  // [rg][2][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kRowGroups * 2 * BN);
  const uint32_t full_s = smem_u32(bars);          // full[kStages]
  const uint32_t empty_s = full_s + 8 * kStages;   // empty[kStages]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  const int n_iter = (C / kChunk) * 9;  // (chunk, tap) weight tiles

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, kThreads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 streams the weights: the tile of (chunk, tap) iteration i goes
  // into stage i % kStages once every warp has released the stage's last
  // use. It fills the ring here, then runs kStages - 2 iterations ahead.
  auto produce = [&](int i) {
    if (i >= n_iter) return;
    const int s = i % kStages;
    mbar_wait(empty_s + 8 * s, ((i / kStages) & 1) ^ 1);
    mbar_expect_tx(full_s + 8 * s, kStageBytes);
    tma_load_2d(ring_s + s * kStageBytes, &wmap, full_s + 8 * s,
                (i / 9) * kChunk, (i % 9) * C + n0);
  };
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) produce(i);

  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.res);
  const long long total_px = (long long)a.B * hw;
  const long long p0 = (long long)blockIdx.x * BM;
  const int b0 = (int)(p0 / hw);
  const int h0 = (int)((p0 % hw) / W);
  const int wg = warp >> 2, wq = warp & 3;
  const int wg_m = kWgM == 2 ? wg : 0;  // this warpgroup's 64-pixel half
  const int wg_n = kWgM == 2 ? 0 : wg;  // ... or its channel half
  const bool write_z = a.emit_z && blockIdx.y == 0;

  // ldmatrix row address of this lane at tap (0, 0): pixel row
  // (lane & 15) of the warp's 16, k half (lane >> 4).
  uint32_t a_base;
  {
    const int lp = wg_m * 64 + wq * 16 + (lane & 15);
    const int tile_px = rows * W;
    const int slot = lp / tile_px, rem = lp % tile_px;
    const int hidx = (slot * (rows + 2) + rem / W) * (W + 2) + rem % W;
    a_base = smem_u32(zs) + hidx * (kRow * 2) + (lane >> 4) * 16;
  }
  const uint32_t b_off = wg_n * kNw * 128;  // this warpgroup's c_out rows

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int c0 = 0, it_base = 0; c0 < C; c0 += kChunk, it_base += 9) {
    if (c0 > 0) __syncthreads();  // the last chunk's ldmatrix reads are done
    // 1. z tile with halo, 8 channels per item, kUnroll items in flight
    // (as many as the tile's register budget allows).
    constexpr int kUnroll = min_blocks(BM, BN) == 2 ? 2 : 4;
    const int items = zs_px * (kChunk / 8);
    for (int i0 = tid; i0 < items; i0 += kUnroll * kThreads) {
      float v[kUnroll][8], r8[kUnroll][8];
      long long off[kUnroll];
      bool in_img[kUnroll], inner[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int it = i0 + u * kThreads;
        const int cg = it % (kChunk / 8), px = it / (kChunk / 8);
        const int cc = px % (W + 2);
        const int rr = (px / (W + 2)) % (rows + 2);
        const int b = b0 + px / ((W + 2) * (rows + 2));
        const int h = h0 + rr - 1, w = cc - 1;
        in_img[u] = it < items && b < a.B && h >= 0 && h < H && w >= 0 &&
                    w < W;
        inner[u] = rr >= 1 && rr <= rows && cc >= 1 && cc <= W;
        off[u] = (((long long)b * H + h) * W + w) * C + c0 + cg * 8;
        if (in_img[u]) {
          Vec8<T>::load(x + off[u], v[u]);
          if (a.has_res) Vec8<T>::load(res + off[u], r8[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int it = i0 + u * kThreads;
        if (it >= items) continue;
        const int cg = it % (kChunk / 8);
        __align__(16) __nv_bfloat16 q8[8];
        if (in_img[u]) {
          const float* sc = a.scale + c0 + cg * 8;
          const float* sh = a.shift + c0 + cg * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            // Unfused multiply then add, as the plain version computes it.
            float t = __fadd_rn(__fmul_rn(v[u][i], __ldg(sc + i)),
                                __ldg(sh + i));
            if (a.has_res) t = __fadd_rn(t, r8[u][i]);
            if (a.activate) t = fmaxf(t, 0.f);
            q8[i] = __float2bfloat16_rn(t);
          }
          // Interior pixels are this block's own outputs: exactly one
          // block (channel block 0) writes each pixel's z.
          if (write_z && inner[u]) Vec8<T>::store(
              static_cast<T*>(a.z) + off[u], q8);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) q8[i] = __float2bfloat16_rn(0.f);
        }
        *reinterpret_cast<uint4*>(zs + (it / (kChunk / 8)) * kRow + cg * 8) =
            *reinterpret_cast<const uint4*>(q8);
      }
    }
    __syncthreads();
    // 2. 9 taps x 4 k16 steps, in 18 groups of two k16 steps: gather a
    // group's A fragments, issue its wgmmas, and gather the next group's
    // while they run (wgmma.wait_group 1). Two-step groups keep 16
    // registers of A in flight, not 32.
    uint32_t af[2][2][4];
    int prev_s = 0;
#pragma unroll
    for (int g = 0; g < 18; ++g) {
      const int tap = g >> 1, half = g & 1;
      const int i = it_base + tap;
      const int s = i % kStages;
      if (half == 0) {
        // Iteration i - 2's stage was released by every warp at i - 1.
        if (tid == 0 && i >= 2) produce(i + kStages - 2);
        mbar_wait(full_s + 8 * s, (i / kStages) & 1);
        __syncwarp();  // converged for the .aligned instructions below
      }
      const uint32_t a_grp = a_base +
                             ((tap / 3) * (W + 2) + tap % 3) * (kRow * 2) +
                             half * 64;
#pragma unroll
      for (int k = 0; k < 2; ++k) ldmatrix_x4(af[g & 1][k], a_grp + k * 32);
      const uint64_t desc =
          sw128_desc(ring_s + s * kStageBytes + b_off) + half * 4;
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        Wgmma<kNw>::mma(acc, af[g & 1][k], desc + 2 * k);
      wgmma_commit();
      fence_acc(acc);
      if (g > 0) {
        wgmma_wait<1>();  // group g - 1 is done
        // ... and with it the previous tap: release its stage.
        if (half == 0 && lane == 0) mbar_arrive(empty_s + 8 * prev_s);
      }
      prev_s = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty_s + 8 * prev_s);
  }

  // Epilogue: round y to bf16, store as T; with stats, first sum the
  // rounded values per channel (pixels past the batch end are masked out:
  // at 4x4 a tile holds several image slots, and the last tile's may be
  // empty), write the block's partial row and draw the block's ticket --
  // before y is stored, so the release fence waits on the row alone and
  // the ticket's round trip overlaps the stores of y.
  // Accumulator i of a thread: row 16*wq + g + 8*((i >> 1) & 1) of its
  // warpgroup's 64, column 8*(i >> 2) + 2*q + (i & 1) of its kNw.
  static_assert(2 * BN <= kThreads, "one thread per stats column");
  const int g = lane >> 2, q = lane & 3;
  const int m = tid / BN, col = tid % BN;  // column (m, n0 + col) if tid < 2*BN
  const long long row_len = 2LL * C;
  const int nbx = gridDim.x, G = max(a.group, 1);  // group: stats only
  const int n_groups = (nbx + G - 1) / G;
  const int grp = blockIdx.x / G, first = grp * G;
  const int g_rows = min(G, nbx - first);
  int* tick = a.tickets + blockIdx.y * (n_groups + 1);
  int ticket = 0;
  if (a.stats_on) {
#pragma unroll
    for (int j = 0; j < kNw / 8; ++j) {
      float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const long long p = p0 + wg_m * 64 + wq * 16 + g + 8 * hi;
        if (p < total_px) {
          const float fa = __bfloat162float(
              __float2bfloat16_rn(acc[4 * j + 2 * hi]));
          const float fb = __bfloat162float(
              __float2bfloat16_rn(acc[4 * j + 2 * hi + 1]));
          s1a += fa;
          s1b += fb;
          s2a += fa * fa;
          s2b += fb * fb;
        }
      }
      // Lanes g = 0..7 of one q hold the same 2 channels: a fixed xor tree.
#pragma unroll
      for (int k = 4; k < 32; k <<= 1) {
        s1a += __shfl_xor_sync(0xffffffffu, s1a, k);
        s1b += __shfl_xor_sync(0xffffffffu, s1b, k);
        s2a += __shfl_xor_sync(0xffffffffu, s2a, k);
        s2b += __shfl_xor_sync(0xffffffffu, s2b, k);
      }
      if (g == 0) {
        float* r = red + (wg_m * 4 + wq) * 2 * BN + wg_n * kNw + 8 * j + 2 * q;
        r[0] = s1a;
        r[1] = s1b;
        r[BN] = s2a;
        r[BN + 1] = s2b;
      }
    }
    // The warps' rows in a fixed order: this block's partial row.
    __syncthreads();
    if (tid < 2 * BN) {
      float t = 0.f;
#pragma unroll
      for (int rg = 0; rg < kRowGroups; ++rg)
        t += red[(rg * 2 + m) * BN + col];
      a.partials[blockIdx.x * row_len + m * C + n0 + col] = t;
    }
    ticket = tpu_dp::draw_ticket(tick + grp);
  }
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int j = 0; j < kNw / 8; ++j) {
    const int cy = wg_n * kNw + 8 * j + 2 * q;  // in [0, BN)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long p = p0 + wg_m * 64 + wq * 16 + g + 8 * hi;
      if (p < total_px)
        store_pair(y + p * C + n0 + cy,
                   __float2bfloat16_rn(acc[4 * j + 2 * hi]),
                   __float2bfloat16_rn(acc[4 * j + 2 * hi + 1]));
    }
  }
  if (!a.stats_on) return;
  // Level 1: the last block of this group sums the group's rows in order.
  if (!tpu_dp::drew_last(ticket, g_rows)) return;
  float* group_rows = a.partials + nbx * row_len;
  if (tid < 2 * BN) {
    const float t = tpu_dp::ordered_sum(
        a.partials + first * row_len + m * C + n0 + col, row_len, g_rows);
    if (n_groups == 1)
      a.stats[m * C + n0 + col] = t;
    else
      group_rows[grp * row_len + m * C + n0 + col] = t;
  }
  if (tid == 0) tpu_dp::reset_counter(tick + grp);
  if (n_groups == 1) return;
  // Level 2: the last group-finisher of this column sums the group rows.
  if (!tpu_dp::drew_last(tpu_dp::draw_ticket(tick + n_groups), n_groups))
    return;
  if (tid < 2 * BN)
    a.stats[m * C + n0 + col] = tpu_dp::ordered_sum(
        group_rows + m * C + n0 + col, row_len, n_groups);
  if (tid == 0) tpu_dp::reset_counter(tick + n_groups);
}

// ---- host side ----

struct Tile {
  int bm, bn;
};
constexpr Tile kTiles[] = {{128, 128}, {128, 64}, {64, 64}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// Image rows per tile, or 0 if a BM-pixel tile does not cover whole rows of
// one image or whole images.
int tile_rows(int H, int W, int bm) {
  const int hw = H * W;
  if (hw >= bm) return (bm % W == 0 && H % (bm / W) == 0) ? bm / W : 0;
  return bm % hw == 0 ? H : 0;
}

size_t tile_smem(int H, int W, const Tile& t) {
  const int rows = tile_rows(H, W, t.bm);
  const int zs_px = t.bm / (rows * W) * (rows + 2) * (W + 2);
  const int stages = ring_stages(t.bn);
  return 1024 + (size_t)stages * t.bn * 128 + (size_t)zs_px * kRow * 2 +
         (size_t)4 * (t.bm / 64) * 2 * t.bn * 4 + 2 * stages * 8;
}

// The tile a launch uses (index into kTiles), or -1 if none takes the shape.
int pick_tile(int B, int H, int W, int C) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kChunk != 0) return -1;
  const long long px = (long long)B * H * W;
  int best = -1;
  long long best_blocks = -1;
  for (int i = 0; i < kNumTiles; ++i) {
    const Tile& t = kTiles[i];
    if (C % t.bn != 0 || tile_rows(H, W, t.bm) == 0 ||
        tile_smem(H, W, t) > (size_t)kMaxSmem)
      continue;
    const long long blocks = (px + t.bm - 1) / t.bm * (C / t.bn);
    // A full wave: about 132 SMs times the blocks each SM holds.
    if (blocks >= (long long)kFillBlocks * min_blocks(t.bm, t.bn)) return i;
    if (blocks > best_blocks) best = i, best_blocks = blocks;
  }
  return best;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

std::mutex g_mutex;  // guards the caches below

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda at build time; the driver is already loaded by the runtime).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The weight's tensor map for box [bn rows][64 c_in], cached per (pointer,
// C, bn): it encodes only the address and shape. 0 or -3 if it cannot be
// made.
int weight_map(const void* wk, int C, int bn, CUtensorMap* out) {
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(g_mutex);
  const auto key = std::make_tuple(wk, C, bn);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wk),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -3;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return 0;
}

template <typename T, int BM, int BN>
int launch_tile(const CUtensorMap& map, const Args& a, size_t smem,
                cudaStream_t stream) {
  auto kern = conv_block_kernel<T, BM, BN>;
  // The dynamic shared-memory limit, set once per instance and device.
  static bool set_for[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -2;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!set_for[dev]) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      set_for[dev] = true;
    }
  }
  const long long px = (long long)a.B * a.H * a.W;
  dim3 grid((unsigned)((px + BM - 1) / BM), a.C / BN);
  kern<<<grid, kThreads, smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int tile, const CUtensorMap& map, const Args& a, size_t smem,
             cudaStream_t s) {
  switch (tile) {
    case 0: return launch_tile<T, 128, 128>(map, a, smem, s);
    case 1: return launch_tile<T, 128, 64>(map, a, smem, s);
    case 2: return launch_tile<T, 64, 64>(map, a, smem, s);
  }
  return -1;
}

bool shape_taken(int B, int H, int W, int C) {
  if (C % 64 != 0 || W <= 0 || 64 % W != 0 || H <= 0 || B <= 0) return false;
  const int hw = H * W;
  if (!(hw % 64 == 0 && H % (64 / W) == 0) && 64 % hw != 0) return false;
  return pick_tile(B, H, W, C) >= 0;
}

// Rows of the stats fold: level-1 groups of a launch with `nbx` blocks
// along x (1: no group rows, the group-finisher writes stats).
int stats_groups(long long nbx, int group) {
  return (int)((nbx + group - 1) / group);
}

}  // namespace

// Shapes the kernel takes: C % 64 == 0; W divides 64; and either H*W is a
// multiple of 64 (then 64/W divides H) or H*W divides 64. The Python wrapper
// checks these and raises before calling. With `stats` set: `partials` is
// f32 scratch of `scratch_rows` rows of [2][C] (the blocks' rows, then the
// group rows: at least gridDim.x + groups when groups > 1, where groups =
// ceil(gridDim.x / group)); `stats` is [2][C] f32; `tickets` is int32,
// `n_tickets` long (at least (C / BN) * (groups + 1)), zero, and left zero.
// Returns 0 or a CUDA error code (-1 for a flag combination that does not
// exist, -2 for a refused shape, -3 if the weight's tensor map cannot be
// made, -4 for scratch or tickets too small for the launch).
extern "C" int tpu_dp_conv_block(int dtype, int has_res, int emit_z,
                                 int activate, int stats, const void* x,
                                 const void* wk, const float* scale,
                                 const float* shift, const void* res, void* y,
                                 void* z, float* partials, float* stats_out,
                                 int* tickets, int B, int H, int W, int C,
                                 int scratch_rows, int n_tickets, int group,
                                 void* stream) {
  if (!shape_taken(B, H, W, C)) return -2;
  if ((stats && (partials == nullptr || stats_out == nullptr ||
                 tickets == nullptr || group <= 0)) ||
      (emit_z && z == nullptr) || (has_res && res == nullptr) ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int tile = pick_tile(B, H, W, C);
  const Tile& t = kTiles[tile];
  if (stats) {
    const long long nbx = ((long long)B * H * W + t.bm - 1) / t.bm;
    const int groups = stats_groups(nbx, group);
    if (nbx + (groups > 1 ? groups : 0) > scratch_rows ||
        (long long)(C / t.bn) * (groups + 1) > n_tickets)
      return -4;
  }
  CUtensorMap map;
  const int rc = weight_map(wk, C, t.bn, &map);
  if (rc != 0) return rc;
  const Args a{x, scale, shift, res, y, z, partials, stats_out, tickets,
               B, H, W, C, tile_rows(H, W, t.bm), has_res != 0,
               emit_z != 0, activate != 0, stats != 0, group};
  const size_t smem = tile_smem(H, W, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(tile, map, a, smem, s)
                    : dispatch<__nv_bfloat16>(tile, map, a, smem, s);
}

// The tile of this shape's launch: out[0] = BM (pixels), out[1] = BN
// (output channels), out[2] = blocks. Returns 0, or -2 for a refused shape.
extern "C" int tpu_dp_conv_block_tile(int B, int H, int W, int C, int* out) {
  if (!shape_taken(B, H, W, C)) return -2;
  const Tile& t = kTiles[pick_tile(B, H, W, C)];
  out[0] = t.bm;
  out[1] = t.bn;
  out[2] = (int)(((long long)B * H * W + t.bm - 1) / t.bm * (C / t.bn));
  return 0;
}
