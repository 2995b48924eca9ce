// Fused affine + residual + ReLU + 3x3 stride-1 conv, hand-written for Hopper
// (sm_90a). Built by tpu_dp_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (tpu_dp_torch/ops/conv_block.py).
//
// Replaces the TPU kernel `_conv_kernel` in tpu_dp/ops/conv_block.py
// (launched through pl.pallas_call by `_run_local`), eval variants only:
//
//   z = act(x * scale + shift [+ residual])      f32, rounded to bf16
//   y = conv3x3_SAME(z, W)                        bf16 operands, f32 accumulator
//   y is rounded to bf16 and stored as x's dtype; `emit_z` also stores z
//   (the bf16-rounded value, as x's dtype).
//
// What computes the same thing, not how: the TPU kernel packs the conv as one
// [rows,3C]x[3C,3C] MXU matmul realigned with pltpu.roll to fill the MXU. Here
// it is an implicit GEMM on the tensor cores through mma.sync m16n8k16
// (bf16 in, f32 accumulate): M = output pixels, N = output channels,
// K = 9 taps x C input channels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): a ResNet-18 call at
// B=32 is 2*B*H*W*9*C*C = 2.42 GFLOP at every stage (the channel count
// doubles as the area quarters), i.e. >= 2.4 us of tensor-core time. Stage 0
// (32x32x64) moves x, y (+z, +residual) at 8.4 MB each in f32, 17-34 MB:
// 5-10 us at 3.35 TB/s, so at ~70-140 flop/byte it is under the ~295
// flop/byte ridge and memory-bound; the later stages move less and approach
// the ridge. The design therefore keeps z out of device memory (it is made in
// shared memory from x, and written out only when `emit_z` asks for it, by
// exactly one block per pixel) and reads x, residual and y once.
//
// Block: 128 threads (4 warps, 2x2 over a 64-pixel x 64-channel output tile).
// The 64 pixels are consecutive in flattened (b, h, w) order, so a block
// covers 64/W whole rows of one image or, when H*W < 64, whole images. For
// each 64-channel chunk of the input the block
//   1. builds the z tile with its 1-pixel halo in shared memory (affine,
//      residual and ReLU in f32, rounded to bf16; halo pixels outside the
//      image are 0, i.e. the SAME padding applies to z after the activation);
//   2. stages the chunk's weights [tap][co][ci] in shared memory;
//   3. runs 9 taps x 4 k16-steps of mma.sync per warp.
// Rows are padded to 72 bf16 (144 bytes) so the fragment loads of the eight
// row groups of a warp land on distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileM = 64;   // output pixels per block
constexpr int kTileN = 64;   // output channels per block
constexpr int kChunk = 64;   // input channels per shared-memory chunk
constexpr int kStride = kChunk + 8;  // padded row, in bf16 elements

template <typename T> struct Vec8;

template <> struct Vec8<float> {
  __device__ static void load(const float* p, float v[8]) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
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
    uint4 raw = *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x, res, y, z: [B,H,W,C] of T, NHWC contiguous. wk: [9][C][C] bf16 as
// [tap][c_out][c_in]. scale, shift: [C] f32.
template <typename T, bool kRes, bool kEmitZ, bool kAct>
__global__ void __launch_bounds__(kThreads)
conv_block_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, const T* __restrict__ res,
                  T* __restrict__ y, T* __restrict__ z, int B, int H, int W,
                  int C, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int hw = H * W;
  const int tile_px = rows * W;               // min(H*W, 64)
  const int n_img = kTileM / tile_px;          // images in the tile (>= 1)
  const int zs_px = n_img * (rows + 2) * (W + 2);
  __nv_bfloat16* ws = zs + zs_px * kStride;

  const long long total_px = (long long)B * hw;
  const long long p0 = (long long)blockIdx.x * kTileM;
  const int b0 = (int)(p0 / hw);
  const int h0 = (int)((p0 % hw) / W);
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  // Shared-memory offsets of this thread's four A rows (2 m-tiles x rows
  // g and g+8), at tap (0, 0).
  int rowoff[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int lp = wm * 32 + mt * 16 + g + hi * 8;
      const int slot = lp / tile_px;
      const int rem = lp - slot * tile_px;
      const int r = rem / W, col = rem - (rem / W) * W;
      rowoff[mt][hi] = ((slot * (rows + 2) + r) * (W + 2) + col) * kStride;
    }
  }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const bool write_z = kEmitZ && blockIdx.y == 0;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's mma reads are done
    // 1. z tile with halo: 8 channels per item.
    const int items = zs_px * (kChunk / 8);
    for (int it = tid; it < items; it += kThreads) {
      const int cg = it % (kChunk / 8);
      const int px = it / (kChunk / 8);
      const int cc = px % (W + 2);
      const int rr = (px / (W + 2)) % (rows + 2);
      const int slot = px / ((W + 2) * (rows + 2));
      const int b = b0 + slot;
      const int h = h0 + rr - 1, w = cc - 1;
      __align__(16) __nv_bfloat16 q8[8];
      if (b < B && h >= 0 && h < H && w >= 0 && w < W) {
        const long long off =
            (((long long)b * H + h) * W + w) * C + c0 + cg * 8;
        float v[8];
        Vec8<T>::load(x + off, v);
        float r8[8];
        if (kRes) Vec8<T>::load(res + off, r8);
        const float* sc = scale + c0 + cg * 8;
        const float* sh = shift + c0 + cg * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // Unfused multiply then add, as the plain version computes it.
          float t = __fadd_rn(__fmul_rn(v[i], __ldg(sc + i)), __ldg(sh + i));
          if (kRes) t = __fadd_rn(t, r8[i]);
          if (kAct) t = fmaxf(t, 0.f);
          q8[i] = __float2bfloat16_rn(t);
        }
        // Interior pixels are this block's own outputs: exactly one block
        // (the channel block 0) writes each pixel's z.
        if (write_z && rr >= 1 && rr <= rows && cc >= 1 && cc <= W)
          Vec8<T>::store(z + off, q8);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) q8[i] = __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(zs + px * kStride + cg * 8) =
          *reinterpret_cast<const uint4*>(q8);
    }
    // 2. weights of this chunk: [tap][co - n0][ci - c0].
    const int witems = 9 * kTileN * (kChunk / 8);
    for (int it = tid; it < witems; it += kThreads) {
      const int cg = it % (kChunk / 8);
      const int row = it / (kChunk / 8);  // tap * kTileN + co_local
      const int tap = row / kTileN, co = row % kTileN;
      const long long off = ((long long)tap * C + n0 + co) * C + c0 + cg * 8;
      *reinterpret_cast<uint4*>(ws + row * kStride + cg * 8) =
          *reinterpret_cast<const uint4*>(wk + off);
    }
    __syncthreads();
    // 3. 9 taps x (kChunk / 16) k-steps of mma.
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      const int toff = (dh * (W + 2) + dw) * kStride;
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r0 = zs + rowoff[mt][0] + toff + ks + 2 * q;
          const __nv_bfloat16* r1 = zs + rowoff[mt][1] + toff + ks + 2 * q;
          a[mt][0] = lds32(r0);
          a[mt][1] = lds32(r1);
          a[mt][2] = lds32(r0 + 8);
          a[mt][3] = lds32(r1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* br =
              ws + (tap * kTileN + wn * 32 + nt * 8 + g) * kStride + ks + 2 * q;
          uint32_t bf[2] = {lds32(br), lds32(br + 8)};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], bf);
        }
      }
    }
  }

  // Epilogue: round y to bf16, store as T.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long p = p0 + wm * 32 + mt * 16 + g + hi * 8;
      if (p >= total_px) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = n0 + wn * 32 + nt * 8 + 2 * q;
        store_pair(y + p * C + co,
                   __float2bfloat16_rn(acc[mt][nt][hi * 2]),
                   __float2bfloat16_rn(acc[mt][nt][hi * 2 + 1]));
      }
    }
  }
}

template <typename T, bool kRes, bool kEmitZ, bool kAct>
int launch_one(const void* x, const void* wk, const float* scale,
               const float* shift, const void* res, void* y, void* z, int B,
               int H, int W, int C, cudaStream_t stream) {
  const int rows = (H * W >= kTileM) ? kTileM / W : H;
  const int n_img = kTileM / (rows * W);
  const size_t smem =
      (size_t)(n_img * (rows + 2) * (W + 2) + 9 * kTileN) * kStride *
      sizeof(__nv_bfloat16);
  auto kern = conv_block_kernel<T, kRes, kEmitZ, kAct>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total_px = (long long)B * H * W;
  dim3 grid((unsigned)((total_px + kTileM - 1) / kTileM), C / kTileN);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(wk), scale,
      shift, static_cast<const T*>(res), static_cast<T*>(y),
      static_cast<T*>(z), B, H, W, C, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int has_res, int emit_z, int activate, const void* x,
             const void* wk, const float* scale, const float* shift,
             const void* res, void* y, void* z, int B, int H, int W, int C,
             cudaStream_t s) {
#define TPU_DP_CONV_CASE(R, E, A)                                           \
  if (has_res == R && emit_z == E && activate == A)                         \
    return launch_one<T, R, E, A>(x, wk, scale, shift, res, y, z, B, H, W,  \
                                  C, s);
  TPU_DP_CONV_CASE(0, 0, 0) TPU_DP_CONV_CASE(0, 0, 1)
  TPU_DP_CONV_CASE(0, 1, 0) TPU_DP_CONV_CASE(0, 1, 1)
  TPU_DP_CONV_CASE(1, 0, 0) TPU_DP_CONV_CASE(1, 0, 1)
  TPU_DP_CONV_CASE(1, 1, 0) TPU_DP_CONV_CASE(1, 1, 1)
#undef TPU_DP_CONV_CASE
  return -1;
}

}  // namespace

// Shapes the kernel takes: C % 64 == 0; W divides 64; and either H*W is a
// multiple of 64 (then 64/W divides H) or H*W divides 64. The Python wrapper
// checks these and raises before calling. Returns 0 or a CUDA error code
// (-1 for a flag combination that does not exist, -2 for a refused shape).
extern "C" int tpu_dp_conv_block(int dtype, int has_res, int emit_z,
                                 int activate, const void* x, const void* wk,
                                 const float* scale, const float* shift,
                                 const void* res, void* y, void* z, int B,
                                 int H, int W, int C, void* stream) {
  if (C % kTileN != 0 || W <= 0 || kTileM % W != 0) return -2;
  const int hw = H * W;
  if (!(hw % kTileM == 0 && H % (kTileM / W) == 0) && kTileM % hw != 0)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(has_res, emit_z, activate, x, wk, scale, shift,
                           res, y, z, B, H, W, C, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(has_res, emit_z, activate, x, wk, scale,
                                   shift, res, y, z, B, H, W, C, s);
  return -1;
}
