// K8: one frozen stride-1 ResNet bottleneck in one launch, any width.
//
// Replaces kgdet_tpu/ops/pallas_resblock.py::fused_bottleneck (kernel
// _kernel): relu(conv1x1 -> relu -> conv3x3 pad 1 -> relu -> conv1x1
// + identity or 1x1 downsample) on an NHWC map, FrozenBatchNorm folded into
// weights and f32 biases. It is the per-block route of a frozen layer1; K5
// (stem_layer1.cu) is the same function fixed to width 64 inside the
// whole-prefix chain.
//
// The TPU kernel keeps conv1's output for whole image rows in VMEM. Whole
// rows do not fit a block's shared memory beside the staging tiles, so the
// image is cut into pixel tiles: a block computes conv1 over its tile and a
// one-pixel halo, keeps that and conv2's output in shared memory, and
// writes only the block output. What carries over from the TPU kernel is
// the border rule: conv2 zero-pads conv1's OUTPUT, so a halo pixel outside
// the image is 0, not relu(b1).
//
// What bounds it on the H100: each block of layer1 moves its input and its
// 256-channel output through device memory once (bytes, 0.108 ms for
// layer1's three at batch 2, 800x1344) against about 70 kMAC a pixel.
//
// Two bodies, chosen in kgdet_fused_bottleneck by dtype and shape alone:
// - bf16 with Cin, width and Cout multiples of 8, 16-byte aligned operands
//   and a width whose tiles fit (up to 448): the tensor-core body of
//   prefix_mma.cuh, implicit GEMMs on mma.sync with bf16 operands and f32
//   sums (prefix_index.h::blk_tile): K5's 16x16 instance at width 64 with
//   Cout a multiple of 64, where the two agree bit for bit; 8x16 tiles for
//   other widths to 192 and 8x8 above. Every shape of the per-block route
//   (width 64, Cin 64 or 256, Cout 256) takes K5's instance.
// - f32 (TF32 would break the 1e-5 hold against the plain version) and the
//   bf16 shapes the first does not take: the register-tiled f32 FMA body
//   below (bottleneck_tiles.cuh) on 8x8 tiles. Its two activation tiles
//   take 4 * ceil32(width) * (100 + 64) bytes of shared memory (up to width
//   320). Ragged edges (H, W off the tile, channels off the 64-wide product
//   tile or the 32-deep reduction chunk) are masked here.
// kgdet_fused_bottleneck_smem gives what the chosen body asks for, which the
// wrapper checks against the card's 227 KB before it launches.
//
// Numerics follow the TPU kernel: inputs and weights in the working dtype
// T, products accumulated in f32, bias added in f32, conv1's and conv2's
// activations rounded to T.
#include <stdint.h>

#include "bottleneck_tiles.cuh"
#include "prefix_mma.cuh"

namespace kgdet {
namespace {

__host__ __device__ inline int ceil32(int n) { return (n + 31) / 32 * 32; }

inline size_t smem_bytes(int width) {
  return sizeof(float) *
         ((size_t)ceil32(width) * (kHaloPix + 64) + 2 * kKC * kLd);
}

// Three blocks an SM: held to 80 registers a thread (as K5 compiles to) the
// kernel spills 44 bytes and runs 15% faster than at the 128 registers and
// two blocks the compiler would otherwise take for the runtime-width loops.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
resblock_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const float* __restrict__ b1, const T* __restrict__ w2,
                const float* __restrict__ b2, const T* __restrict__ w3,
                const float* __restrict__ b3, const T* __restrict__ wd,
                const float* __restrict__ bd, T* __restrict__ out, int H,
                int W, int Cin, int Wd, int Cout) {
  extern __shared__ __align__(16) float smem[];
  const int Wp = ceil32(Wd);               // rows Wd..Wp-1 are kept zero
  float* a1 = smem;                        // conv1 out, [ch][halo pixel]
  float* a2 = a1 + Wp * kHaloPix;          // conv2 out, [ch][pixel]
  float* sa = a2 + Wp * 64;                // A staging, [k][m]
  float* sb = sa + kKC * kLd;              // B staging, [k][n]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int w0 = blockIdx.x * kBT;
  const int h0 = blockIdx.y * kBT;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cin;
  float acc[4][4];

  // conv1 over the halo tile: pixels 0..99 in two passes of 64, channels in
  // tiles of 64
  for (int pass = 0; pass < 2; ++pass) {
    const int m0 = pass * 64;
    auto pix = [&](int m, int& gy, int& gx) {
      const int hp = m0 + m;
      if (hp >= kHaloPix) {
        gy = gx = -1;
        return;
      }
      gy = h0 - 1 + hp / kHalo;
      gx = w0 - 1 + hp % kHalo;
    };
    for (int n0 = 0; n0 < Wp; n0 += 64) {
      zero_acc(acc);
      for (int c0 = 0; c0 < Cin; c0 += kKC) {
        stage_x(xb, H, W, Cin, c0, sa, pix);
        stage_w(w1, Cin, Wd, Wd, c0, n0, sb);
        __syncthreads();
        mma_chunk(sa, kLd, sb, kLd, ty, tx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hp = m0 + ty * 4 + i;
        if (hp >= kHaloPix) continue;
        const int gy = h0 - 1 + hp / kHalo;
        const int gx = w0 - 1 + hp % kHalo;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = n0 + tx * 4 + j;
          if (ch >= Wp) continue;
          // the 3x3 conv zero-pads conv1's output at the image border
          a1[ch * kHaloPix + hp] =
              (inside && ch < Wd)
                  ? round_to<T>(fmaxf(acc[i][j] + b1[ch], 0.f))
                  : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // conv2: 9 shifted products over the halo tile
  for (int n0 = 0; n0 < Wp; n0 += 64) {
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int c0 = 0; c0 < Wp; c0 += kKC) {
        // A[k][m] = a1[c0+k][halo pixel of (m + tap shift)]
        {
          const int k = tid % kKC;
          for (int m = tid / kKC; m < 64; m += kThreads / kKC) {
            const int hp = (m / kBT + dy) * kHalo + (m % kBT + dx);
            sa[k * kLd + m] = a1[(c0 + k) * kHaloPix + hp];
          }
        }
        stage_w(w2 + (size_t)tap * Wd * Wd, Wd, Wd, Wd, c0, n0, sb);
        __syncthreads();
        mma_chunk(sa, kLd, sb, kLd, ty, tx, acc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = n0 + tx * 4 + j;
        if (ch >= Wp) continue;
        a2[ch * 64 + ty * 4 + i] =
            ch < Wd ? round_to<T>(fmaxf(acc[i][j] + b2[ch], 0.f)) : 0.f;
      }
  }
  __syncthreads();

  // conv3 + identity / downsample, 64 output channels at a time
  auto center = [&](int m, int& gy, int& gx) {
    gy = h0 + m / kBT;
    gx = w0 + m % kBT;
  };
  const bool has_ds = wd != nullptr;
  for (int n0 = 0; n0 < Cout; n0 += 64) {
    zero_acc(acc);
    for (int c0 = 0; c0 < Wp; c0 += kKC) {
      stage_w(w3, Wd, Cout, Cout, c0, n0, sb);
      __syncthreads();
      mma_chunk(a2 + c0 * 64, 64, sb, kLd, ty, tx, acc);
      __syncthreads();
    }
    float dacc[4][4];
    zero_acc(dacc);
    if (has_ds) {
      for (int c0 = 0; c0 < Cin; c0 += kKC) {
        stage_x(xb, H, W, Cin, c0, sa, center);
        stage_w(wd, Cin, Cout, Cout, c0, n0, sb);
        __syncthreads();
        mma_chunk(sa, kLd, sb, kLd, ty, tx, dacc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const int gy = h0 + m / kBT;
      const int gx = w0 + m % kBT;
      if (gy >= H || gx >= W) continue;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n >= Cout) continue;
        const float ident = has_ds ? dacc[i][j] + bd[n]
                                   : to_f32(x[pix * Cin + n]);
        out[pix * Cout + n] =
            from_f32<T>(fmaxf((acc[i][j] + b3[n]) + ident, 0.f));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, int B, int H, int W, int Cin, int Wd,
           int Cout, cudaStream_t stream) {
  const size_t smem = smem_bytes(Wd);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + kBT - 1) / kBT, (H + kBT - 1) / kBT, B);
  resblock_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), H, W, Cin, Wd,
      Cout);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the tensor-core body's tile for these bf16 operands, or -1 (the FMA body)
int mma_tile(const void* x, const void* w1, const void* w2, const void* w3,
             const void* wd, const void* out, int Cin, int width, int Cout) {
  const bool ok = Cin % 8 == 0 && width % 8 == 0 && Cout % 8 == 0 &&
                  aligned16(x) && aligned16(w1) && aligned16(w2) &&
                  aligned16(w3) && aligned16(out) &&
                  (wd == nullptr || aligned16(wd));
  return ok ? blk_tile(width, Cout) : -1;
}

int launch_mma(int tile, const void* x, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3,
               const void* b3, const void* wd, const void* bd, void* out,
               int B, int H, int W, int Cin, int width, int Cout,
               cudaStream_t stream) {
  switch (tile) {
    case 0:
      return prefix::launch_bottleneck<16, 16>(x, w1, b1, w2, b2, w3, b3, wd,
                                               bd, out, B, H, W, Cin, width,
                                               Cout, stream);
    case 1:
      return prefix::launch_bottleneck<8, 16>(x, w1, b1, w2, b2, w3, b3, wd,
                                              bd, out, B, H, W, Cin, width,
                                              Cout, stream);
    default:
      return prefix::launch_bottleneck<8, 8>(x, w1, b1, w2, b2, w3, b3, wd,
                                             bd, out, B, H, W, Cin, width,
                                             Cout, stream);
  }
}

}  // namespace
}  // namespace kgdet

// x (B, H, W, Cin) T; w1 (Cin, width), w2 (9, width, width) [tap][ci][co],
// w3 (width, Cout), wd (Cin, Cout) or null (then Cin == Cout), all T;
// biases f32; out (B, H, W, Cout) T. The body as the header says: the
// tensor-core one for bf16 where kgdet::mma_tile finds a tile, else FMA.
// Returns a cudaError_t code.
extern "C" int kgdet_fused_bottleneck(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* w3,
                                      const void* b3, const void* wd,
                                      const void* bd, void* out, int B, int H,
                                      int W, int Cin, int width, int Cout,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return kgdet::launch<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H,
                                W, Cin, width, Cout, s);
  if (dtype != kgdet::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = kgdet::mma_tile(x, w1, w2, w3, wd, out, Cin, width, Cout);
  if (tile >= 0)
    return kgdet::launch_mma(tile, x, w1, b1, w2, b2, w3, b3, wd, bd, out, B,
                             H, W, Cin, width, Cout, s);
  return kgdet::launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                                      B, H, W, Cin, width, Cout, s);
}

// Dynamic shared memory, in bytes, that a launch at this width and dtype
// asks for (at a Cout that is a multiple of 64; the other tile a width may
// take fits too): the tensor-core body's where a bf16 tile fits, else the
// FMA body's. Neither fits above width 448 in bf16 and 320 in f32.
extern "C" int kgdet_fused_bottleneck_smem(int width, int dtype) {
  const int tile = width % 8 ? -1 : kgdet::blk_tile(width, 64);
  if (dtype == kgdet::kBF16 && tile >= 0)
    return kgdet::blk_tile_smem(tile, width);
  return static_cast<int>(kgdet::smem_bytes(width));
}
