// K4 and K5: the frozen ResNet prefix (stem conv -> maxpool -> layer1).
//
// K4 stem_pool replaces kgdet_tpu/ops/pallas_stem.py::_stem_kernel: the
// 7x7/2 stem conv (pad 3) with FrozenBatchNorm folded into weight and bias,
// ReLU, and the 3x3/2 maxpool (pad 1), fused so the full-resolution stem map
// (B, H/2, W/2, 64) never reaches device memory.
//
// K5 frozen_bottleneck replaces pallas_stem.py::_block_kernel: one frozen
// stride-1 bottleneck relu(conv1x1 -> relu -> conv3x3 -> relu -> conv1x1
// + identity-or-downsample), BN folded, with the conv1 and conv2
// activations (conv1 with its one-pixel halo for the 3x3) kept in shared
// memory. Only the block input and output cross device memory.
//
// What bounds them on the H100: layer1 moves its 256-channel activations
// through device memory once per block here (vs four times for the plain
// conv sequence), so what remains is arithmetic: ~70 kMAC per pixel per
// block, done as register-tiled f32 FMA products over shared-memory tiles.
// The stem conv is small (147 MACs per output channel) and reads each
// input pixel from a shared-memory tile that includes its halo. Both stay
// on the FMA pipes; tensor-core (mma/wgmma) tiles are later work.
//
// Numerics follow the TPU kernels: inputs and weights in the working dtype
// T, products accumulated in f32, bias added in f32, and every stored
// intermediate (stem map, conv1 and conv2 activations) rounded to T.
#include "common.cuh"

#include <math.h>

namespace kgdet {
namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------------ K4
constexpr int kStemC = 64;                 // stem output channels
constexpr int kPoolTH = 4;                 // pooled rows per block
constexpr int kPoolTW = 8;                 // pooled cols per block
constexpr int kConvTH = 2 * kPoolTH + 1;   // stem rows incl. pool halo
constexpr int kConvTW = 2 * kPoolTW + 1;
constexpr int kInTH = 2 * (kConvTH - 1) + 7;  // input rows incl. conv halo
constexpr int kInTW = 2 * (kConvTW - 1) + 7;
constexpr int kTaps = 7 * 7 * 3;
constexpr int kStemSmemFloats =
    kTaps * kStemC + kInTH * kInTW * 3 + kConvTH * kConvTW * kStemC;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int H2, int W2, int H4, int W4) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                            // [tap][co]
  float* xs = ws + kTaps * kStemC;             // [row][col][ci]
  float* cs = xs + kInTH * kInTW * 3;          // [row][col][co]

  const int tid = threadIdx.x;
  const int pw0 = blockIdx.x * kPoolTW;
  const int ph0 = blockIdx.y * kPoolTH;
  const int b = blockIdx.z;
  const int cr0 = 2 * ph0 - 1;  // first stem row of the tile
  const int cc0 = 2 * pw0 - 1;
  const int ir0 = 2 * cr0 - 3;  // first input row of the tile
  const int ic0 = 2 * cc0 - 3;

  for (int i = tid; i < kTaps * kStemC; i += kThreads) ws[i] = to_f32(w[i]);
  for (int i = tid; i < kInTH * kInTW * 3; i += kThreads) {
    const int r = i / (kInTW * 3);
    const int rem = i % (kInTW * 3);
    const int col = rem / 3;
    const int ci = rem % 3;
    const int gy = ir0 + r;
    const int gx = ic0 + col;
    xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                ? to_f32(x[(((size_t)b * H + gy) * W + gx) * 3 + ci])
                : 0.f;
  }
  __syncthreads();

  const int co = tid % kStemC;
  const float bco = bias[co];
  for (int pos = tid / kStemC; pos < kConvTH * kConvTW;
       pos += kThreads / kStemC) {
    const int cy = pos / kConvTW;
    const int cx = pos % kConvTW;
    const int gy = cr0 + cy;
    const int gx = cc0 + cx;
    float v = -INFINITY;  // maxpool pads with -inf
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
      float acc = 0.f;
      for (int ky = 0; ky < 7; ++ky) {
        const float* xrow = xs + ((2 * cy + ky) * kInTW + 2 * cx) * 3;
        const float* wrow = ws + ky * 7 * 3 * kStemC + co;
#pragma unroll
        for (int t = 0; t < 21; ++t) acc += xrow[t] * wrow[t * kStemC];
      }
      v = round_to<T>(fmaxf(acc + bco, 0.f));
    }
    cs[pos * kStemC + co] = v;
  }
  __syncthreads();

  for (int pp = tid / kStemC; pp < kPoolTH * kPoolTW;
       pp += kThreads / kStemC) {
    const int py = pp / kPoolTW;
    const int px = pp % kPoolTW;
    const int gy = ph0 + py;
    const int gx = pw0 + px;
    if (gy >= H4 || gx >= W4) continue;
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, cs[((2 * py + dy) * kConvTW + 2 * px + dx) * kStemC + co]);
    out[(((size_t)b * H4 + gy) * W4 + gx) * kStemC + co] = from_f32<T>(m);
  }
}

// ------------------------------------------------------------------ K5
constexpr int kWidth = 64;           // bottleneck mid channels
constexpr int kBT = 8;               // output tile is kBT x kBT pixels
constexpr int kHalo = kBT + 2;       // conv1 tile incl. the 3x3 halo
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kKC = 32;              // reduction chunk
constexpr int kLd = 64 + 4;          // padded row of a [k][m] staging tile
constexpr int kBlockSmemFloats =
    kWidth * kHaloPix + kWidth * 64 + 2 * kKC * kLd;

// acc[i][j] += sum_k A[k*lda + ty*4+i] * B[k*ldb + tx*4+j], k < kKC
__device__ __forceinline__ void mma_chunk(const float* A, int lda,
                                          const float* Bm, int ldb, int ty,
                                          int tx, float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < kKC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k * lda + ty * 4]);
    const float4 w = *reinterpret_cast<const float4*>(&Bm[k * ldb + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// xs[k*kLd + m] = x[pixel of row m][c0 + k], zero outside the image or C;
// row m < 64 maps to a pixel through pix_y/pix_x (-1 = no pixel)
template <typename T, typename PixFn>
__device__ __forceinline__ void stage_x(const T* xb, int H, int W, int Cin,
                                        int c0, float* xs, PixFn pix) {
  const int k = threadIdx.x % kKC;
  for (int m = threadIdx.x / kKC; m < 64; m += kThreads / kKC) {
    int gy, gx;
    pix(m, gy, gx);
    const int c = c0 + k;
    xs[k * kLd + m] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
            ? to_f32(xb[((size_t)gy * W + gx) * Cin + c])
            : 0.f;
  }
}

// ws[k*kLd + n] = w[(k0 + k) * ld + n0 + n] for n < 64, zero past rows
template <typename T>
__device__ __forceinline__ void stage_w(const T* w, int rows, int ld, int k0,
                                        int n0, float* ws) {
  const int n = threadIdx.x % 64;
  for (int k = threadIdx.x / 64; k < kKC; k += kThreads / 64) {
    ws[k * kLd + n] =
        (k0 + k < rows) ? to_f32(w[(size_t)(k0 + k) * ld + n0 + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, const T* __restrict__ wd,
                  const float* __restrict__ bd, T* __restrict__ out, int H,
                  int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* a1 = smem;                        // conv1 out, [ch][halo pixel]
  float* a2 = a1 + kWidth * kHaloPix;      // conv2 out, [ch][pixel]
  float* sa = a2 + kWidth * 64;            // A staging, [k][m]
  float* sb = sa + kKC * kLd;              // B staging, [k][n]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int w0 = blockIdx.x * kBT;
  const int h0 = blockIdx.y * kBT;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cin;
  float acc[4][4];

  // conv1 over the halo tile: rows 0..99 in two passes of 64
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
    zero_acc(acc);
    for (int c0 = 0; c0 < Cin; c0 += kKC) {
      stage_x(xb, H, W, Cin, c0, sa, pix);
      stage_w(w1, Cin, kWidth, c0, 0, sb);
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
        const int ch = tx * 4 + j;
        // the 3x3 conv zero-pads conv1's output at the image border
        a1[ch * kHaloPix + hp] =
            inside ? round_to<T>(fmaxf(acc[i][j] + b1[ch], 0.f)) : 0.f;
      }
    }
  }
  __syncthreads();

  // conv2: 9 shifted products over the halo tile
  zero_acc(acc);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    for (int c0 = 0; c0 < kWidth; c0 += kKC) {
      // A[k][m] = a1[c0+k][halo pixel of (m + tap shift)]
      {
        const int k = tid % kKC;
        for (int m = tid / kKC; m < 64; m += kThreads / kKC) {
          const int hp = (m / kBT + dy) * kHalo + (m % kBT + dx);
          sa[k * kLd + m] = a1[(c0 + k) * kHaloPix + hp];
        }
      }
      stage_w(w2 + (size_t)tap * kWidth * kWidth, kWidth, kWidth, c0, 0, sb);
      __syncthreads();
      mma_chunk(sa, kLd, sb, kLd, ty, tx, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = tx * 4 + j;
      a2[ch * 64 + ty * 4 + i] = round_to<T>(fmaxf(acc[i][j] + b2[ch], 0.f));
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
    for (int c0 = 0; c0 < kWidth; c0 += kKC) {
      stage_w(w3, kWidth, Cout, c0, n0, sb);
      __syncthreads();
      mma_chunk(a2 + c0 * 64, 64, sb, kLd, ty, tx, acc);
      __syncthreads();
    }
    float dacc[4][4];
    zero_acc(dacc);
    if (has_ds) {
      for (int c0 = 0; c0 < Cin; c0 += kKC) {
        stage_x(xb, H, W, Cin, c0, sa, center);
        stage_w(wd, Cin, Cout, c0, n0, sb);
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
        const float ident = has_ds ? dacc[i][j] + bd[n]
                                   : to_f32(x[pix * Cin + n]);
        out[pix * Cout + n] =
            from_f32<T>(fmaxf((acc[i][j] + b3[n]) + ident, 0.f));
      }
    }
  }
}

template <typename T>
int launch_stem(const void* x, const void* w, const void* bias, void* out,
                int B, int H, int W, cudaStream_t stream) {
  const int H2 = (H - 1) / 2 + 1;
  const int W2 = (W - 1) / 2 + 1;
  const int H4 = (H2 - 1) / 2 + 1;
  const int W4 = (W2 - 1) / 2 + 1;
  const size_t smem = kStemSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W4 + kPoolTW - 1) / kPoolTW, (H4 + kPoolTH - 1) / kPoolTH, B);
  stem_pool_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W, H2, W2,
      H4, W4);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* wd, const void* bd, void* out,
                 int B, int H, int W, int Cin, int Cout,
                 cudaStream_t stream) {
  const size_t smem = kBlockSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + kBT - 1) / kBT, (H + kBT - 1) / kBT, B);
  bottleneck_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wd),
      static_cast<const float*>(bd), static_cast<T*>(out), H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kgdet

// x (B, H, W, 3) T; w (7, 7, 3, 64) T folded; bias (64,) f32;
// out (B, H4, W4, 64) T. Returns a cudaError_t code.
extern "C" int kgdet_stem_pool(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return kgdet::launch_stem<float>(x, w, bias, out, B, H, W, s);
  if (dtype == kgdet::kBF16)
    return kgdet::launch_stem<__nv_bfloat16>(x, w, bias, out, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (B, H, W, Cin) T; w1 (Cin, 64), w2 (9, 64, 64) [tap][ci][co],
// w3 (64, Cout), wd (Cin, Cout) or null, all T; biases f32;
// out (B, H, W, Cout) T. Returns a cudaError_t code.
extern "C" int kgdet_frozen_bottleneck(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, const void* w3,
                                       const void* b3, const void* wd,
                                       const void* bd, void* out, int B,
                                       int H, int W, int Cin, int Cout,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return kgdet::launch_block<float>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                                      B, H, W, Cin, Cout, s);
  if (dtype == kgdet::kBF16)
    return kgdet::launch_block<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wd,
                                              bd, out, B, H, W, Cin, Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
