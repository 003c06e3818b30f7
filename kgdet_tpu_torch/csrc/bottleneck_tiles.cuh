// Register-tiled f32 products over shared-memory tiles, shared by the two
// frozen-bottleneck kernels: K5 (stem_layer1.cu, width 64) and K8
// (resblock.cu, any width that fits shared memory).
//
// A block of kThreads = 256 threads owns an 8x8 output tile (64 pixels) and
// computes 64 pixels x 64 channels at a time: thread (ty, tx) of a 16x16
// layout holds a 4x4 tile of sums, pixels ty*4.. and channels tx*4... The
// reduction runs in chunks of kKC rows staged into [k][m] tiles whose rows
// are padded to kLd floats, so the float4 reads do not collide on banks.
#pragma once

#include "common.cuh"

namespace kgdet {

constexpr int kThreads = 256;
constexpr int kBT = 8;               // output tile is kBT x kBT pixels
constexpr int kHalo = kBT + 2;       // conv1 tile incl. the 3x3 halo
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kKC = 32;              // reduction chunk
constexpr int kLd = 64 + 4;          // padded row of a [k][m] staging tile

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
// row m < 64 maps to a pixel through pix(m, gy, gx) (-1 = no pixel)
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

// ws[k*kLd + n] = w[(k0 + k) * ld + n0 + n] for n < 64, zero past `rows`
// rows or `cols` columns of the (rows, ld) matrix
template <typename T>
__device__ __forceinline__ void stage_w(const T* w, int rows, int cols,
                                        int ld, int k0, int n0, float* ws) {
  const int n = threadIdx.x % 64;
  for (int k = threadIdx.x / 64; k < kKC; k += kThreads / 64) {
    ws[k * kLd + n] = (k0 + k < rows && n0 + n < cols)
                          ? to_f32(w[(size_t)(k0 + k) * ld + n0 + n])
                          : 0.f;
  }
}

}  // namespace kgdet
