// The bf16 tensor-core bodies of K4 stem_pool and K5 frozen_bottleneck
// (stem_layer1.cu launches them; its FMA bodies keep f32 and whatever these
// do not take). Both run their convolutions as implicit GEMMs on
// mma.sync.m16n8k16 (bf16 operands, f32 sums), with the TPU kernels'
// numerics: bias in f32, and every stored intermediate (stem map, conv1 and
// conv2 activations) rounded to bf16, as the TPU kernels' bf16 scratch
// holds them. Geometry and index math are in prefix_index.h.
#pragma once

#include <math.h>

#include "mma_sm90.cuh"
#include "prefix_index.h"

namespace kgdet {
namespace prefix {

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kLd = 64 + 8;       // a 64-channel row padded by 16 bytes

// ------------------------------------------------------------ K4 stem_pool
// A block: stage the input tile once (scalar loads: a 3-channel row does
// not start on a 4-byte boundary), compute the 17 x 33 stem tile as a
// (576 x 176) x (176 x 64) product, round it into shared memory with -inf
// outside the stem map, max-pool it, and store 16 bytes a thread. Warps
// are 2 (row fragments) x 4 (16 output channels each); a warp keeps its
// columns' weight fragments for all eleven depth steps in registers, read
// once from the packed weight (64 x kStemKPad, [channel][depth]), and its A
// fragments are 32-bit pairs read straight from the staged tile.
struct StemSmem {
  bf16 in[kStemInTH * kStemRow];   // [row][pixel][channel]
  bf16 stem[kStemPix * kLd];       // [stem pixel][channel]
};

__global__ void __launch_bounds__(kMmaThreads, 2)
stem_pool_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int H, int W, int H2, int W2, int H4, int W4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StemSmem& sm = *reinterpret_cast<StemSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int pw0 = blockIdx.x * kStemPW;
  const int ph0 = blockIdx.y * kStemPH;
  const int b = blockIdx.z;
  const int sy0 = 2 * ph0 - 1;  // first stem row / column of the tile
  const int sx0 = 2 * pw0 - 1;
  const int iy0 = 2 * sy0 - 3;  // first input row / pixel of the tile
  const int ix0 = 2 * sx0 - 3;

  unsigned bw[kStemKSteps][2][2];
#pragma unroll
  for (int s = 0; s < kStemKSteps; ++s)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const bf16* p =
          w + (size_t)(wn * 16 + nt * 8 + g) * kStemKPad + 16 * s + 2 * t;
      bw[s][nt][0] = __ldg(reinterpret_cast<const unsigned*>(p));
      bw[s][nt][1] = __ldg(reinterpret_cast<const unsigned*>(p + 8));
    }

  const bf16* xb = x + (size_t)b * H * W * 3;
  for (int i = tid; i < kStemInTH * kStemRow; i += kMmaThreads) {
    const int r = i / kStemRow;
    const int e = i - r * kStemRow;
    const int gy = iy0 + r;
    const int gx = ix0 + e / 3;
    sm.in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? xb[(size_t)gy * W * 3 + 3 * ix0 + e]
                   : __float2bfloat16(0.f);
  }
  __syncthreads();

  float bz[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    bz[nt][0] = __ldg(bias + wn * 16 + nt * 8 + 2 * t);
    bz[nt][1] = __ldg(bias + wn * 16 + nt * 8 + 2 * t + 1);
  }
  for (int mt = wm; mt < kStemMTiles; mt += 2) {
    const int m_lo = mt * 16 + g;
    const bf16* a_lo = sm.in + stem_row_offset(m_lo);
    const bf16* a_hi = sm.in + stem_row_offset(m_lo + 8);
    float acc[2][4] = {};
#pragma unroll
    for (int s = 0; s < kStemKSteps; ++s) {
      const int k0 = stem_k_offset(16 * s + 2 * t);
      const int k1 = stem_k_offset(16 * s + 2 * t + 8);
      const unsigned a[4] = {*reinterpret_cast<const unsigned*>(a_lo + k0),
                             *reinterpret_cast<const unsigned*>(a_hi + k0),
                             *reinterpret_cast<const unsigned*>(a_lo + k1),
                             *reinterpret_cast<const unsigned*>(a_hi + k1)};
      mma_bf16(acc[0], a, bw[s][0][0], bw[s][0][1]);
      mma_bf16(acc[1], a, bw[s][1][0], bw[s][1][1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_lo + 8 * half;
      if (m >= kStemPix) continue;
      const int sy = sy0 + m / kStemTW;
      const int sx = sx0 + m % kStemTW;
      const bool inside = sy >= 0 && sy < H2 && sx >= 0 && sx < W2;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float lo = inside ? fmaxf(acc[nt][2 * half] + bz[nt][0], 0.f)
                                : -INFINITY;
        const float hi = inside
                             ? fmaxf(acc[nt][2 * half + 1] + bz[nt][1], 0.f)
                             : -INFINITY;
        *reinterpret_cast<unsigned*>(
            &sm.stem[m * kLd + wn * 16 + nt * 8 + 2 * t]) =
            f32_to_bf16x2(lo, hi);
      }
    }
  }
  __syncthreads();

  // 3x3/2 max-pool of the rounded stem tile: (pooled pixel, 8 channels) an
  // item, the max of bf16 values is exact
  for (int i = tid; i < kStemPH * kStemPW * 8; i += kMmaThreads) {
    const int pix = i >> 3;
    const int piece = i & 7;
    const int py = pix / kStemPW;
    const int px = pix % kStemPW;
    const int gy = ph0 + py;
    const int gx = pw0 + px;
    if (gy >= H4 || gx >= W4) continue;
    __nv_bfloat162 m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = __float2bfloat162_rn(-INFINITY);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            &sm.stem[((2 * py + dy) * kStemTW + 2 * px + dx) * kLd +
                     piece * 8]);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = __hmax2(m[j], h[j]);
      }
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * H4 + gy) * W4 + gx) * 64 + piece * 8) =
        *reinterpret_cast<const uint4*>(m);
  }
}

// ----------------------------------------------------- K5 frozen_bottleneck
// A block owns a 16 x 16 output tile and walks one schedule of steps, each
// a 64-deep slice of one product, through a two-stage cp.async ring:
//   conv1: ceil(Cin / 64) steps over the 18 x 18 halo (336 GEMM rows);
//   conv2: 9 steps, one a tap, the operand rows those of the conv1 tile
//          shifted inside it (prefix_index.h::halo_row), no copy a tap;
//   conv3: per 64 output channels one step (with the identity's x slice
//          when there is no downsample) and ceil(Cin / 64) downsample steps
//          into the same f32 sums.
// While a step's products run, the next step's weight slice (and x slice)
// are in flight into the other stage: one __syncthreads a step. conv1's
// output (zero outside the image: conv2 zero-pads it) and conv2's stay in
// shared memory in bf16; the epilogue adds the biases and the identity in
// f32, applies the ReLU, rounds, and stores 16 bytes a thread through a
// staging tile (conv1's, free by then).
struct BlockSmem {
  bf16 a1[kBlkHaloRows * kLd];      // conv1 out over the halo; out staging
  bf16 a2[kBlkT * kBlkT * kLd];     // conv2 out
  bf16 x[2][kBlkHaloRows * kLd];    // x slices: [halo or tile pixel][ch]
  bf16 w[2][64 * kLd];              // weight slices: [in ch][out ch]
};

// acc[i] += rows arow[i] (16 x 64, this lane's ldmatrix row) x ws (64 x 64)
// for the first `live` of the three row fragments
__device__ __forceinline__ void mma_k64(float (&acc)[3][8][4],
                                        const bf16* (&arow)[3],
                                        int live, const bf16* ws, int lane) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    unsigned bfr[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      ldmatrix_x4_trans(
          bfr[nj], ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                       nj * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i >= live) break;
      unsigned a[4];
      ldmatrix_x4(a, arow[i] + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        mma_bf16(acc[i][2 * nj], a, bfr[nj][0], bfr[nj][1]);
        mma_bf16(acc[i][2 * nj + 1], a, bfr[nj][2], bfr[nj][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc3(float (&acc)[3][8][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
}

__global__ void __launch_bounds__(kMmaThreads, 1)
bottleneck_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const bf16* __restrict__ w3,
                      const float* __restrict__ b3,
                      const bf16* __restrict__ wd,
                      const float* __restrict__ bd, bf16* __restrict__ out,
                      int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
  const int w0 = blockIdx.x * kBlkT;
  const int h0 = blockIdx.y * kBlkT;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * Cin;
  const bool has_ds = wd != nullptr;
  const int nc = (Cin + 63) / 64;              // 64-channel slices of x
  const int per_n = 1 + (has_ds ? nc : 0);     // steps a 64-channel output
  const int s_conv2 = nc;
  const int s_conv3 = nc + 9;
  const int steps = s_conv3 + (Cout / 64) * per_n;

  // x slice [c0, c0 + 64) of the halo (336 rows) or the tile (256 rows);
  // zero outside the image and past Cin
  auto fetch_x = [&](int stage, int c0, bool halo) {
    const int rows = halo ? kBlkHaloRows : kBlkT * kBlkT;
    for (int i = tid; i < rows * 8; i += kMmaThreads) {
      const int r = i >> 3;
      const int c = c0 + (i & 7) * 8;
      const int gy = halo ? h0 - 1 + r / kBlkHalo : h0 + r / kBlkT;
      const int gx = halo ? w0 - 1 + r % kBlkHalo : w0 + r % kBlkT;
      const bool ok = (!halo || r < kBlkHaloPix) && gy >= 0 && gy < H &&
                      gx >= 0 && gx < W && c < Cin;
      cp_async16(&sm.x[stage][r * kLd + (i & 7) * 8],
                 ok ? xb + ((size_t)gy * W + gx) * Cin + c : xb,
                 ok ? 16 : 0);
    }
  };
  // rows [0, 64) x 64 columns of a row-major matrix from src, row stride
  // ld; rows at or past `rows` zero
  auto fetch_w = [&](int stage, const bf16* src, int ld, int rows) {
    for (int i = tid; i < 64 * 8; i += kMmaThreads) {
      const int r = i >> 3;
      const bool ok = r < rows;
      cp_async16(&sm.w[stage][r * kLd + (i & 7) * 8],
                 ok ? src + (size_t)r * ld + (i & 7) * 8 : src, ok ? 16 : 0);
    }
  };
  auto fetch = [&](int s) {
    const int stage = s & 1;
    if (s < s_conv2) {
      fetch_x(stage, 64 * s, true);
      fetch_w(stage, w1 + (size_t)64 * s * 64, 64, Cin - 64 * s);
    } else if (s < s_conv3) {
      fetch_w(stage, w2 + (size_t)(s - s_conv2) * 64 * 64, 64, 64);
    } else {
      const int q = s - s_conv3;
      const int n0 = q / per_n * 64;
      const int r = q % per_n;
      if (r == 0) {
        fetch_w(stage, w3 + n0, Cout, 64);
        if (!has_ds) fetch_x(stage, n0, false);  // the identity slice
      } else {
        const int c0 = (r - 1) * 64;
        fetch_x(stage, c0, false);
        fetch_w(stage, wd + (size_t)c0 * Cout + n0, Cout, Cin - c0);
      }
    }
  };
  auto end_step = [&]() {
    cp_async_wait_all();
    __syncthreads();
  };

  float acc[3][8][4];
  const bf16* arow[3];
  fetch(0);
  end_step();
  int s = 0;

  // conv1 over the halo: 21 row fragments, warp w takes w, w + 8, w + 16
  const int live1 = warp + 16 < kBlkHaloRows / 16 ? 3 : 2;
  zero_acc3(acc);
  for (; s < s_conv2; ++s) {
    if (s + 1 < steps) fetch(s + 1);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      arow[i] = sm.x[s & 1] + ((warp + 8 * i) * 16 + lrow) * kLd;
    mma_k64(acc, arow, live1, sm.w[s & 1], lane);
    if (s == s_conv2 - 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i >= live1) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int hp = (warp + 8 * i) * 16 + g + 8 * half;
          const int gy = h0 - 1 + hp / kBlkHalo;
          const int gx = w0 - 1 + hp % kBlkHalo;
          const bool inside = hp < kBlkHaloPix && gy >= 0 && gy < H &&
                              gx >= 0 && gx < W;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = n * 8 + 2 * t;
            const float lo =
                inside ? fmaxf(acc[i][n][2 * half] + __ldg(b1 + col), 0.f)
                       : 0.f;
            const float hi =
                inside
                    ? fmaxf(acc[i][n][2 * half + 1] + __ldg(b1 + col + 1), 0.f)
                    : 0.f;
            *reinterpret_cast<unsigned*>(&sm.a1[hp * kLd + col]) =
                f32_to_bf16x2(lo, hi);
          }
        }
      }
    }
    end_step();
  }

  // conv2: warp w takes output rows 2w and 2w + 1 (a fragment a row)
  zero_acc3(acc);
  for (; s < s_conv3; ++s) {
    if (s + 1 < steps) fetch(s + 1);
    const int tap = s - s_conv2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      arow[i] = sm.a1 + halo_row(2 * warp + i, lrow, tap) * kLd;
    arow[2] = arow[1];
    mma_k64(acc, arow, 2, sm.w[s & 1], lane);
    if (tap == 8) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (2 * warp + i) * 16 + g + 8 * half;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = n * 8 + 2 * t;
            *reinterpret_cast<unsigned*>(&sm.a2[m * kLd + col]) =
                f32_to_bf16x2(
                    fmaxf(acc[i][n][2 * half] + __ldg(b2 + col), 0.f),
                    fmaxf(acc[i][n][2 * half + 1] + __ldg(b2 + col + 1),
                          0.f));
          }
        }
    }
    end_step();
  }

  // conv3 (+ downsample), 64 output channels at a time
  for (int n0 = 0; n0 < Cout; n0 += 64) {
    zero_acc3(acc);
    for (int r = 0; r < per_n; ++r, ++s) {
      if (s + 1 < steps) fetch(s + 1);
      const bf16* src = r == 0 ? sm.a2 : sm.x[s & 1];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        arow[i] = src + ((2 * warp + i) * 16 + lrow) * kLd;
      arow[2] = arow[1];
      mma_k64(acc, arow, 2, sm.w[s & 1], lane);
      if (r == per_n - 1) {
        const bf16* ident = sm.x[s & 1];   // without a downsample
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (2 * warp + i) * 16 + g + 8 * half;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const int col = n * 8 + 2 * t;
              float lo = acc[i][n][2 * half] + __ldg(b3 + n0 + col);
              float hi = acc[i][n][2 * half + 1] + __ldg(b3 + n0 + col + 1);
              if (has_ds) {
                lo += __ldg(bd + n0 + col);
                hi += __ldg(bd + n0 + col + 1);
              } else {
                const float2 v = bf16x2_to_f32(
                    *reinterpret_cast<const unsigned*>(&ident[m * kLd + col]));
                lo += v.x;
                hi += v.y;
              }
              *reinterpret_cast<unsigned*>(&sm.a1[m * kLd + col]) =
                  f32_to_bf16x2(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
            }
          }
        __syncthreads();
        for (int i = tid; i < kBlkT * kBlkT * 8; i += kMmaThreads) {
          const int m = i >> 3;
          const int gy = h0 + m / kBlkT;
          const int gx = w0 + m % kBlkT;
          if (gy >= H || gx >= W) continue;
          *reinterpret_cast<uint4*>(
              out + (((size_t)b * H + gy) * W + gx) * Cout + n0 +
              (i & 7) * 8) =
              *reinterpret_cast<const uint4*>(&sm.a1[m * kLd + (i & 7) * 8]);
        }
      }
      end_step();
    }
  }
}

}  // namespace prefix
}  // namespace kgdet
