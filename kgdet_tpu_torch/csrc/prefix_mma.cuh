// The bf16 tensor-core bodies of K4 stem_pool and of the frozen bottleneck,
// K5 frozen_bottleneck and K8 fused_bottleneck: stem_layer1.cu launches K4's
// and the bottleneck at width 64 (K5), resblock.cu the bottleneck at any
// width that fits (K8); their FMA bodies keep f32 and whatever these do not
// take. Both run their convolutions as implicit GEMMs on mma.sync.m16n8k16
// (bf16 operands, f32 sums), with the TPU kernels' numerics: bias in f32,
// and every stored intermediate (stem map, conv1 and conv2 activations)
// rounded to bf16, as the TPU kernels' bf16 scratch holds them. Geometry,
// index math and the bottleneck's schedule are in prefix_index.h.
#pragma once

#include <math.h>

#include "mma_sm90.cuh"
#include "prefix_index.h"

namespace kgdet {
namespace prefix {

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kLd = kBlkSliceLd;  // a 64-channel row padded by 16 bytes

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

// ------------------------------------------ K5 / K8 frozen_bottleneck body
// One frozen stride-1 bottleneck at any width that fits (a multiple of 8),
// Cin and Cout multiples of 8. A block owns a TH x TW output tile (16x16 for
// K5's shapes, width 64 and Cout a multiple of 64, fixed at compile time;
// 8x16 or 8x8 for the rest: prefix_index.h::blk_tile) and walks one
// schedule of steps (prefix_index.h::blk_next), each a 64-deep slice of one
// product into 64 output channels, through a two-stage cp.async ring:
//   conv1: per 64 channels of the width, ceil(Cin / 64) steps over the halo;
//   conv2: per 64 channels, 9 taps x the width's slices, the operand rows
//          those of the conv1 tile shifted inside it (halo_row), no copy a
//          tap;
//   conv3: per 64 output channels, the width's slices (without a
//          downsample the identity's x slice arrives with the last) and
//          ceil(Cin / 64) downsample steps into the same f32 sums.
// While a step's products run, the next step's weight slice (and x slice)
// are in flight into the other stage: one __syncthreads a step. Channels
// past Cin, the width or Cout arrive as zeros (the cp.async source size).
// conv1's output is 0 outside the image (conv2 zero-pads it) and in the
// width's padding, conv2's in the padding; both stay in shared memory in
// bf16. The epilogue adds the biases and the identity in f32, applies the
// ReLU, rounds, and stores 16 bytes a thread through a staging tile
// (conv1's, free by then). At width 64 this is K5's schedule.
//
// The 8 warps split a product's row fragments; on the 8x8 tile (4 output
// fragments) they also split a slice's 64 columns in two halves.
template <int TH, int TW>
struct BlkWarps {
  static constexpr int kFrags = TH * TW / 16;          // output fragments
  static constexpr int kWM = kFrags < 8 ? kFrags : 8;  // warps along rows
  static constexpr int kNT = kWM / 2;                  // 16-column tiles
  static constexpr int kFR = kFrags / kWM;  // conv2 / conv3 fragments a warp
  static constexpr int kHF = BlkTile<TH, TW>::kHaloRows / 16;
  static constexpr int kR = (kHF + kWM - 1) / kWM;  // conv1 fragments a warp
  static_assert(kWM == 8 || kWM == 4, "8 warps over rows, or 4 x 2");
  static_assert(kR >= kFR, "conv1 holds the most fragments");
};

// acc[i] += rows arow[i] (16 x 64, this lane's ldmatrix row) x ws (64 deep,
// 8 * N columns) for the first `live` of the R row fragments
template <int R, int N>
__device__ __forceinline__ void mma_k64(float (&acc)[R][N][4],
                                        const bf16* (&arow)[R], int live,
                                        const bf16* ws, int lane) {
  constexpr int NT = N / 2;  // 16-column tiles
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    unsigned bfr[NT][4];
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
      ldmatrix_x4_trans(
          bfr[nj], ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                       nj * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= live) break;
      unsigned a[4];
      ldmatrix_x4(a, arow[i] + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        mma_bf16(acc[i][2 * nj], a, bfr[nj][0], bfr[nj][1]);
        mma_bf16(acc[i][2 * nj + 1], a, bfr[nj][2], bfr[nj][3]);
      }
    }
  }
}

template <int R, int N>
__device__ __forceinline__ void zero_accs(float (&acc)[R][N][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
}

template <int TH, int TW>
__global__ void __launch_bounds__(kMmaThreads, 1)
bottleneck_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const bf16* __restrict__ w3,
                      const float* __restrict__ b3,
                      const bf16* __restrict__ wd,
                      const float* __restrict__ bd, bf16* __restrict__ out,
                      int H, int W, int Cin, int width_in, int Cout) {
  using Tile = BlkTile<TH, TW>;
  using Warps = BlkWarps<TH, TW>;
  constexpr int kR = Warps::kR;
  constexpr int kNT = Warps::kNT;
  constexpr int kFR = Warps::kFR;
  constexpr int kXStage = Tile::kHaloRows * kLd;
  constexpr int kWStage = 64 * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the tile that fits one slice of the width (16x16) is K5's instance:
  // width 64 and Cout a multiple of 64 (blk_tile), no channel masked
  constexpr bool kK5 = Tile::kMaxSlices == 1;
  const int width = kK5 ? 64 : width_in;
  const int ns = kK5 ? 1 : (width + 63) / 64;  // 64-channel slices
  const int ld1 = kK5 ? kLd : blk_ld(width);
  bf16* a1 = reinterpret_cast<bf16*>(smem_raw);  // conv1 out [halo row][ch]
  bf16* a2 = a1 + Tile::kHaloRows * ld1;         // conv2 out [pixel][ch]
  bf16* xs = a2 + Tile::kPix * ld1;              // x slices [row][ch] x 2
  bf16* ws = xs + 2 * kXStage;                   // weight slices [in][out] x 2
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = Warps::kWM == 8 ? warp : warp % Warps::kWM;
  const int cw = Warps::kWM == 8 ? 0 : warp / Warps::kWM * kNT * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * Cin;
  const bool has_ds = wd != nullptr;
  const int nc = (Cin + 63) / 64;  // 64-channel slices of x
  const int nout = (Cout + 63) / 64;
  const int per_n = ns + (has_ds ? nc : 0);  // steps a 64-channel output

  // x slice [c0, c0 + 64) of the halo or the tile; zero outside the image
  // and past Cin
  auto fetch_x = [&](bf16* dst, int c0, bool halo) {
    const int rows = halo ? Tile::kHaloRows : Tile::kPix;
    for (int i = tid; i < rows * 8; i += kMmaThreads) {
      const int r = i >> 3;
      const int c = c0 + (i & 7) * 8;
      const int gy = halo ? h0 - 1 + r / Tile::kHaloW : h0 + r / TW;
      const int gx = halo ? w0 - 1 + r % Tile::kHaloW : w0 + r % TW;
      const bool ok = (!halo || r < Tile::kHaloPix) && gy >= 0 && gy < H &&
                      gx >= 0 && gx < W && c < Cin;
      cp_async16(dst + r * kLd + (i & 7) * 8,
                 ok ? xb + ((size_t)gy * W + gx) * Cin + c : xb,
                 ok ? 16 : 0);
    }
  };
  // the 64 x 64 block at src of a row-major matrix of row stride ld; rows
  // at or past `rows` and columns at or past `cols` zero
  auto fetch_w = [&](bf16* dst, const bf16* src, int ld, int rows,
                     int cols) {
    for (int i = tid; i < 64 * 8; i += kMmaThreads) {
      const int r = i >> 3;
      const int c = (i & 7) * 8;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * kLd + c, ok ? src + (size_t)r * ld + c : src,
                 ok ? 16 : 0);
    }
  };
  // the slices of step st into ring stage `stage`
  auto fetch = [&](int stage, BlkStep st) {
    bf16* xd = xs + stage * kXStage;
    bf16* wt = ws + stage * kWStage;
    const int ci = 64 * st.in;
    const int co = 64 * st.out;
    if (st.phase == kConv1) {
      fetch_x(xd, ci, true);
      fetch_w(wt, w1 + (size_t)ci * width + co, width, Cin - ci, width - co);
    } else if (st.phase == kConv2) {
      fetch_w(wt, w2 + ((size_t)st.tap * width + ci) * width + co, width,
              width - ci, width - co);
    } else if (st.phase == kConv3) {
      fetch_w(wt, w3 + (size_t)ci * Cout + co, Cout, width - ci,
              kK5 ? 64 : Cout - co);
      if (!has_ds && st.in == ns - 1) fetch_x(xd, co, false);  // identity
    } else if (st.phase == kDownsample) {
      fetch_x(xd, ci, false);
      fetch_w(wt, wd + (size_t)ci * Cout + co, Cout, Cin - ci,
              kK5 ? 64 : Cout - co);
    }
  };
  auto end_step = [&]() {
    cp_async_wait_all();
    __syncthreads();
  };

  float acc[kR][2 * kNT][4];
  const bf16* arow[kR];
  // while step s's products run, step s + 1's slices are in flight
  auto fetch_next = [&](int s, BlkStep cur) {
    fetch((s + 1) & 1, blk_next(cur, nc, ns, nout, has_ds));
  };
  fetch(0, BlkStep{kConv1, 0, 0, 0});
  end_step();
  int s = 0;

  // conv1 over the halo: warp fragments wm, wm + kWM, ...
  int live1 = 0;
#pragma unroll
  for (int i = 0; i < kR; ++i) live1 += wm + Warps::kWM * i < Warps::kHF;
  for (int j = 0; j < ns; ++j) {
    zero_accs(acc);
    for (int c = 0; c < nc; ++c, ++s) {
      fetch_next(s, BlkStep{kConv1, j, 0, c});
      const bf16* xa = xs + (s & 1) * kXStage;
#pragma unroll
      for (int i = 0; i < kR; ++i)
        arow[i] = xa + ((wm + Warps::kWM * i) * 16 + lrow) * kLd;
      mma_k64(acc, arow, live1, ws + (s & 1) * kWStage + cw, lane);
      if (c == nc - 1) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if (i >= live1) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int hp = (wm + Warps::kWM * i) * 16 + g + 8 * half;
            const int gy = h0 - 1 + hp / Tile::kHaloW;
            const int gx = w0 - 1 + hp % Tile::kHaloW;
            const bool inside = hp < Tile::kHaloPix && gy >= 0 && gy < H &&
                                gx >= 0 && gx < W;
#pragma unroll
            for (int n = 0; n < 2 * kNT; ++n) {
              const int ch = 64 * j + cw + n * 8 + 2 * t;
              const bool ok = inside && ch < width;
              const float lo =
                  ok ? fmaxf(acc[i][n][2 * half] + __ldg(b1 + ch), 0.f)
                     : 0.f;
              const float hi =
                  ok ? fmaxf(acc[i][n][2 * half + 1] + __ldg(b1 + ch + 1),
                             0.f)
                     : 0.f;
              *reinterpret_cast<unsigned*>(a1 + hp * ld1 + ch) =
                  f32_to_bf16x2(lo, hi);
            }
          }
        }
      }
      end_step();
    }
  }

  // conv2: warp fragments wm * kFR + i, output pixel m = oy * TW + ox
  for (int j = 0; j < ns; ++j) {
    zero_accs(acc);
    for (int tap = 0; tap < 9; ++tap) {
      for (int ci = 0; ci < ns; ++ci, ++s) {
        fetch_next(s, BlkStep{kConv2, j, tap, ci});
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int m = (wm * kFR + (i < kFR ? i : kFR - 1)) * 16 + lrow;
          arow[i] = a1 + halo_row(m / TW, m % TW, tap, Tile::kHaloW) * ld1 +
                    64 * ci;
        }
        mma_k64(acc, arow, kFR, ws + (s & 1) * kWStage + cw, lane);
        if (tap == 8 && ci == ns - 1) {
#pragma unroll
          for (int i = 0; i < kFR; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = (wm * kFR + i) * 16 + g + 8 * half;
#pragma unroll
              for (int n = 0; n < 2 * kNT; ++n) {
                const int ch = 64 * j + cw + n * 8 + 2 * t;
                const bool ok = ch < width;
                const float lo =
                    ok ? fmaxf(acc[i][n][2 * half] + __ldg(b2 + ch), 0.f)
                       : 0.f;
                const float hi =
                    ok ? fmaxf(acc[i][n][2 * half + 1] + __ldg(b2 + ch + 1),
                               0.f)
                       : 0.f;
                *reinterpret_cast<unsigned*>(a2 + m * ld1 + ch) =
                    f32_to_bf16x2(lo, hi);
              }
            }
        }
        end_step();
      }
    }
  }

  // conv3 (+ downsample), 64 output channels at a time
  for (int n0 = 0; n0 < Cout; n0 += 64) {
    zero_accs(acc);
    for (int r = 0; r < per_n; ++r, ++s) {
      fetch_next(s, r < ns ? BlkStep{kConv3, n0 / 64, 0, r}
                           : BlkStep{kDownsample, n0 / 64, 0, r - ns});
      const bf16* xa = xs + (s & 1) * kXStage;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int m = (wm * kFR + (i < kFR ? i : kFR - 1)) * 16 + lrow;
        arow[i] = r < ns ? a2 + m * ld1 + 64 * r : xa + m * kLd;
      }
      mma_k64(acc, arow, kFR, ws + (s & 1) * kWStage + cw, lane);
      if (r == per_n - 1) {
#pragma unroll
        for (int i = 0; i < kFR; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (wm * kFR + i) * 16 + g + 8 * half;
#pragma unroll
            for (int n = 0; n < 2 * kNT; ++n) {
              const int col = cw + n * 8 + 2 * t;
              if (!kK5 && n0 + col >= Cout) continue;
              float lo = acc[i][n][2 * half] + __ldg(b3 + n0 + col);
              float hi = acc[i][n][2 * half + 1] + __ldg(b3 + n0 + col + 1);
              if (has_ds) {
                lo += __ldg(bd + n0 + col);
                hi += __ldg(bd + n0 + col + 1);
              } else {  // the identity slice, this step's x stage
                const float2 v = bf16x2_to_f32(
                    *reinterpret_cast<const unsigned*>(xa + m * kLd + col));
                lo += v.x;
                hi += v.y;
              }
              *reinterpret_cast<unsigned*>(a1 + m * kLd + col) =
                  f32_to_bf16x2(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
            }
          }
        __syncthreads();
        for (int i = tid; i < Tile::kPix * 8; i += kMmaThreads) {
          const int m = i >> 3;
          const int c = (i & 7) * 8;
          const int gy = h0 + m / TW;
          const int gx = w0 + m % TW;
          if (gy >= H || gx >= W || (!kK5 && n0 + c >= Cout)) continue;
          *reinterpret_cast<uint4*>(
              out + (((size_t)b * H + gy) * W + gx) * Cout + n0 + c) =
              *reinterpret_cast<const uint4*>(a1 + m * kLd + c);
        }
      }
      end_step();
    }
  }
}

// Launches the body on a TH x TW tile; returns a cudaError_t code.
template <int TH, int TW>
int launch_bottleneck(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* w3,
                      const void* b3, const void* wd, const void* bd,
                      void* out, int B, int H, int W, int Cin, int width,
                      int Cout, cudaStream_t stream) {
  using Tile = BlkTile<TH, TW>;
  const int smem = blk_smem_bytes(Tile::kHaloRows, Tile::kPix, width);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_mma_kernel<TH, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  bottleneck_mma_kernel<TH, TW><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(wd),
      static_cast<const float*>(bd), static_cast<bf16*>(out), H, W, Cin,
      width, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace prefix
}  // namespace kgdet
