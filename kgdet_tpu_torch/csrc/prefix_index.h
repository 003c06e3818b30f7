// The index math of the tensor-core bodies of K4 and of K5 / K8
// (prefix_mma.cuh): tile geometry, where an implicit-GEMM operand row and
// depth index lie in a staged tile, the packed stem weight's depth order,
// the bottleneck's shared memory and tile at a width, and its schedule.
//
// Plain C++ with no CUDA type, like tap_coeffs.h: nvcc compiles it for the
// device, and a host compiler reads it as it is, which is how the CPU test
// (tests/test_torch_kernels.py) builds the GEMM operands from these
// functions and holds their product against F.conv2d.
#pragma once

#if defined(__CUDACC__)
#define KGDET_HD __host__ __device__ __forceinline__
#else
#define KGDET_HD inline
#endif

namespace kgdet {

// ------------------------------------------------------------ K4 stem_pool
// A block owns kStemPH x kStemPW pooled pixels. The 3x3/2 pool reads stem
// rows 2 * py - 1 .. 2 * py + 1, so the block computes a kStemTH x kStemTW
// stem tile (561 pixels for 128 pooled: 10% recompute), as GEMM rows m =
// sy * kStemTW + sx, padded to whole 16-row fragments.
constexpr int kStemPH = 8;
constexpr int kStemPW = 16;
constexpr int kStemTH = 2 * kStemPH + 1;
constexpr int kStemTW = 2 * kStemPW + 1;
constexpr int kStemPix = kStemTH * kStemTW;
constexpr int kStemMTiles = (kStemPix + 15) / 16;
// the staged input tile, NHWC with 3 channels: rows 2 * sy - 3 + ky and
// pixels 2 * sx - 3 + kx of the stem tile's receptive field, plus one pixel
// a row for the padded depth (below); zero outside the image
constexpr int kStemInTH = 2 * (kStemTH - 1) + 7;
constexpr int kStemInTW = 2 * (kStemTW - 1) + 8;
constexpr int kStemRow = 3 * kStemInTW;  // elements a staged row (even)
// GEMM depth k = ky * kStemKRow + kx * 3 + ci: the 21 values of one kernel
// row are contiguous in a staged row, so an operand pair (k, k + 1), k
// even, is one aligned 32-bit word and no im2col copy is made. Depth 21 ..
// 23 of a kernel row and k >= kStemK meet zero weights.
constexpr int kStemKRow = 24;
constexpr int kStemK = 7 * kStemKRow;
constexpr int kStemKSteps = (kStemK + 15) / 16;  // mma k16 steps
constexpr int kStemKPad = 16 * kStemKSteps;      // the packed weight's depth

// element offset of GEMM depth k inside a staged tile, from the tile
// origin of the GEMM row (0 past kStemK: any finite value, zero weight)
KGDET_HD int stem_k_offset(int k) {
  return k < kStemK ? (k / kStemKRow) * kStemRow + k % kStemKRow : 0;
}

// element offset of GEMM row m's receptive field (its ky = kx = ci = 0
// value) inside the staged tile; 0 for the padding rows m >= kStemPix
KGDET_HD int stem_row_offset(int m) {
  return m < kStemPix ? 2 * (m / kStemTW) * kStemRow + 6 * (m % kStemTW)
                      : 0;
}

// ------------------------------------- K5 / K8 frozen_bottleneck, any width
// The width goes in 64-channel slices. conv1's and conv2's outputs stay in
// shared memory as [pixel][channel] rows of blk_ld(width) bf16 values: the
// width rounded up to the slice, plus 16 bytes, so that the 8 rows an
// ldmatrix reads fall on 8 different bank groups. The x and weight slices
// pass through a two-stage ring of 64-channel rows (kBlkSliceLd).
constexpr int kBlkSliceLd = 64 + 8;
constexpr int kBlkMaxSmem = 232448;  // what a block may ask for (227 KB)

KGDET_HD int blk_ld(int width) { return (width + 63) / 64 * 64 + 8; }

// bytes of shared memory of a tile (halo_rows, pix of BlkTile) at a width
KGDET_HD int blk_smem_bytes(int halo_rows, int pix, int width) {
  return 2 * ((halo_rows + pix) * blk_ld(width) +
              2 * (halo_rows + 64) * kBlkSliceLd);
}

// A block owns a TH x TW output tile: GEMM rows m = oy * TW + ox of conv2
// and conv3. conv1 runs over its one-pixel halo, (TH + 2) x (TW + 2)
// pixels as GEMM rows hp = hy * (TW + 2) + hx, padded to whole 16-row
// fragments (16x16: 324 pixels for 256 outputs, 27% recompute; 8x16: 180
// for 128; 8x8: 100 for 64). kMaxSlices: the most 64-channel slices of the
// width whose tiles fit a block (blk_smem_bytes <= kBlkMaxSmem): one for
// 16x16, which blk_tile gives K5's shapes alone.
template <int TH, int TW>
struct BlkTile {
  static constexpr int kPix = TH * TW;
  static constexpr int kHaloW = TW + 2;
  static constexpr int kHaloPix = (TH + 2) * kHaloW;
  static constexpr int kHaloRows = (kHaloPix + 15) / 16 * 16;
  static constexpr int kMaxSlices =
      ((kBlkMaxSmem / 2 - 2 * (kHaloRows + 64) * kBlkSliceLd) /
           (kHaloRows + kPix) -
       8) /
      64;
};

constexpr int kBlkT = 16;  // K5's tile, kBlkT x kBlkT

// conv2's operand row for output pixel (oy, ox) of the tile at tap
// (tap / 3, tap % 3): the conv1 tile's row, shifted inside it; halo_w is
// the conv1 tile's width, TW + 2
KGDET_HD int halo_row(int oy, int ox, int tap, int halo_w) {
  return (oy + tap / 3) * halo_w + ox + tap % 3;
}

// The tiles of the tensor-core body, largest first: 16x16, 8x16, 8x8.
KGDET_HD int blk_tile_h(int t) { return t == 0 ? 16 : 8; }
KGDET_HD int blk_tile_w(int t) { return t == 2 ? 8 : 16; }

KGDET_HD int blk_tile_smem(int t, int width) {
  const int th = blk_tile_h(t), tw = blk_tile_w(t);
  const int halo_rows = ((th + 2) * (tw + 2) + 15) / 16 * 16;
  return blk_smem_bytes(halo_rows, th * tw, width);
}

// The tile for a width and Cout, or -1 where none fits: 16x16 is K5's
// instance, width 64 and Cout a multiple of 64, which the kernel fixes at
// compile time (no mask on a channel); every other shape takes the first of
// 8x16 (to width 192) and 8x8 (to 448) whose shared memory fits a block.
KGDET_HD int blk_tile(int width, int cout) {
  if (width == 64 && cout % 64 == 0) return 0;
  for (int t = 1; t < 3; ++t)
    if (blk_tile_smem(t, width) <= kBlkMaxSmem) return t;
  return -1;
}

// The schedule a block walks, one 64 x 64 weight slice a step, for nc
// 64-channel slices of Cin, ns of the width and nout of Cout:
//   conv1:  for each output slice, nc steps over the input's slices;
//   conv2:  for each output slice, 9 taps x ns input slices;
//   conv3:  for each output slice, ns steps over conv2's slices, then
//           (with a downsample) nc steps over the input's slices.
// It starts at {kConv1, 0, 0, 0}; blk_next gives the step after a step
// (kDone after the last), by comparisons alone: the kernel asks it for the
// step whose slices to fetch while the current one's products run.
enum BlkPhase { kConv1 = 0, kConv2, kConv3, kDownsample, kDone };

struct BlkStep {
  int phase;
  int out;  // output slice
  int tap;  // conv2's tap, else 0
  int in;   // input slice
};

KGDET_HD BlkStep blk_next(BlkStep st, int nc, int ns, int nout, bool ds) {
  switch (st.phase) {
    case kConv1:
      if (st.in + 1 < nc) return {kConv1, st.out, 0, st.in + 1};
      if (st.out + 1 < ns) return {kConv1, st.out + 1, 0, 0};
      return {kConv2, 0, 0, 0};
    case kConv2:
      if (st.in + 1 < ns) return {kConv2, st.out, st.tap, st.in + 1};
      if (st.tap + 1 < 9) return {kConv2, st.out, st.tap + 1, 0};
      if (st.out + 1 < ns) return {kConv2, st.out + 1, 0, 0};
      return {kConv3, 0, 0, 0};
    case kConv3:
      if (st.in + 1 < ns) return {kConv3, st.out, 0, st.in + 1};
      if (ds) return {kDownsample, st.out, 0, 0};
      break;
    case kDownsample:
      if (st.in + 1 < nc) return {kDownsample, st.out, 0, st.in + 1};
      break;
    default:
      return st;
  }
  return st.out + 1 < nout ? BlkStep{kConv3, st.out + 1, 0, 0}
                           : BlkStep{kDone, 0, 0, 0};
}

}  // namespace kgdet
