// The index math of the tensor-core bodies of K4 and K5 (prefix_mma.cuh):
// tile geometry, where an implicit-GEMM operand row and depth index lie in a
// staged tile, and the packed stem weight's depth order.
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

// ----------------------------------------------------- K5 frozen_bottleneck
// A block owns a kBlkT x kBlkT output tile. conv1 runs over its one-pixel
// halo (kBlkHalo x kBlkHalo = 324 pixels for 256 outputs: 27% recompute)
// as GEMM rows hp = hy * kBlkHalo + hx, padded to whole 16-row fragments.
constexpr int kBlkT = 16;
constexpr int kBlkHalo = kBlkT + 2;
constexpr int kBlkHaloPix = kBlkHalo * kBlkHalo;
constexpr int kBlkHaloRows = (kBlkHaloPix + 15) / 16 * 16;

// conv2's operand row for output pixel (oy, ox) of the tile at tap
// (tap / 3, tap % 3): the conv1 tile's row, shifted inside it
KGDET_HD int halo_row(int oy, int ox, int tap) {
  return (oy + tap / 3) * kBlkHalo + ox + tap % 3;
}

}  // namespace kgdet
