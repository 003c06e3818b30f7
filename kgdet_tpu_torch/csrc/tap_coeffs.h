// The index math of a bilinear tap: clamped row starts and corner
// coefficients from an absolute (y, x) position on an H x W map.
//
// The same f32 expressions, in the same order, as the plain version's
// ops/deform.py::prep_indices, which stays the specification (and is held
// against the TPU path's _prep_indices): per axis floor, frac = c -
// floor(c), the start clamped to [0, size - 2], each loaded coordinate
// start + {0, 1} matched against the tap's true corners floor / floor + 1
// ("clamp-match"), an unmatched (out-of-bounds) corner weighing 0. Weights
// are the plain products wy[i] * wx[j] in the corner order (tl, tr, bl, br).
// There is no multiply-add here, so a compiler that contracts a * b + c
// changes no bit.
//
// The clamp is taken in float before the conversion to int, so a position
// of 1e9 or -1e9 (or a NaN, which clamps to 0) cannot overflow an int: its
// corners match nothing and weigh 0.
//
// The backward (tap_coeffs_bwd, prep_indices_bwd) adds each axis' exact
// derivative d[s] of w[s] with respect to the coordinate, -1 / +1 / 0 for
// a loaded coordinate that is the true floor / floor + 1 / neither, and
// gives the twelve coefficients [w4 | u4 | v4]: wy[i] * wx[j], dwy[i] *
// wx[j], wy[i] * dwx[j].
//
// Plain C++ with no CUDA type: nvcc compiles it for the device (K6, K2 and
// K3: lane l of a warp computes tap l of the warp's 32; K1: the first
// threads of a block compute the taps of its pixel tile into shared
// memory), and a host compiler reads it as it is, which is how the CPU test
// holds it against prep_indices and prep_indices_bwd bit for bit. Needs
// H >= 2 and W >= 2 (the wrappers pad smaller maps with zeros).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define KGDET_HD __host__ __device__ __forceinline__
#else
#define KGDET_HD inline
#endif

namespace kgdet {

// One axis: the start alone, floor(c) clamped to [0, size - 2] in float.
KGDET_HD float axis_start(float c0, int size) {
  const float last = static_cast<float>(size - 2);
  return !(c0 >= 0.f) ? 0.f : (c0 > last ? last : c0);
}

// One axis: the clamped start, the lerp weights w[s] of the loaded
// coordinates start + s and their derivatives d[s] in {-1, 0, +1}.
KGDET_HD void axis_coeffs(float c, int size, int& start, float (&w)[2],
                          float (&d)[2]) {
  const float c0 = floorf(c);
  const float frac = c - c0;
  const float cc = axis_start(c0, size);
  start = static_cast<int>(cc);
  const float e = c0 - cc;  // true floor minus loaded start; exact near 0
  for (int s = 0; s < 2; ++s) {
    const bool lo = e == static_cast<float>(s);      // start + s == floor
    const bool hi = e == static_cast<float>(s - 1);  // start + s == floor + 1
    w[s] = lo ? 1.f - frac : (hi ? frac : 0.f);
    d[s] = lo ? -1.f : (hi ? 1.f : 0.f);
  }
}

KGDET_HD void axis_coeffs(float c, int size, int& start, float (&w)[2]) {
  float d[2];
  axis_coeffs(c, size, start, w, d);
}

// Row starts [r_top, r_bottom] into the (H*W)-flattened map and the four
// lerp weights (tl, tr, bl, br): prep_indices.
KGDET_HD void tap_coeffs(float y, float x, int H, int W, int& r0, int& r1,
                         float (&w4)[4]) {
  int y0, x0;
  float wy[2], wx[2];
  axis_coeffs(y, H, y0, wy);
  axis_coeffs(x, W, x0, wx);
  r0 = y0 * W + x0;
  r1 = (y0 + 1) * W + x0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) w4[2 * i + j] = wy[i] * wx[j];
}

// Row starts as tap_coeffs and the twelve coefficients [w4 | u4 | v4] of
// the sampling backward, corners (tl, tr, bl, br): prep_indices_bwd.
KGDET_HD void tap_coeffs_bwd(float y, float x, int H, int W, int& r0, int& r1,
                             float (&wd12)[12]) {
  int y0, x0;
  float wy[2], wx[2], dwy[2], dwx[2];
  axis_coeffs(y, H, y0, wy, dwy);
  axis_coeffs(x, W, x0, wx, dwx);
  r0 = y0 * W + x0;
  r1 = (y0 + 1) * W + x0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      wd12[2 * i + j] = wy[i] * wx[j];
      wd12[4 + 2 * i + j] = dwy[i] * wx[j];
      wd12[8 + 2 * i + j] = wy[i] * dwx[j];
    }
}

}  // namespace kgdet
