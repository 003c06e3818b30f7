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
// Plain C++ with no CUDA type: nvcc compiles it for the device (K6 and K2:
// lane l of a warp computes tap l of the warp's 32 and the others fetch the
// values by shuffle; K1 can take tap_coeffs the same way, and K3 with the
// axis derivatives of prep_indices_bwd added to axis_coeffs), and a host
// compiler reads it as it is, which is how the CPU test holds it against
// prep_indices bit for bit. Needs H >= 2 and W >= 2 (the wrappers pad
// smaller maps with zeros).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define KGDET_HD __host__ __device__ __forceinline__
#else
#define KGDET_HD inline
#endif

namespace kgdet {

// One axis: the clamped start and the lerp weights w[s] of the loaded
// coordinates start + s.
KGDET_HD void axis_coeffs(float c, int size, int& start, float (&w)[2]) {
  const float c0 = floorf(c);
  const float frac = c - c0;
  const float last = static_cast<float>(size - 2);
  const float cc = !(c0 >= 0.f) ? 0.f : (c0 > last ? last : c0);
  start = static_cast<int>(cc);
  const float e = c0 - cc;  // true floor minus loaded start; exact near 0
  for (int s = 0; s < 2; ++s) {
    const bool lo = e == static_cast<float>(s);      // start + s == floor
    const bool hi = e == static_cast<float>(s - 1);  // start + s == floor + 1
    w[s] = lo ? 1.f - frac : (hi ? frac : 0.f);
  }
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

}  // namespace kgdet
