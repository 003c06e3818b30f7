// The bilinear tap gather shared by the deformable sampling kernels.
//
// A tap (b, p, k) of a (B, HW, C) map is described by two clamped row
// starts [r_top, r_bottom] (ops/deform.py::prep_indices): its four corners
// are the rows r_top, r_top + 1, r_bottom, r_bottom + 1, in the order
// (tl, tr, bl, br). A lane handles V consecutive channels with one load per
// corner; V * sizeof(T) == 16 gives the 16-byte loads the card moves
// fastest, V == 1 takes any channel count and alignment.
//
// Used by K2 (deform_split.cu, the two-branch split gather), K6
// (deform_sample.cu, the one-map column gather) and K3 (deform_bwd.cu,
// which needs the corners themselves).
#pragma once

#include "common.cuh"

namespace kgdet {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// f[corner][i] = map[row(corner)][c + i] as f32, corners (tl, tr, bl, br).
// fb: the image's (HW, C) map; c: first channel of the lane's pack.
template <typename T, int V>
__device__ __forceinline__ void load_corners(const T* __restrict__ fb, int C,
                                             int r0, int r1, int c,
                                             float (&f)[4][V]) {
  const T* top = fb + (size_t)r0 * C + c;
  const T* bot = fb + (size_t)r1 * C + c;
  const Pack<T, V> tl = load_pack<T, V>(top);
  const Pack<T, V> tr = load_pack<T, V>(top + C);
  const Pack<T, V> bl = load_pack<T, V>(bot);
  const Pack<T, V> br = load_pack<T, V>(bot + C);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    f[0][i] = to_f32(tl.v[i]);
    f[1][i] = to_f32(tr.v[i]);
    f[2][i] = to_f32(bl.v[i]);
    f[3][i] = to_f32(br.v[i]);
  }
}

// The bilinear sample of V channels: four-corner sum in f32, one rounding
// to T (w: the tap's corner weights, zero for out-of-bounds corners).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> sample_pack(const T* __restrict__ fb,
                                                  int C, int r0, int r1, int c,
                                                  const float (&w)[4]) {
  float f[4][V];
  load_corners<T, V>(fb, C, r0, r1, c, f);
  Pack<T, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i)
    out.v[i] = from_f32<T>(f[0][i] * w[0] + f[1][i] * w[1] + f[2][i] * w[2] +
                           f[3][i] * w[3]);
  return out;
}

// Warps of a launch walk `items` (b, p, k) taps in a grid-stride loop.
constexpr int kTapThreads = 256;
constexpr int kTapWarps = kTapThreads / 32;

inline int tap_grid(long long items) {
  const long long blocks = (items + kTapWarps - 1) / kTapWarps;
  const long long cap = 132LL * 64;  // plenty of waves; the loop takes the rest
  return static_cast<int>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

}  // namespace kgdet
