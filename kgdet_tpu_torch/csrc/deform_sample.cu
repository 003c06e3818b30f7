// K6: bilinear columns of one feature map, the training forward of a
// deformable conv.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::deform_sample_pallas (kernel
// _sample_kernel): every tap (b, p, k) of a (B, HW, C) map is sampled at its
// absolute position and written to out[b, p, k, :], the (B, P, K, C) columns
// that the contraction with the (K, C, F) weight and, later, the weight
// gradient read.
//
// Inputs come from ops/deform.py::prep_indices (shared with K1, K2 and the
// plain version): per tap the two clamped row starts and the four f32
// corner weights (tl, tr, bl, br), zero for out-of-bounds corners, so a tap
// that lies outside the map writes zeros.
//
// What bounds it on the H100: bytes. At the stride-8 level of the 5-level
// head (B=2, map 100x168x256, P=16800, K=9, bf16) it writes 155 MB of
// columns and reads a 17 MB map that stays in L2, against 0.5 GFLOP of
// lerps. What the design does about it: nothing is staged; a warp owns one
// tap, its lanes cover the C channels in 16-byte packs, so every corner
// read and every column write is a coalesced warp transaction and the
// output is written exactly once. The TPU kernel's pixel tiles of 8, SMEM
// index windows, row pairing and lane-slab loop exist to hold the map in
// VMEM and are not carried over.
//
// Numerics follow the TPU kernel: four-corner sum in f32 with f32 weights,
// one rounding to the feature dtype.
#include "deform_gather.cuh"

namespace kgdet {
namespace {

template <typename T, int V>
__global__ void __launch_bounds__(kTapThreads)
deform_sample_kernel(const T* __restrict__ feat,
                     const int* __restrict__ starts,
                     const float* __restrict__ w4, T* __restrict__ out,
                     int HW, int C, long long taps_per_image,
                     long long items) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kTapWarps;
  for (long long q = (long long)blockIdx.x * kTapWarps + (threadIdx.x >> 5);
       q < items; q += stride) {
    const int b = static_cast<int>(q / taps_per_image);
    const int r0 = starts[2 * q];
    const int r1 = starts[2 * q + 1];
    const float w[4] = {w4[4 * q], w4[4 * q + 1], w4[4 * q + 2],
                        w4[4 * q + 3]};
    const T* fb = feat + (size_t)b * HW * C;
    T* o = out + (size_t)q * C;
    for (int c = lane * V; c < C; c += 32 * V)
      *reinterpret_cast<Pack<T, V>*>(o + c) =
          sample_pack<T, V>(fb, C, r0, r1, c, w);
  }
}

template <typename T>
void launch(const void* feat, const void* starts, const void* w4, void* out,
            int B, int HW, int C, int P, int K, int vec,
            cudaStream_t stream) {
  const long long per_image = (long long)P * K;
  const long long items = per_image * B;
  constexpr int V = 16 / sizeof(T);
  const T* f = static_cast<const T*>(feat);
  const int* st = static_cast<const int*>(starts);
  const float* w = static_cast<const float*>(w4);
  T* o = static_cast<T*>(out);
  const int grid = tap_grid(items);
  if (vec) {
    deform_sample_kernel<T, V><<<grid, kTapThreads, 0, stream>>>(
        f, st, w, o, HW, C, per_image, items);
  } else {
    deform_sample_kernel<T, 1><<<grid, kTapThreads, 0, stream>>>(
        f, st, w, o, HW, C, per_image, items);
  }
}

}  // namespace
}  // namespace kgdet

// feat (B, HW, C) T; starts (B, P, K, 2) int32; w4 (B, P, K, 4) f32;
// out (B, P, K, C) T. vec != 0 promises C % (16 / sizeof(T)) == 0 and
// 16-byte aligned feat and out. Returns cudaGetLastError().
extern "C" int kgdet_deform_sample(const void* feat, const void* starts,
                                   const void* w4, void* out, int B, int HW,
                                   int C, int P, int K, int vec, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32) {
    kgdet::launch<float>(feat, starts, w4, out, B, HW, C, P, K, vec, s);
  } else if (dtype == kgdet::kBF16) {
    kgdet::launch<__nv_bfloat16>(feat, starts, w4, out, B, HW, C, P, K, vec,
                                 s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
