// K2: shared split gather of the deformable cascade's training forward.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::deform_sample_split_pallas
// (kernel _split_kernel): every tap of every pixel is bilinear-sampled once
// on both branch maps (cls and pts, C channels each), and each sample is
// written straight into the column tensor of the tap's column and the map's
// branch, so the per-column contractions downstream read contiguous
// (B, P, t, C) operands with no slicing.
//
// What bounds it on the H100: bytes. At the training shapes (B=2, maps
// 25x42x256, P=1050, 83 taps in columns of 9, 25 and 49, bf16) it writes 178
// MB of columns and reads 2 MB of maps that stay in L2, against 0.6 GFLOP of
// lerps. What the design does about it is deform_gather.cuh's
// gather_columns with two maps: absolute positions in and the index math of
// ops/deform.py::prep_indices inside the kernel (tap_coeffs.h), computed
// once per tap for both maps and handed round the warp by shuffle; the two
// maps come as two pointers (no channel concat is made); the six column
// tensors' offsets come by value in the kernel's parameters; a tap's column
// is found by comparing against at most eight constants, with no 64-bit
// division and no table load per tap; one tap of both maps in flight per
// warp; map reads on the read-only path, column writes as streaming stores;
// a persistent grid of 16 blocks an SM. So a call is one launch. The TPU
// kernel's pixel tiles, row pairing and six-dimensional raw layout are
// Mosaic workarounds and are not carried over.
//
// Measured (NVIDIA H100 80GB HBM3 at 700 W, bf16, batch 2, one call,
// tools/gather_tuning.py): 0.070 ms on the device with taps near their
// pixel, 1.28x the 0.054 ms bytes bound; 0.089 ms with taps spread over the
// map. Two taps in flight 0.076 ms, four 0.085 ms (more registers, fewer
// warps an SM), plain stores 0.079 ms, 8 or 32 blocks an SM within 1%.
//
// Numerics follow the TPU kernel: four-corner sum in f32 with f32 weights,
// one rounding to the feature dtype.
#include "deform_gather.cuh"

#ifndef KGDET_GATHER_TAPS_IN_FLIGHT
#define KGDET_GATHER_TAPS_IN_FLIGHT 1  // 8 corner loads a lane, 2 maps
#endif

namespace kgdet {
namespace {

template <typename T, int V>
__global__ void __launch_bounds__(kTapThreads)
deform_split_kernel(const __grid_constant__ GatherArgs<T, 2> a) {
  gather_columns<T, V, KGDET_GATHER_TAPS_IN_FLIGHT, 2>(a);
}

template <typename T>
struct SplitKernel {
  template <int V>
  static void run(dim3 grid, cudaStream_t stream, const GatherArgs<T, 2>& a) {
    deform_split_kernel<T, V><<<grid, kTapThreads, 0, stream>>>(a);
  }
};

template <typename T>
cudaError_t launch(const void* cls, const void* pts, const void* pos,
                   void* out, const ColumnTable& tab, int B, int H, int W,
                   int C, int P, int K, int vec, cudaStream_t stream) {
  GatherArgs<T, 2> a{};
  a.maps[0] = static_cast<const T*>(cls);
  a.maps[1] = static_cast<const T*>(pts);
  a.pos = static_cast<const float*>(pos);
  a.out = static_cast<T*>(out);
  a.tab = tab;
  a.H = H, a.W = W, a.C = C, a.P = P, a.K = K;
  return launch_gather<T, 2, SplitKernel<T>>(a, B, vec, stream);
}

}  // namespace
}  // namespace kgdet

// cls, pts (B, H*W, C) T with H, W >= 2; pos (B, P, K, 2) f32 absolute
// (y, x); out: one buffer of B*P*K*2C elements T holding the 2 * tab.n
// column tensors at tab.off (ColumnTable, by value). vec != 0 promises
// C % (16 / sizeof(T)) == 0 and 16-byte aligned cls, pts and out.
// Returns the launch's cudaError_t.
extern "C" int kgdet_deform_split(const void* cls, const void* pts,
                                  const void* pos, void* out,
                                  kgdet::ColumnTable tab, int B, int H, int W,
                                  int C, int P, int K, int vec, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return static_cast<int>(kgdet::launch<float>(cls, pts, pos, out, tab, B,
                                                 H, W, C, P, K, vec, s));
  if (dtype == kgdet::kBF16)
    return static_cast<int>(kgdet::launch<__nv_bfloat16>(
        cls, pts, pos, out, tab, B, H, W, C, P, K, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
