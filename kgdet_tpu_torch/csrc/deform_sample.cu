// K6: bilinear columns of one feature map, the training forward of a
// deformable conv.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::deform_sample_pallas (kernel
// _sample_kernel): every tap (b, p, k) of a (B, HW, C) map is sampled at its
// absolute position and written to out[b, p, k, :], the (B, P, K, C) columns
// that the contraction with the (K, C, F) weight and, later, the weight
// gradient read. A tap that lies outside the map writes zeros.
//
// What bounds it on the H100: bytes. At the stride-8 level of the 5-level
// head (B=2, map 100x168x256, P=16800, K=9, bf16) it writes 155 MB of
// columns and reads a 17 MB map that stays in L2, against 0.5 GFLOP of
// lerps. What the design does about it is deform_gather.cuh's
// gather_columns with one map and one column of K taps: absolute positions
// in and the index math of ops/deform.py::prep_indices inside the kernel
// (tap_coeffs.h, once a tap, handed round the warp by shuffle), so a call is
// one launch; four taps in flight per warp; map reads on the read-only
// path, column writes as streaming stores; a persistent grid of 16 blocks
// an SM. The TPU kernel's pixel tiles of 8, SMEM index windows, row pairing
// and lane-slab loop exist to hold the map in VMEM and are not carried over.
//
// Measured (NVIDIA H100 80GB HBM3 at 700 W, bf16, batch 2, the ten launches
// of a serial train step, tools/gather_tuning.py): 0.230 ms on the device
// with taps near their pixel, 1.65x the 0.139 ms bytes bound; 0.297 ms with
// taps spread over the map. One tap in flight 0.281 ms, two 0.263 ms, plain
// stores 0.236 ms, 8 or 32 blocks an SM within 1%.
//
// Numerics follow the TPU kernel: four-corner sum in f32 with f32 weights,
// one rounding to the feature dtype.
#include "deform_gather.cuh"

#ifndef KGDET_GATHER_TAPS_IN_FLIGHT
#define KGDET_GATHER_TAPS_IN_FLIGHT 4  // 16 corner loads a lane
#endif

namespace kgdet {
namespace {

template <typename T, int V>
__global__ void __launch_bounds__(kTapThreads)
deform_sample_kernel(const __grid_constant__ GatherArgs<T, 1> a) {
  gather_columns<T, V, KGDET_GATHER_TAPS_IN_FLIGHT, 1>(a);
}

template <typename T>
struct SampleKernel {
  template <int V>
  static void run(dim3 grid, cudaStream_t stream, const GatherArgs<T, 1>& a) {
    deform_sample_kernel<T, V><<<grid, kTapThreads, 0, stream>>>(a);
  }
};

template <typename T>
cudaError_t launch(const void* feat, const void* pos, void* out, int B, int H,
                   int W, int C, int P, int K, int vec, cudaStream_t stream) {
  GatherArgs<T, 1> a{};
  a.maps[0] = static_cast<const T*>(feat);
  a.pos = static_cast<const float*>(pos);
  a.out = static_cast<T*>(out);
  a.tab.n = 1;  // one column of all K taps at the start of the buffer
  a.tab.taps[0] = K;
  a.H = H, a.W = W, a.C = C, a.P = P, a.K = K;
  return launch_gather<T, 1, SampleKernel<T>>(a, B, vec, stream);
}

}  // namespace
}  // namespace kgdet

// feat (B, H*W, C) T with H, W >= 2; pos (B, P, K, 2) f32 absolute (y, x);
// out (B, P, K, C) T. vec != 0 promises C % (16 / sizeof(T)) == 0 and
// 16-byte aligned feat and out. Returns the launch's cudaError_t.
extern "C" int kgdet_deform_sample(const void* feat, const void* pos,
                                   void* out, int B, int H, int W, int C,
                                   int P, int K, int vec, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return static_cast<int>(kgdet::launch<float>(feat, pos, out, B, H, W, C,
                                                 P, K, vec, s));
  if (dtype == kgdet::kBF16)
    return static_cast<int>(kgdet::launch<__nv_bfloat16>(
        feat, pos, out, B, H, W, C, P, K, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
