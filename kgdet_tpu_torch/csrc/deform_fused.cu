// K1: fused deformable gather + contraction.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::_fused_kernel (tap walk
// _gather_tile): out[b,p,:] = sum_k sum_c bilinear(feat[b], pos[b,p,k])[c]
// * W[k,c,:], with the sampled columns never written to device memory.
//
// Inputs come from ops/deform_kernels.py::prep_indices (the analog of the
// TPU path's _prep_indices): per (b, p, k) the two clamped row starts
// [r_top, r_bottom] into the (H*W)-flattened map and the four f32 corner
// weights (tl, tr, bl, br), already zero for out-of-bounds corners.
//
// What bounds it on the H100: arithmetic. At the serving shapes (map
// 25x42x256, P=1050, K up to 49, F=256) the contraction is 2*P*K*C*F flops
// (5.4 GFLOP per image for the 49-tap column) over ~7 MB of operands, so
// the kernel is far above the card's ridge point. What the design does: the
// gathered (pixels x channels) tile lives only in shared memory and feeds a
// register-tiled f32 FMA product against the matching weight slice, so no
// column tensor ever reaches device memory (the plain version writes and
// re-reads B*P*K*C samples). The product runs on the FMA pipes, not the
// tensor cores; moving it to wgmma is later work.
//
// Numerics follow the TPU kernel: corner lerp in f32, each sample rounded
// to the feature dtype (the TPU gather scratch is feat.dtype), contraction
// accumulated in f32, output rounded to the feature dtype.
#include "common.cuh"

namespace kgdet {
namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;       // pixels per block
constexpr int kTF = 64;       // output channels per block
constexpr int kTC = 32;       // channel chunk per step
constexpr int kLdA = kTP + 4; // padded row of the sample tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_fused_kernel(const T* __restrict__ feat, const int* __restrict__ starts,
                    const float* __restrict__ w4,
                    const T* __restrict__ weight, T* __restrict__ out, int HW,
                    int C, int P, int K, int F) {
  __shared__ __align__(16) float As[kTC * kLdA];  // samples, [c][p]
  __shared__ __align__(16) float Ws[kTC * kTF];   // weight slice, [c][f]
  __shared__ int s_r0[kTP];
  __shared__ int s_r1[kTP];
  __shared__ float s_w[kTP][4];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTP;
  const int f0 = blockIdx.y * kTF;
  const int b = blockIdx.z;
  const T* fb = feat + (size_t)b * HW * C;

  // product mapping: thread owns rows ty*4.. and columns tx*4..
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // gather mapping: channel lane gc, pixels gp + 8*i
  const int gc = tid % kTC;
  const int gp = tid / kTC;
  // weight staging mapping: column wf, rows wc + 4*i
  const int wf = tid % kTF;
  const int wc = tid / kTF;

  for (int k = 0; k < K; ++k) {
    if (tid < kTP) {
      const int p = p0 + tid;
      if (p < P) {
        const size_t q = ((size_t)b * P + p) * K + k;
        s_r0[tid] = starts[2 * q];
        s_r1[tid] = starts[2 * q + 1];
        s_w[tid][0] = w4[4 * q];
        s_w[tid][1] = w4[4 * q + 1];
        s_w[tid][2] = w4[4 * q + 2];
        s_w[tid][3] = w4[4 * q + 3];
      } else {
        s_r0[tid] = 0;
        s_r1[tid] = 0;
        s_w[tid][0] = s_w[tid][1] = s_w[tid][2] = s_w[tid][3] = 0.f;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += kTC) {
      const int c = c0 + gc;
#pragma unroll
      for (int i = 0; i < kTP / (kThreads / kTC); ++i) {
        const int pl = gp + i * (kThreads / kTC);
        float v = 0.f;
        if (c < C && p0 + pl < P) {
          const T* top = fb + (size_t)s_r0[pl] * C + c;
          const T* bot = fb + (size_t)s_r1[pl] * C + c;
          v = to_f32(top[0]) * s_w[pl][0] + to_f32(top[C]) * s_w[pl][1] +
              to_f32(bot[0]) * s_w[pl][2] + to_f32(bot[C]) * s_w[pl][3];
          v = round_to<T>(v);
        }
        As[gc * kLdA + pl] = v;
      }
#pragma unroll
      for (int i = 0; i < kTC / (kThreads / kTF); ++i) {
        const int cl = wc + i * (kThreads / kTF);
        const int cc = c0 + cl;
        const int f = f0 + wf;
        Ws[cl * kTF + wf] = (cc < C && f < F)
                                ? to_f32(weight[((size_t)k * C + cc) * F + f])
                                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cl = 0; cl < kTC; ++cl) {
        const float4 a = *reinterpret_cast<const float4*>(
            &As[cl * kLdA + ty * 4]);
        const float4 w = *reinterpret_cast<const float4*>(
            &Ws[cl * kTF + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) out[((size_t)b * P + p) * F + f] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* feat, const void* starts, const void* w4,
            const void* weight, void* out, int B, int HW, int C, int P, int K,
            int F, cudaStream_t stream) {
  dim3 grid((P + kTP - 1) / kTP, (F + kTF - 1) / kTF, B);
  deform_fused_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const int*>(starts),
      static_cast<const float*>(w4), static_cast<const T*>(weight),
      static_cast<T*>(out), HW, C, P, K, F);
}

}  // namespace
}  // namespace kgdet

// feat (B, HW, C) T; starts (B, P, K, 2) int32; w4 (B, P, K, 4) f32;
// weight (K, C, F) T; out (B, P, F) T. Returns cudaGetLastError().
extern "C" int kgdet_deform_fused(const void* feat, const void* starts,
                                  const void* w4, const void* weight,
                                  void* out, int B, int HW, int C, int P,
                                  int K, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32) {
    kgdet::launch<float>(feat, starts, w4, weight, out, B, HW, C, P, K, F, s);
  } else if (dtype == kgdet::kBF16) {
    kgdet::launch<__nv_bfloat16>(feat, starts, w4, weight, out, B, HW, C, P,
                                 K, F, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
