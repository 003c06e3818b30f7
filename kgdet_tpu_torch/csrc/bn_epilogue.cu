// K10: the epilogue of a served conv whose FrozenBatchNorm is folded into
// its weight, in place in the conv's output.
//
// Replaces no TPU kernel: XLA fuses the JAX package's BN, ReLU and residual
// sum into the convolution. Added because the port's served ResNet blocks
// (models/layers.py::conv_frozen_bn) ran them as PyTorch elementwise passes
// after each cuDNN conv: the f32 shift added into the bf16 map through
// PyTorch's dynamic-casting kernel, then a bf16 ReLU, then a residual sum;
// 6.7 ms of a served cascade batch of 8 at 800x1344, the largest block of
// its device time.
//
// What it computes, element by element, in f32 and rounded to the map's
// type T where the PyTorch chain stores (ops/bn_epilogue.py::
// bn_epilogue_ref, the plain version):
//   r = round(y + shift[c])
//   mode kIdentity:      r = round(r + id)
//   mode kIdentityShift: r = round(r + round(id + id_shift[c]))
//   relu:                y = isnan(r) ? r : max(r, 0)  (torch.relu's
//                        clamp_min: NaN kept, fmaxf otherwise)
// Each add is one IEEE add (__fadd_rn), each rounding __float2bfloat16, the
// conversion PyTorch's bf16 kernels use on sm_80 and later; so the result
// equals the chain's bit for bit, NaN and signed zeros included. In f32 the
// roundings are no-ops.
//
// What bounds it on the H100: bytes. It reads the map (and the identity)
// once and writes the map once; 4.63 GB a served R-50 batch of 8 in bf16,
// 1.38 ms at 3.35 TB/s. The design streams: 16-byte loads and stores (8
// bf16 or 4 f32 lanes a vector), four vectors in flight a thread before any
// is written, a persistent grid of as many 256-thread blocks as fit on the
// SMs, the per-channel shifts staged once a block in shared memory and
// read 16 bytes at a time. The maps are channels-last, as the served
// trunks make them, so a vector's lanes are consecutive channels of one
// pixel; C not a multiple of the lanes, or operands off 16 bytes, take the
// one-element body.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "common.cuh"

namespace kgdet {
namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // vectors a thread loads before it stores
constexpr int kShift = 0, kIdentity = 1, kIdentityShift = 2;

template <typename T, int V>
struct Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  Vec<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &u, 16);
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = r.v[0];
  }
}

// torch.relu on the card: clamp_min(v, 0), which returns a NaN as it is
// and otherwise max(float(v), 0)
template <typename T>
__device__ __forceinline__ T relu_of(T r) {
  const float f = to_f32(r);
  return f != f ? r : from_f32<T>(fmaxf(f, 0.0f));
}

// y (n elements of a channels-last map, n below 2^31) in place; element i
// belongs to channel i % C, and a vector's V lanes to V consecutive
// channels. Indices are unsigned 32-bit: a vector index and the grid's
// stride times kInFlight sum to less than 2^32.
template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
bn_epilogue_kernel(T* __restrict__ y, const T* __restrict__ id,
                   const float* __restrict__ shift,
                   const float* __restrict__ id_shift, unsigned nvec, int C,
                   int relu) {
  extern __shared__ float4 s_raw[];  // C shifts, then C identity shifts
  float* s_shift = reinterpret_cast<float*>(s_raw);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_shift[c] = shift[c];
    if (kMode == kIdentityShift) s_shift[C + c] = id_shift[c];
  }
  __syncthreads();
  const unsigned step = gridDim.x * kThreads;
  for (unsigned v0 = blockIdx.x * kThreads + threadIdx.x;
       v0 < nvec; v0 += step * kInFlight) {
    Vec<T, V> a[kInFlight], b[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const unsigned v = v0 + k * step;
      if (v < nvec) {
        a[k] = load<T, V>(y + v * V);
        if (kMode != kShift) b[k] = load<T, V>(id + v * V);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const unsigned v = v0 + k * step;
      if (v >= nvec) continue;
      const int c0 = static_cast<int>((v * V) % C);
      // the lanes' shifts: 16-byte reads (c0 is a multiple of V)
      float sh[V], ish[V];
      if constexpr (V > 1) {
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          const float4 f = *reinterpret_cast<const float4*>(s_shift + c0 + q);
          sh[q] = f.x, sh[q + 1] = f.y, sh[q + 2] = f.z, sh[q + 3] = f.w;
          if (kMode == kIdentityShift) {
            const float4 g =
                *reinterpret_cast<const float4*>(s_shift + C + c0 + q);
            ish[q] = g.x, ish[q + 1] = g.y, ish[q + 2] = g.z;
            ish[q + 3] = g.w;
          }
        }
      } else {
        sh[0] = s_shift[c0];
        if (kMode == kIdentityShift) ish[0] = s_shift[C + c0];
      }
      Vec<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        T r = from_f32<T>(__fadd_rn(to_f32(a[k].v[j]), sh[j]));
        if (kMode != kShift) {
          const T d = kMode == kIdentityShift
                          ? from_f32<T>(__fadd_rn(to_f32(b[k].v[j]), ish[j]))
                          : b[k].v[j];
          r = from_f32<T>(__fadd_rn(to_f32(r), to_f32(d)));
        }
        o.v[j] = relu ? relu_of(r) : r;
      }
      store<T, V>(y + v * V, o);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int V, int kMode>
cudaError_t launch_mode(T* y, const T* id, const float* shift,
                      const float* id_shift, long long n, int C, int relu,
                      cudaStream_t stream) {
  auto kernel = bn_epilogue_kernel<T, V, kMode>;
  const size_t smem = (kMode == kIdentityShift ? 2 : 1) * C * sizeof(float);
  // resident blocks an SM, by the KB of shared memory a block asks for
  static int per_sm[49] = {};
  const int kb = static_cast<int>((smem + 1023) / 1024);
  if (per_sm[kb] == 0) {
    int nb = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, kernel, kThreads, kb * 1024);
    if (err != cudaSuccess) return err;
    per_sm[kb] = nb > 0 ? nb : 1;
  }
  const long long nvec = n / V;
  const long long want = (nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(per_sm[kb]) * sm_count();
  const int grid = static_cast<int>(want < cap ? want : cap);
  kernel<<<grid, kThreads, smem, stream>>>(y, id, shift, id_shift,
                                           static_cast<unsigned>(nvec), C,
                                           relu);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_vec(T* y, const T* id, const float* shift,
                       const float* id_shift, long long n, int C, int relu,
                       cudaStream_t stream) {
  if (id == nullptr)
    return launch_mode<T, V, kShift>(y, id, shift, id_shift, n, C, relu,
                                     stream);
  if (id_shift == nullptr)
    return launch_mode<T, V, kIdentity>(y, id, shift, id_shift, n, C, relu,
                                        stream);
  return launch_mode<T, V, kIdentityShift>(y, id, shift, id_shift, n, C, relu,
                                           stream);
}

template <typename T>
cudaError_t launch(void* y, const void* id, const void* shift,
                   const void* id_shift, long long n, int C, int vec,
                   int relu, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  T* yt = static_cast<T*>(y);
  const T* it = static_cast<const T*>(id);
  const float* s = static_cast<const float*>(shift);
  const float* is = static_cast<const float*>(id_shift);
  if (!vec) return launch_vec<T, 1>(yt, it, s, is, n, C, relu, stream);
  if (C % V) return cudaErrorInvalidValue;
  return launch_vec<T, V>(yt, it, s, is, n, C, relu, stream);
}

}  // namespace
}  // namespace kgdet

// y: n elements of a channels-last (N, C, H, W) map, float32 (dtype 0) or
// bfloat16 (1), written in place. id: NULL, or a map of the same shape,
// type and layout that overlaps y nowhere. shift, id_shift: C float32 each
// (id_shift NULL without id, or for an identity added as it is). vec 1: y
// and id on 16 bytes and C a multiple of 16 bytes' elements. C at most
// 6,144; n below 2^31. Returns the launch's cudaError_t.
extern "C" int kgdet_bn_epilogue(void* y, const void* id, const void* shift,
                                 const void* id_shift, long long n, int C,
                                 int vec, int relu, int dtype, void* stream) {
  using namespace kgdet;
  if (n <= 0 || n >= (1LL << 31) || C <= 0 || C > 6144 || n % C ||
      (id_shift != nullptr && id == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch<float>(y, id, shift, id_shift, n, C, vec,
                                          relu, s));
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(y, id, shift, id_shift, n,
                                                  C, vec, relu, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
