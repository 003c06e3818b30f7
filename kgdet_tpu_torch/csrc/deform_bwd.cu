// K3: backward of bilinear sampling at absolute positions.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::_deform_bwd_vw (kernel
// _bwd_kernel_vw) and, being the same function, its two older generations
// in ::_deform_bwd_pallas (_bwd_kernel, _bwd_kernel_v2). For a cotangent g
// (B, P, K, C) of the columns sampled from a (B, H*W, C) map at the
// absolute positions pos (B, P, K, 2):
//   grad_feat[b, row(corner), :] += w[corner] * g[b, p, k, :]   (4 corners)
//   grad_pos[b, p, k] = (sum_corner u[corner] * <g, feat[corner]>,
//                        sum_corner v[corner] * <g, feat[corner]>)
// with the coefficients [w4 | u4 | v4] of ops/deform.py::prep_indices_bwd
// (lerp weight, d/dy, d/dx per corner; clamp-match cases applied), which
// the kernel computes itself from the positions (tap_coeffs.h::
// tap_coeffs_bwd, held against prep_indices_bwd bit for bit on the CPU):
// a call is one launch, and no starts or coefficients pass through device
// memory.
//
// What bounds it on the H100: bytes, by the count of what must move: g is
// read once (178 MB at B=2, P=1050, 83 taps, 512 channels, bf16), the 2 MB
// map and the 4 MB f32 gradient map live in L2. What it really waits on is
// the scatter: on the TPU the grid runs in order and the gradient slab
// stays resident from step to step; here blocks run in any order, so the
// scatter-add goes through atomics. In the cascade 87,150 taps an image
// land on 1,050 pixels, about 330 adds on every address.
//
// What the design does about it, two bodies chosen per shape by the
// launcher, both fed positions the way the column gathers are
// (deform_gather.cuh): lane l of a warp computes the coefficients of tap l
// of a 32-tap chunk, and the warp, its lanes spread over channels so that no
// two of them ever add to one address, fetches a tap's values from their
// owner by shuffle.
// - Atomic body (any shape, any channel count and alignment): the first
//   port's arithmetic, a warp a tap with float4 atomicAdds into grad_feat in
//   L2 and shuffles for grad_pos, which it stores.
// - Slab body (from 64 adds an address of grad_feat, 16 taps a pixel of the
//   map; 16-byte aligned operands; map rows that fit). A block owns (image,
//   slice of 64 channels, band of map rows, every splits-th chunk of taps)
//   and keeps the band's slice of grad_feat in shared memory as f32. Lane l
//   finds its tap's two map rows from the y coordinate alone
//   (tap_coeffs.h::axis_start, ~15 instructions) and drops the tap unless a
//   row lies in the band; the warp then takes the band's taps one by one,
//   a lane reading its two channels of g (asked for from L2 ahead, a line a
//   tap) and of the band's corners and adding w * g to the slab with one
//   64-bit compare-and-swap a corner; its part of the two dot products
//   (its slice, its band's corners) goes to grad_pos by one global float2
//   atomicAdd a tap. The slab leaves with one float4 atomicAdd an element,
//   zeros skipped: 2 M of them in the cascade, where the atomic body sends
//   89 M. The cascade's 25x42 map is 3 bands of 10 rows (107 KB, two blocks
//   an SM), 8 slices, 2 images, 6 splits: 288 blocks. grad_pos by atomics
//   and not by a second walk: a second walk reads g (178 MB) again.
// What was measured (NVIDIA H100 80GB HBM3, 700 W, bf16, batch 2,
// tools/bwd_regimes.py: fill, kernel and cast of a call, taps spread
// uniformly / near their own pixel): cascade slab 0.63 / 0.71 ms, atomic
// body 0.84 / 0.92; the serial family's 100x168 level slab 1.43 / 1.38,
// atomic body 0.90 / 0.87; its 25x42 level 0.070 / 0.067 against 0.063 /
// 0.066. The slab's time hardly depends on where the taps are: it goes
// into issuing instructions, about half of them the compare-and-swap loops
// (the card has no f32 add on shared memory: atomicAdd there compiles to
// such a loop too), the rest handing a tap's coefficients round the warp
// and testing the taps of other bands; the atomic body's goes into L2's
// adds, about 90 G float4 adds a second and fewer where they collide. So
// the launcher takes the slab only where many taps land on a pixel. Two
// designs that measured worse and went: a thread a tap over a slice of 8
// channels (32 adds of one lane a tap, and
// taps of one pixel colliding inside a warp: 3.5 ms a call in the cascade's
// train step), and contiguous runs of chunks a warp (a band's taps are
// consecutive chunks, so one warp of sixteen did the band's work: 8.9 ms at
// the 100x168 level).
// KGDET_BWD_REGIME=1 on nvcc's command line compiles the atomic body for
// every shape, =2 the slab wherever its bands fit; tools/bwd_regimes.py
// times the three builds side by side that way and nothing else sets it.
//
// Numerics: every product and sum in f32; grad_feat is accumulated in f32
// (the wrapper zeroes the buffer that holds grad_feat and grad_pos and
// casts grad_feat at the end, as the TPU wrapper does). The order of the
// shared-memory and global atomic adds changes from run to run, so both
// outputs are reproducible only to f32 rounding of their sums.
#include "deform_gather.cuh"

#ifndef KGDET_BWD_REGIME
// 0: body chosen per shape; 1: the atomic body always; 2: the slab wherever
// its bands fit, however few taps land on a pixel
#define KGDET_BWD_REGIME 0
#endif

namespace kgdet {
namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ----------------------------------------------------------- the atomic body
template <int V>
__device__ __forceinline__ void atomic_add_scaled(float* dst,
                                                  const float (&g)[V],
                                                  float w) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(g[i] * w, g[i + 1] * w, g[i + 2] * w,
                            g[i + 3] * w));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) atomicAdd(dst + i, g[i] * w);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kTapThreads)
deform_bwd_atomic_kernel(const T* __restrict__ feat,
                         const float* __restrict__ pos,
                         const T* __restrict__ g, float* __restrict__ gfeat,
                         float* __restrict__ gpos, int H, int W, int C, int P,
                         int K) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int HW = H * W;
  const unsigned taps_image = (unsigned)P * (unsigned)K;
  const unsigned chunks = (taps_image + 31) / 32;
  const T* fb = feat + (size_t)b * HW * C;
  float* gb = gfeat + (size_t)b * HW * C;
  const size_t image0 = (size_t)b * taps_image;

  for (unsigned ch = blockIdx.x * kTapWarps + (threadIdx.x >> 5); ch < chunks;
       ch += gridDim.x * kTapWarps) {
    const unsigned q0 = ch * 32;
    const int n = (int)min(32u, taps_image - q0);  // live taps of the chunk
    const size_t bq = image0 + min(q0 + lane, taps_image - 1);
    int my_r0, my_r1;
    float my_wd[12];
    tap_coeffs_bwd(__ldg(pos + 2 * bq), __ldg(pos + 2 * bq + 1), H, W, my_r0,
                   my_r1, my_wd);
    float my_ay = 0.f, my_ax = 0.f;
    for (int t = 0; t < n; ++t) {
      const int r0 = __shfl_sync(kFullMask, my_r0, t);
      const int r1 = __shfl_sync(kFullMask, my_r1, t);
      float wd[12];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        wd[i] = __shfl_sync(kFullMask, my_wd[i], t);
        any = any || wd[i] != 0.f;
      }
      if (!any) continue;  // every corner out of bounds: moves nothing
      const T* gq = g + (image0 + q0 + t) * C;
      const int rows[4] = {r0, r0 + 1, r1, r1 + 1};
      float ay = 0.f, ax = 0.f;
      for (int c = lane * V; c < C; c += 32 * V) {
        float f[4][V];
        load_corners<T, V>(fb, C, r0, r1, c, f);
        const Pack<T, V> gv = load_pack<T, V>(gq + c);
        float gf[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          gf[i] = to_f32(gv.v[i]);
          ay += gf[i] * (f[0][i] * wd[4] + f[1][i] * wd[5] + f[2][i] * wd[6] +
                         f[3][i] * wd[7]);
          ax += gf[i] * (f[0][i] * wd[8] + f[1][i] * wd[9] +
                         f[2][i] * wd[10] + f[3][i] * wd[11]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (wd[j] != 0.f)
            atomic_add_scaled<V>(gb + (size_t)rows[j] * C + c, gf, wd[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ay += __shfl_xor_sync(kFullMask, ay, o);
        ax += __shfl_xor_sync(kFullMask, ax, o);
      }
      if (lane == t) {
        my_ay = ay;
        my_ax = ax;
      }
    }
    if (lane < n) {
      gpos[2 * bq] = my_ay;
      gpos[2 * bq + 1] = my_ax;
    }
  }
}

// ------------------------------------------------------------- the slab body
constexpr int kSlabThreads = 512;
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kSlabChannels = 64;  // channels a block owns: two a lane
constexpr int kMaxBands = 32;      // past this a band is too thin to pay
constexpr size_t kSlabTarget = 110 * 1024;  // two blocks an SM
constexpr size_t kSlabLimit = 227 * 1024;   // what one block can be given
// The slab pays where many taps land on a pixel: its time does not depend on
// that, the atomic body's L2 adds collide the more. Adds on an address of
// grad_feat, 4 * taps / pixels, from which the slab is taken: it measured
// level at 36 (25x42 map, 9 taps a pixel) and 1.3x ahead at 332 (the
// cascade), behind below (tools/bwd_regimes.py).
constexpr long long kSlabAddsPerAddress = 64;

// Two consecutive channels as f32; kStream marks data read once (g).
template <bool kStream>
__device__ __forceinline__ float2 load2(const float* p) {
  const float2* q = reinterpret_cast<const float2*>(p);
  return kStream ? __ldcs(q) : __ldg(q);
}

template <bool kStream>
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  const unsigned raw = kStream ? __ldcs(q) : __ldg(q);
  // bf16 is the high half of an f32
  return make_float2(__uint_as_float(raw << 16),
                     __uint_as_float(raw & 0xffff0000u));
}

// slab[0] += a, slab[1] += b as one 64-bit compare-and-swap: the card has no
// native f32 add on shared memory (the compiler would emit one such loop a
// float), and a lane's two channels sit side by side.
__device__ __forceinline__ void slab_add2(float* addr, float a, float b) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(p);
  unsigned long long assumed;
  do {
    assumed = old;
    const float lo = __uint_as_float(static_cast<unsigned>(assumed)) + a;
    const float hi = __uint_as_float(static_cast<unsigned>(assumed >> 32)) + b;
    const unsigned long long next =
        (static_cast<unsigned long long>(__float_as_uint(hi)) << 32) |
        __float_as_uint(lo);
    old = atomicCAS(p, assumed, next);
  } while (old != assumed);
}

template <typename T>
__global__ void __launch_bounds__(kSlabThreads)
deform_bwd_slab_kernel(const T* __restrict__ feat,
                       const float* __restrict__ pos, const T* __restrict__ g,
                       float* __restrict__ gfeat, float* __restrict__ gpos,
                       int H, int W, int C, int P, int K, int band_rows,
                       int splits) {
  extern __shared__ __align__(16) float slab[];  // [band pixel][64 channels]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slices = (C + kSlabChannels - 1) / kSlabChannels;
  const int slice = blockIdx.x % slices;
  const int split = blockIdx.x / slices;
  const int yb0 = blockIdx.y * band_rows;
  const int yb1 = min(H, yb0 + band_rows);
  const int b = blockIdx.z;
  const int lo = yb0 * W;             // first map row (flattened) of the band
  const int live = (yb1 - yb0) * W;   // pixels of this band
  const int c = slice * kSlabChannels + 2 * lane;  // this lane's two channels
  const bool active = c < C;
  for (int i = tid; i < live * kSlabChannels; i += kSlabThreads) slab[i] = 0.f;
  __syncthreads();

  const unsigned taps_image = (unsigned)P * (unsigned)K;
  const unsigned chunks = (taps_image + 31) / 32;
  const T* fb = feat + (size_t)b * H * W * C + c;
  const T* gb = g + (size_t)b * taps_image * C + c;
  const float* pb = pos + (size_t)b * taps_image * 2;
  float* gpb = gpos + (size_t)b * taps_image * 2;

  // chunks are dealt round to the blocks that share (image, slice, band),
  // then to a block's warps: a band's taps are consecutive chunks (pixels
  // come row by row), and a contiguous run would leave them all to one warp
  for (unsigned ch = split + (unsigned)splits * warp; ch < chunks;
       ch += (unsigned)splits * kSlabWarps) {
    // lane l: is tap l of the chunk in the band, and if so its coefficients
    const unsigned q = ch * 32 + lane;
    int my_r0 = 0, my_r1 = 0;
    unsigned my_in = 0;  // bit 0: the top corners are the band's, bit 1: bottom
    float my_wd[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) my_wd[i] = 0.f;
    if (q < taps_image) {
      const float y = __ldg(pb + 2 * q);
      const int y0 = static_cast<int>(axis_start(floorf(y), H));
      const bool top_in = y0 >= yb0 && y0 < yb1;
      const bool bot_in = y0 + 1 >= yb0 && y0 + 1 < yb1;
      if (top_in || bot_in) {
        tap_coeffs_bwd(y, __ldg(pb + 2 * q + 1), H, W, my_r0, my_r1, my_wd);
        bool any = false;  // a corner of the band's with a live coefficient
#pragma unroll
        for (int j = 0; j < 4; ++j)
          any = any || ((j < 2 ? top_in : bot_in) &&
                        (my_wd[j] != 0.f || my_wd[4 + j] != 0.f ||
                         my_wd[8 + j] != 0.f));
        if (any) {
          my_in = (top_in ? 1u : 0u) | (bot_in ? 2u : 0u);
          // g comes from device memory: ask for every tap's line now, the
          // warp reads them one tap at a time below
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              g + ((size_t)b * taps_image + q) * C + slice * kSlabChannels));
        }
      }
    }
    unsigned todo = __ballot_sync(kFullMask, my_in != 0);
    while (todo) {  // the warp takes the band's taps one by one
      const int t = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r0 = __shfl_sync(kFullMask, my_r0, t);
      const int r1 = __shfl_sync(kFullMask, my_r1, t);
      const unsigned in = __shfl_sync(kFullMask, my_in, t);
      float wd[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) wd[i] = __shfl_sync(kFullMask, my_wd[i], t);
      const unsigned qt = ch * 32 + t;
      const int rows[4] = {r0, r0 + 1, r1, r1 + 1};
      float ay = 0.f, ax = 0.f;
      if (active) {
        const float2 gv = load2<true>(gb + (size_t)qt * C);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(in & (j < 2 ? 1u : 2u))) continue;
          if (wd[j] == 0.f && wd[4 + j] == 0.f && wd[8 + j] == 0.f) continue;
          const float2 f = load2<false>(fb + (size_t)rows[j] * C);
          const float dot = gv.x * f.x + gv.y * f.y;
          ay += wd[4 + j] * dot;
          ax += wd[8 + j] * dot;
          if (wd[j] != 0.f)
            slab_add2(slab + (size_t)(rows[j] - lo) * kSlabChannels + 2 * lane,
                      gv.x * wd[j], gv.y * wd[j]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ay += __shfl_xor_sync(kFullMask, ay, o);
        ax += __shfl_xor_sync(kFullMask, ax, o);
      }
      if (lane == 0)
        atomicAdd(reinterpret_cast<float2*>(gpb + 2 * (size_t)qt),
                  make_float2(ay, ax));
    }
  }
  __syncthreads();

  // the slab into grad_feat: one float4 add an element, zeros skipped
  float* out = gfeat + ((size_t)b * H * W + lo) * C + slice * kSlabChannels;
  const int width = min(kSlabChannels, C - slice * kSlabChannels) / 4;
  for (int i = tid; i < live * (kSlabChannels / 4); i += kSlabThreads) {
    const int pix = i / (kSlabChannels / 4);
    const int k4 = i % (kSlabChannels / 4);
    if (k4 >= width) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(slab + pix * kSlabChannels + 4 * k4);
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(out + (size_t)pix * C + 4 * k4), v);
  }
}

// Rows of the map a band holds within `limit` bytes of shared memory, and
// the bands that makes; false where not one row fits or the bands are too
// many.
bool plan_bands(size_t limit, int H, int W, int& band_rows, int& bands) {
  const size_t row_bytes = (size_t)W * kSlabChannels * sizeof(float);
  const size_t rows = limit / row_bytes;
  if (rows < 1) return false;
  band_rows = static_cast<int>(rows > (size_t)H ? H : rows);
  bands = (H + band_rows - 1) / band_rows;
  return bands <= kMaxBands;
}

template <typename T>
cudaError_t launch(const void* feat, const void* pos, const void* g,
                   void* gfeat, void* gpos, int B, int H, int W, int C, int P,
                   int K, int vec, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || K <= 0 || C <= 0) return cudaSuccess;  // no tap
  const long long taps_image = (long long)P * K;
  if (B > 65535 || taps_image >= (1LL << 31)) return cudaErrorInvalidValue;
  const T* f = static_cast<const T*>(feat);
  const float* ps = static_cast<const float*>(pos);
  const T* gp = static_cast<const T*>(g);
  float* gf = static_cast<float*>(gfeat);
  float* gpo = static_cast<float*>(gpos);

  // the slab body where bands of map rows, 64 channels wide, fit
  int band_rows = 0, bands = 0;
  if (KGDET_BWD_REGIME != 1 && vec &&
      (KGDET_BWD_REGIME == 2 ||
       4 * taps_image >= kSlabAddsPerAddress * H * W) &&
      (plan_bands(kSlabTarget, H, W, band_rows, bands) ||
       plan_bands(kSlabLimit, H, W, band_rows, bands))) {
    const size_t smem =
        (size_t)band_rows * W * kSlabChannels * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        deform_bwd_slab_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(deform_bwd_slab_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    // enough blocks for two an SM, by dealing the image's chunks of 32 taps
    // to `splits` blocks, at least two chunks a warp
    const long long slices = (C + kSlabChannels - 1) / kSlabChannels;
    const long long base = slices * bands * B;
    const long long chunks = (taps_image + 31) / 32;
    long long splits = (2LL * sm_count() + base - 1) / base;
    const long long most = chunks / (2 * kSlabWarps);
    if (splits > most) splits = most;
    if (splits < 1) splits = 1;
    const dim3 grid(static_cast<unsigned>(slices * splits), bands, B);
    deform_bwd_slab_kernel<T><<<grid, kSlabThreads, smem, stream>>>(
        f, ps, gp, gf, gpo, H, W, C, P, K, band_rows,
        static_cast<int>(splits));
    return cudaGetLastError();
  }

  const long long want = (taps_image + 32 * kTapWarps - 1) / (32 * kTapWarps);
  long long cap = (long long)sm_count() * KGDET_GATHER_BLOCKS_PER_SM / B;
  if (cap < 1) cap = 1;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap), B, 1);
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    deform_bwd_atomic_kernel<T, V><<<grid, kTapThreads, 0, stream>>>(
        f, ps, gp, gf, gpo, H, W, C, P, K);
  } else {
    deform_bwd_atomic_kernel<T, 1><<<grid, kTapThreads, 0, stream>>>(
        f, ps, gp, gf, gpo, H, W, C, P, K);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace kgdet

// feat (B, H*W, C) T with H, W >= 2; pos (B, P, K, 2) f32 absolute (y, x);
// g (B, P, K, C) T; gfeat (B, H*W, C) f32 and gpos (B, P, K, 2) f32, 8-byte
// aligned, both zeroed by the caller. vec != 0 promises C % (16 / sizeof(T))
// == 0 and 16-byte aligned feat, g and gfeat. Returns a cudaError_t.
extern "C" int kgdet_deform_bwd(const void* feat, const void* pos,
                                const void* g, void* gfeat, void* gpos, int B,
                                int H, int W, int C, int P, int K, int vec,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kgdet::kF32)
    return static_cast<int>(kgdet::launch<float>(feat, pos, g, gfeat, gpos, B,
                                                 H, W, C, P, K, vec, s));
  if (dtype == kgdet::kBF16)
    return static_cast<int>(kgdet::launch<__nv_bfloat16>(
        feat, pos, g, gfeat, gpos, B, H, W, C, P, K, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
