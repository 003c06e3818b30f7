// The bilinear tap gather shared by the deformable sampling kernels.
//
// A tap (b, p, k) of a (B, HW, C) map has two clamped row starts
// [r_top, r_bottom]: its four corners are the rows r_top, r_top + 1,
// r_bottom, r_bottom + 1, in the order (tl, tr, bl, br). A lane handles V
// consecutive channels with one load per corner; V * sizeof(T) == 16 gives
// the 16-byte loads the card moves fastest, V == 1 takes any channel count
// and alignment.
//
// Two users. K3 (deform_bwd.cu) takes the packs, load_corners and the
// persistent grid's constants for its own walks. K6 (deform_sample.cu,
// replaces kgdet_tpu/ops/pallas_deform.py::_sample_kernel) and K2
// (deform_split.cu, replaces ::_split_kernel) are both `gather_columns`
// below: positions in, columns out, one launch a call.
//
// What bounds the column gather on the H100: bytes. It does 7 operations a
// sampled value and writes every one of them (155 to 178 MB of columns at
// the main-path shapes) while its 2 to 17 MB of maps stay in the 50 MB L2;
// every byte written costs four bytes of corner reads from L1 or L2.
// What the design does about it, with what each choice measured (NVIDIA
// H100 80GB HBM3 at 700 W, bf16, batch 2, device time of K6's ten launches
// of a serial train step / of one K2 call, taps near their own pixel, by
// tools/gather_tuning.py, which prints the whole table):
// - Coefficients in the kernel. A tap is 8 bytes of position in, not the 24
//   bytes of starts and weights that a torch prep pass (about 30 small
//   launches a call) wrote and the kernel read back: a call is one launch.
//   The math (tap_coeffs.h, about 100 instructions with the column lookup)
//   is as much work as the gather of one tap itself, so it is done once a
//   tap, not once a lane: a warp takes 32 consecutive taps, lane l computes
//   tap l (its position load is then coalesced), and the warp fetches a
//   tap's two row starts, four weights and destination rows from their
//   owner with 8 to 10 shuffles. Every lane computing every tap measured
//   slower than the kernels this design replaced.
// - Taps in flight. The warp goes through its chunk NT taps at a time: NT
//   sets of coefficients by shuffle, then the 4 * NT corner loads of a lane
//   (times two maps for K2), then the stores. With one map 16 independent
//   16-byte loads outstanding per lane beat 4: K6 0.281 ms at NT = 1, 0.263
//   at 2, 0.230 at 4. With two maps, 8 loads a tap, the registers that more
//   taps cost (over 200 a thread at NT = 4) take more occupancy than the
//   loads give back: K2 0.070 ms at NT = 1, 0.076 at 2, 0.085 at 4. So each
//   kernel names its own NT (4 and 1).
// - The map is read through the read-only path (ld.global.nc) and the
//   columns, written once and never read here, leave with streaming stores
//   (st.global.cs), so they are the first lines L2 gives up: K6 0.236 to
//   0.230 ms (2%), K2 0.079 to 0.070 ms (11%).
// - A persistent grid of 16 blocks of 256 threads an SM, image b in
//   blockIdx.y, warps striding over the image's chunks: 8, 16 and 32 blocks
//   an SM measure within 1% of each other. A tap costs its lane one 32-bit
//   division and no 64-bit one.
// These choices are constants here. tools/gather_tuning.py measures the
// others by compiling the two sources again with the KGDET_GATHER_* macros
// below set on nvcc's command line; nothing else sets them.
// - The columns' layout (K2: three columns, two branches, six tensors in one
//   buffer) travels by value in the kernel's parameters, which every warp
//   reads from the constant bank: no table in device memory, no dependent
//   load per tap.
// Where the taps are matters more than any of these: spread uniformly over
// the map (no two taps share a corner, every corner read goes to L2) the
// same launches take 0.297 ms (K6) and 0.089 ms (K2).
//
// Numerics follow the TPU kernels: four-corner sum in f32 with f32 weights,
// one rounding to the map's dtype.
#pragma once

#include <string.h>

#include "common.cuh"
#include "tap_coeffs.h"

#ifndef KGDET_GATHER_BLOCKS_PER_SM
#define KGDET_GATHER_BLOCKS_PER_SM 16  // persistent grid, blocks of 256
#endif
#ifndef KGDET_GATHER_PLAIN_STORES
#define KGDET_GATHER_PLAIN_STORES 0  // 1: ordinary stores, not streaming
#endif

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

// Warps of a launch walk the taps of an image in chunks of 32.
constexpr int kTapThreads = 256;
constexpr int kTapWarps = kTapThreads / 32;

// SMs of the current device, asked once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// ------------------------------------------------- the column gather (K6, K2)

// A pack moved as one machine word, so that the cache-hinted load and store
// intrinsics take it: 16 bytes (the vector path), 4 or 2 (one f32 / bf16).
template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// Read-only path: the maps are never written by these kernels.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ldg_pack(const T* p) {
  using W = typename Word<sizeof(T) * V>::type;
  const W raw = __ldg(reinterpret_cast<const W*>(p));
  Pack<T, V> out;
  memcpy(&out, &raw, sizeof(out));
  return out;
}

// Evict-first store of a value written once and not read here.
template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& v) {
  using W = typename Word<sizeof(T) * V>::type;
  W raw;
  memcpy(&raw, &v, sizeof(raw));
#if KGDET_GATHER_PLAIN_STORES
  *reinterpret_cast<W*>(p) = raw;
#else
  __stcs(reinterpret_cast<W*>(p), raw);
#endif
}

// The bilinear sample of V channels from the four loaded corner packs.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> lerp_pack(const Pack<T, V> (&f)[4],
                                                const float (&w)[4]) {
  Pack<T, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i)
    out.v[i] = from_f32<T>(to_f32(f[0].v[i]) * w[0] + to_f32(f[1].v[i]) * w[1] +
                           to_f32(f[2].v[i]) * w[2] + to_f32(f[3].v[i]) * w[3]);
  return out;
}

// Where the sampled taps go. The K taps of a pixel are cut into `n` columns
// of taps[i] taps starting at tap first[i]; column i of map m is a
// contiguous (B, P, taps[i], C) tensor at element offset off[m][i] of the
// output buffer. Passed by value (ops/_build.py::ColumnTable mirrors it).
constexpr int kMaxColumns = 8;
struct ColumnTable {
  int n;
  int first[kMaxColumns];
  int taps[kMaxColumns];
  long long off[2][kMaxColumns];
};

// Everything a launch is given, by value in the kernel's parameters.
template <typename T, int MAPS>
struct GatherArgs {
  const T* maps[MAPS];  // (B, H*W, C) each
  const float* pos;     // (B, P, K, 2) f32 absolute (y, x)
  T* out;               // the buffer that holds every column tensor
  ColumnTable tab;
  int H, W, C, P, K;
};

// The walk of one image (blockIdx.y) by the warps of the grid's x dimension.
// The P * K taps of the image are cut into chunks of 32 consecutive taps,
// and the warps stride over the chunks. A warp takes a chunk: lane l
// computes the coefficients and the destination rows of tap l, then the
// warp goes through the chunk NT taps at a time, every lane fetching a
// tap's values from its owner by shuffle and covering C in packs of V.
template <typename T, int V, int NT, int MAPS>
__device__ __forceinline__ void gather_columns(const GatherArgs<T, MAPS>& a) {
  constexpr unsigned kFull = 0xffffffffu;
  const float* __restrict__ pos = a.pos;
  T* __restrict__ out = a.out;
  const ColumnTable& tab = a.tab;
  const int H = a.H, W = a.W, C = a.C, K = a.K;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const unsigned taps_image = (unsigned)a.P * (unsigned)K;
  const unsigned chunks = (taps_image + 31) / 32;
  const T* fb[MAPS];
#pragma unroll
  for (int m = 0; m < MAPS; ++m) fb[m] = a.maps[m] + (size_t)b * H * W * C;

  for (unsigned ch = blockIdx.x * kTapWarps + (threadIdx.x >> 5); ch < chunks;
       ch += gridDim.x * kTapWarps) {
    const unsigned q0 = ch * 32;
    const int n = (int)min(32u, taps_image - q0);  // live taps of the chunk
    // lane l: tap q0 + l of the image, pixel p, tap k of the pixel
    const unsigned q = min(q0 + lane, taps_image - 1);
    const unsigned p = q / (unsigned)K;
    const int k = (int)(q - p * (unsigned)K);
    const long long bp = (long long)b * a.P + p;
    const float* pq = pos + (bp * K + k) * 2;
    int my_r0, my_r1;
    float my_w[4];
    tap_coeffs(__ldg(pq), __ldg(pq + 1), H, W, my_r0, my_r1, my_w);
    int first = 0, taps = tab.taps[0];
    long long my_dst[MAPS];
#pragma unroll
    for (int m = 0; m < MAPS; ++m) my_dst[m] = tab.off[m][0];
#pragma unroll
    for (int i = 1; i < kMaxColumns; ++i)
      if (i < tab.n && k >= tab.first[i]) {
        first = tab.first[i];
        taps = tab.taps[i];
#pragma unroll
        for (int m = 0; m < MAPS; ++m) my_dst[m] = tab.off[m][i];
      }
    const long long row = (bp * taps + (k - first)) * C;
#pragma unroll
    for (int m = 0; m < MAPS; ++m) my_dst[m] += row;

    for (int t0 = 0; t0 < n; t0 += NT) {
      int r0[NT], r1[NT];
      float w[NT][4];
      long long dst[MAPS][NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int src = min(t0 + t, 31);
        r0[t] = __shfl_sync(kFull, my_r0, src);
        r1[t] = __shfl_sync(kFull, my_r1, src);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[t][j] = __shfl_sync(kFull, my_w[j], src);
#pragma unroll
        for (int m = 0; m < MAPS; ++m)
          dst[m][t] = __shfl_sync(kFull, my_dst[m], src);
      }
      for (int c = lane * V; c < C; c += 32 * V) {
#pragma unroll
        for (int m = 0; m < MAPS; ++m) {
          Pack<T, V> f[NT][4];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const T* top = fb[m] + (size_t)r0[t] * C + c;
            const T* bot = fb[m] + (size_t)r1[t] * C + c;
            f[t][0] = ldg_pack<T, V>(top);
            f[t][1] = ldg_pack<T, V>(top + C);
            f[t][2] = ldg_pack<T, V>(bot);
            f[t][3] = ldg_pack<T, V>(bot + C);
          }
#pragma unroll
          for (int t = 0; t < NT; ++t)
            if (t0 + t < n)
              store_pack<T, V>(out + dst[m][t] + c,
                               lerp_pack<T, V>(f[t], w[t]));
        }
      }
    }
  }
}

// Launches Kernel::run<V>(grid, stream, args), a __global__ function around
// gather_columns: picks the pack width from `vec` and the persistent grid.
// Returns cudaErrorInvalidValue for what the walk cannot index.
template <typename T, int MAPS, typename Kernel>
cudaError_t launch_gather(GatherArgs<T, MAPS> a, int B, int vec,
                          cudaStream_t stream) {
  if (a.tab.n < 1 || a.tab.n > kMaxColumns) return cudaErrorInvalidValue;
  if (B <= 0 || a.P <= 0 || a.K <= 0) return cudaSuccess;  // no tap
  const long long taps_image = (long long)a.P * a.K;
  if (B > 65535 || taps_image >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long want = (taps_image + 32 * kTapWarps - 1) / (32 * kTapWarps);
  long long cap = (long long)sm_count() * KGDET_GATHER_BLOCKS_PER_SM / B;
  if (cap < 1) cap = 1;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap), B, 1);

  if (vec) {
    Kernel::template run<static_cast<int>(16 / sizeof(T))>(grid, stream, a);
  } else {
    Kernel::template run<1>(grid, stream, a);
  }
  return cudaGetLastError();
}

}  // namespace kgdet
