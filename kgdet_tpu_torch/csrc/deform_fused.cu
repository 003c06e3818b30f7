// K1: fused deformable gather + contraction.
//
// Replaces kgdet_tpu/ops/pallas_deform.py::_fused_kernel (tap walk
// _gather_tile): out[b,p,:] = sum_k sum_c bilinear(feat[b], pos[b,p,k])[c]
// * W[k,c,:], with the sampled columns never written to device memory. As a
// matrix product: M = B*P rows, depth K*C, N = F, the left operand gathered
// on the fly.
//
// The kernel takes the absolute positions and does the index math of
// ops/deform.py::prep_indices itself (tap_coeffs.h, held against it bit for
// bit on the CPU): once a tap and pixel, by the first threads of the block
// into shared memory. A call is one launch; no starts or weights pass
// through device memory.
//
// What bounds it on the H100: operations, by the count (the cascade's
// 49-tap column is 13.5 GFLOP a call over 7 MB of operands). What it really
// waits on is the operands' way into the SM: a tile of BM pixels by BN
// output channels reads, per tap and channel, 8 bytes of corners a pixel
// and 2 bytes of weight an output channel from L2, BM * BN / (BN + 4 * BM)
// operations a byte. The first port ran 64 x 64 tiles (13 operations a
// byte) on the FMA pipes with f32 operands in shared memory and a
// __syncthreads pair every 32 channels: 10.96 ms for the cascade's twelve
// calls against a 0.094 ms bound.
//
// What the design does about it, two bodies chosen by dtype:
// - bf16 maps (the main path; channel counts multiples of 8, 16-byte
//   aligned operands): the product runs on the tensor cores. The gathered
//   tile is rounded to bf16 by the kernel's numerics anyway, so bf16
//   operands with f32 accumulation lose nothing. A block of 8 warps owns BM
//   pixels x 128 output channels and walks the depth in steps of one tap x
//   64 channels through a two-stage ring in shared memory: the step's
//   weight slice arrives by cp.async (16 bytes, zero-filled past C and F),
//   its corners by four 16-byte loads a thread that stay in registers while
//   the current step's mma.sync.m16n8k16 products run from the other stage
//   (operands by ldmatrix from rows padded by 16 bytes, which keeps the
//   eight rows of a matrix on distinct banks), and are lerped, rounded and
//   stored after it: one __syncthreads a step, loads and products
//   overlapped. BM is 64 (warps 2 x 4, 32 x 32 each) where that gives every
//   SM two blocks, else 32 (16 x 32 a warp): the cascade's 2 x 1,050 pixels
//   make 132 blocks of 32 x 128, one an SM. The depth is not split, so a
//   call is one kernel and its sums have one order. Measured (NVIDIA H100
//   80GB HBM3, 700 W, bf16, batch 2, chip_smoke.py's served-batch profile):
//   the cascade's twelve launches 1.42 ms (128 and 74 registers, no spill),
//   about 65 TFLOP/s, the serial family's ten 0.99 ms; what is left is the
//   operands' way from L2 (16 to 21 operations a byte), not the tensor
//   cores, for which wgmma with wider tiles and a split depth is the next
//   step.
// - f32 maps (the CPU-parity dtype) and bf16 maps the first body does not
//   take: the first port's 64 x 64 FMA tile in full f32; TF32 would break
//   the 1e-5 hold against the plain version.
//
// Numerics follow the TPU kernel: corner lerp in f32, each sample rounded
// to the feature dtype (the TPU gather scratch is feat.dtype), contraction
// accumulated in f32, output rounded to the feature dtype.
#include "deform_gather.cuh"

namespace kgdet {
namespace {

// ------------------------------------------------------------- the FMA body
constexpr int kThreads = 256;
constexpr int kTP = 64;       // pixels per block
constexpr int kTF = 64;       // output channels per block
constexpr int kTC = 32;       // channel chunk per step
constexpr int kLdA = kTP + 4; // padded row of the sample tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_fused_fma_kernel(const T* __restrict__ feat,
                        const float* __restrict__ pos,
                        const T* __restrict__ weight, T* __restrict__ out,
                        int H, int W, int C, int P, int K, int F) {
  __shared__ __align__(16) float As[kTC * kLdA];  // samples, [c][p]
  __shared__ __align__(16) float Ws[kTC * kTF];   // weight slice, [c][f]
  __shared__ int s_r0[kTP];
  __shared__ int s_r1[kTP];
  __shared__ float s_w[kTP][4];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTP;
  const int f0 = blockIdx.y * kTF;
  const int b = blockIdx.z;
  const T* fb = feat + (size_t)b * H * W * C;

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
      int r0 = 0, r1 = 0;
      float w4[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < P) {
        const float* pq = pos + (((size_t)b * P + p) * K + k) * 2;
        tap_coeffs(pq[0], pq[1], H, W, r0, r1, w4);
      }
      s_r0[tid] = r0;
      s_r1[tid] = r1;
#pragma unroll
      for (int j = 0; j < 4; ++j) s_w[tid][j] = w4[j];
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

// ----------------------------------------------------- the tensor-core body
using bf16 = __nv_bfloat16;

constexpr int kBN = 128;          // output channels a block
constexpr int kBK = 64;           // channels a step
constexpr int kLdAs = kBK + 8;    // sample tile row, padded by 16 bytes
constexpr int kLdBs = kBN + 8;    // weight tile row, padded by 16 bytes

template <int BM>
struct MmaSmem {
  bf16 a[2][BM * kLdAs];      // samples, [pixel][channel]
  bf16 w[2][kBK * kLdBs];     // weight slice, [channel][output channel]
  int r0[2][BM];              // per tap parity: row starts and lerp weights
  int r1[2][BM];
  float w4[2][BM][4];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 bf16x2_to_f32(unsigned v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ unsigned f32_to_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
deform_fused_mma_kernel(const bf16* __restrict__ feat,
                        const float* __restrict__ pos,
                        const bf16* __restrict__ weight,
                        bf16* __restrict__ out, int H, int W, int C, int P,
                        int K, int F) {
  constexpr int MI = BM / 32;                // m16 tiles a warp
  constexpr int NI = BM * (kBK / 8) / kThreads;  // (pixel, pack) items a thread
  static_assert(MI >= 1 && NI >= 1, "tile too small for the block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<BM>& sm = *reinterpret_cast<MmaSmem<BM>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // warp grid 2 (pixels) x 4 (output channels)
  const int wn = warp & 3;
  const int p0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const bf16* fb = feat + (size_t)b * H * W * C;
  const int chunks = (C + kBK - 1) / kBK;
  const int steps = K * chunks;

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the coefficients of tap k for the tile's pixels, into parity k & 1
  auto coeffs = [&](int k) {
    if (tid < BM) {
      const int p = p0 + tid;
      int r0 = 0, r1 = 0;
      float w4[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < P) {
        const float* pq = pos + (((size_t)b * P + p) * K + k) * 2;
        tap_coeffs(__ldg(pq), __ldg(pq + 1), H, W, r0, r1, w4);
      }
      sm.r0[k & 1][tid] = r0;
      sm.r1[k & 1][tid] = r1;
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.w4[k & 1][tid][j] = w4[j];
    }
  };

  // a step's weight slice: 64 x 128 bf16 in 16-byte pieces, 4 a thread
  auto weights_fetch = [&](int s, int stage) {
    const int k = s / chunks;
    const int c0 = (s - k * chunks) * kBK;
#pragma unroll
    for (int i = 0; i < kBK * (kBN / 8) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 8);
      const int piece = idx % (kBN / 8);
      const int c = c0 + r;
      const int f = f0 + piece * 8;
      const bool ok = c < C && f < F;
      const bf16* src = ok ? weight + ((size_t)k * C + c) * F + f : weight;
      cp_async16(&sm.w[stage][r * kLdBs + piece * 8], src, ok ? 16 : 0);
    }
  };

  // a step's corners: item (pixel, 8-channel pack), 4 x 16 bytes in flight
  uint4 corner[NI][4];
  float lerp[NI][4];
  auto gather_fetch = [&](int s) {
    const int k = s / chunks;
    const int c0 = (s - k * chunks) * kBK;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int idx = tid + i * kThreads;
      const int pl = idx / (kBK / 8);
      const int c = c0 + (idx % (kBK / 8)) * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) lerp[i][j] = sm.w4[k & 1][pl][j];
      if (c < C) {  // a pixel past P has zero weights and row starts 0
        const bf16* top = fb + (size_t)sm.r0[k & 1][pl] * C + c;
        const bf16* bot = fb + (size_t)sm.r1[k & 1][pl] * C + c;
        corner[i][0] = __ldg(reinterpret_cast<const uint4*>(top));
        corner[i][1] = __ldg(reinterpret_cast<const uint4*>(top + C));
        corner[i][2] = __ldg(reinterpret_cast<const uint4*>(bot));
        corner[i][3] = __ldg(reinterpret_cast<const uint4*>(bot + C));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) corner[i][j] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  // lerp in f32, round once to bf16, store the tile row piece
  auto gather_store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int idx = tid + i * kThreads;
      const int pl = idx / (kBK / 8);
      const int piece = idx % (kBK / 8);
      const unsigned* tl = reinterpret_cast<const unsigned*>(&corner[i][0]);
      const unsigned* tr = reinterpret_cast<const unsigned*>(&corner[i][1]);
      const unsigned* bl = reinterpret_cast<const unsigned*>(&corner[i][2]);
      const unsigned* br = reinterpret_cast<const unsigned*>(&corner[i][3]);
      unsigned packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = bf16x2_to_f32(tl[e]), c = bf16x2_to_f32(tr[e]);
        const float2 d = bf16x2_to_f32(bl[e]), g = bf16x2_to_f32(br[e]);
        const float lo = a.x * lerp[i][0] + c.x * lerp[i][1] +
                         d.x * lerp[i][2] + g.x * lerp[i][3];
        const float hi = a.y * lerp[i][0] + c.y * lerp[i][1] +
                         d.y * lerp[i][2] + g.y * lerp[i][3];
        packed[e] = f32_to_bf16x2(lo, hi);
      }
      *reinterpret_cast<uint4*>(&sm.a[stage][pl * kLdAs + piece * 8]) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  };

  // prologue: tap 0 (and tap 1, when a tap is one step), step 0 into stage 0
  coeffs(0);
  if (chunks == 1 && K > 1) coeffs(1);
  __syncthreads();
  weights_fetch(0, 0);
  gather_fetch(0);
  gather_store(0);
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      weights_fetch(s + 1, cur ^ 1);
      gather_fetch(s + 1);
    }
    // the tap of step s + 2, when it is a new one: its parity's last reader
    // was the gather of a step before s + 1
    if (s + 2 < steps && (s + 2) % chunks == 0) coeffs((s + 2) / chunks);

    const bf16* as = sm.a[cur];
    const bf16* ws = sm.w[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned afrag[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm * (BM / 2) + mi * 16 + (lane & 7) +
                        ((lane >> 3) & 1) * 8;
        ldmatrix_x4(afrag[mi], as + row * kLdAs + kk + (lane >> 4) * 8);
      }
      unsigned bfrag[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn * 32 + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bfrag[nj], ws + krow * kLdBs + col);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], afrag[mi], bfrag[ni >> 1][(ni & 1) * 2],
                   bfrag[ni >> 1][(ni & 1) * 2 + 1]);
    }

    if (more) gather_store(cur ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: one rounding to bf16, two output channels a store
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int f = f0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (f >= F) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + wm * (BM / 2) + mi * 16 + (lane >> 2) + half * 8;
        if (p >= P) continue;
        *reinterpret_cast<unsigned*>(out + ((size_t)b * P + p) * F + f) =
            f32_to_bf16x2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

template <int BM>
cudaError_t launch_mma(const bf16* feat, const float* pos, const bf16* weight,
                       bf16* out, int B, int H, int W, int C, int P, int K,
                       int F, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(MmaSmem<BM>));
  cudaError_t err = cudaFuncSetAttribute(
      deform_fused_mma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + BM - 1) / BM, (F + kBN - 1) / kBN, B);
  deform_fused_mma_kernel<BM><<<grid, kThreads, smem, stream>>>(
      feat, pos, weight, out, H, W, C, P, K, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* feat, const void* pos, const void* weight,
                       void* out, int B, int H, int W, int C, int P, int K,
                       int F, cudaStream_t stream) {
  const dim3 grid((P + kTP - 1) / kTP, (F + kTF - 1) / kTF, B);
  deform_fused_fma_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(pos),
      static_cast<const T*>(weight), static_cast<T*>(out), H, W, C, P, K, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kgdet

// feat (B, H*W, C) T with H, W >= 2; pos (B, P, K, 2) f32 absolute (y, x);
// weight (K, C, F) T; out (B, P, F) T. vec != 0 promises C % (16 /
// sizeof(T)) == 0 and 16-byte aligned feat and weight. Returns a
// cudaError_t.
extern "C" int kgdet_deform_fused(const void* feat, const void* pos,
                                  const void* weight, void* out, int B, int H,
                                  int W, int C, int P, int K, int F, int vec,
                                  int dtype, void* stream) {
  using namespace kgdet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || P <= 0 || F <= 0) return 0;  // nothing to write
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return static_cast<int>(
        launch_fma<float>(feat, pos, weight, out, B, H, W, C, P, K, F, s));
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (!(vec && C % 8 == 0 && F % 8 == 0 && K > 0))
    return static_cast<int>(launch_fma<__nv_bfloat16>(feat, pos, weight, out,
                                                      B, H, W, C, P, K, F, s));
  const bf16* f = static_cast<const bf16*>(feat);
  const float* ps = static_cast<const float*>(pos);
  const bf16* w = static_cast<const bf16*>(weight);
  bf16* o = static_cast<bf16*>(out);
  // 64-pixel tiles where they give every SM two blocks, else 32-pixel ones
  const long long blocks64 =
      (long long)((P + 63) / 64) * ((F + kBN - 1) / kBN) * B;
  if (blocks64 >= 2LL * sm_count())
    return static_cast<int>(
        launch_mma<64>(f, ps, w, o, B, H, W, C, P, K, F, s));
  return static_cast<int>(launch_mma<32>(f, ps, w, o, B, H, W, C, P, K, F, s));
}
