// K9: hard greedy NMS, every row of a batch in one launch.
//
// Replaces no TPU kernel: the JAX package runs this loop as a lax.scan
// (kgdet_tpu/ops/nms.py::_greedy), and the port ran it as a Python loop of
// max_out steps of about 39 small PyTorch kernels each
// (kgdet_tpu_torch/ops/nms.py::_greedy, which stays as K9's plain version).
// Added because that loop was the served batch's bottleneck: 3,967 launches
// a served cascade batch, the card idle while the host issued them.
//
// What it computes is exactly _greedy with greedy_nms's update, row by row:
// take the row's argmax (torch.argmax's order: NaN above all, ties to the
// lower index); a best score that is not above NEG_INF / 2 ends the row,
// and this slot and every later one get (-1, NEG_INF), which is what the
// loop writes, since such a step leaves the scores unchanged; otherwise
// write (index, score) to the slot, set every score whose IoU with the pick
// is above iou_thr, and the pick's own, to NEG_INF.
//
// What bounds it on the H100: neither bytes nor operations. A served
// cascade batch is 104 rows of 1,000 candidates (416 KB of scores, 128 KB
// of boxes) and 100 steps of at most 17 operations a candidate; the least
// time is a few microseconds. The step chain is serial: each step's
// suppression needs the previous step's pick. So the design keeps every
// step inside one block and on chip:
// - one block a row, so a served batch (104 rows) is one wave on 132 SMs;
// - the row's scores and its image's boxes staged once in dynamic shared
//   memory (20 bytes a candidate: 20 KB at N = 1,000, 96 KB at the RPN's
//   4.8k); a row that does not fit the 227 KB runs the same code on a global
//   copy of its scores and reads its boxes in place, through L2;
// - boxes indexed by image (row / rep), never expanded over classes; scores
//   read in place with their strides (the (B, N, C) -> (B, C, N) transpose
//   of the multiclass decode is a view);
// - a candidate belongs to one thread for the whole run (n = tid + k *
//   blockDim), so a step's suppression and the next step's argmax are one
//   pass over the thread's own candidates with no barrier between them; the
//   block's argmax is a warp shuffle reduction and one exchange through
//   shared memory, double-buffered by step parity: one barrier a step.
//
// Measured (NVIDIA H100 80GB HBM3 at 700 W, device time a call through
// CUDA graphs; chip_smoke.py's phase 1 times it by profiler): 0.215 ms
// for the served batch's 104 rows of 1,000 (2.1 us a step) and for batch
// 1's 13; 4.55 ms for the RPN's 2 rows of 4,800 over 1,000 steps; 1.68 ms
// for one row of 16,384 on the global copy. The loop took 52 to 64 ms, 458
// to 555 and 50 to 64.
//
// Numerics: the IoU follows ops/nms.py::pairwise_iou's order of operations
// in f32, one rounding each (min - max, + offset, clamp 0, iw * ih, both
// areas, (area + areas) - inter, clamp 1e-10, an IEEE divide), written
// with __f*_rn so that -fmad contracts nothing, and NaN propagates through
// min, max and clamp as in torch.minimum / torch.clamp. iou_thr arrives
// rounded to f32, as PyTorch's `iou > thr` rounds it, and the comparison is
// strict. So every decision, and every kept index and score, equals the
// loop's on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kgdet {
namespace {

constexpr float kNegInf = -1e10f;       // ops/nms.py::NEG_INF
constexpr float kValidAbove = -5e9f;    // NEG_INF / 2, exact in f32
constexpr int kMaxWarps = 16;           // 512 threads
constexpr int kSmemLimit = 227 * 1024;  // what one block can be given
constexpr int kStageBytes = 20;         // a candidate's score and box
constexpr int kExchangeBytes = 2 * kMaxWarps * 8;  // red_s, red_i

// the larger of the card's order: torch.argmax's (NaN first, then the
// larger value, ties to the lower index)
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// torch.minimum / torch.maximum / clamp(min=lo): NaN in, NaN out
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// (x1 - x0 + offset) * (y1 - y0 + offset)
__device__ __forceinline__ float box_area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// pairwise_iou(box, boxes) for the pick p (area ap) and one candidate b
__device__ __forceinline__ float iou(float4 p, float ap, float4 b,
                                     float off) {
  const float iw =
      clamp_lo(__fadd_rn(__fsub_rn(tmin(p.z, b.z), tmax(p.x, b.x)), off), 0.f);
  const float ih =
      clamp_lo(__fadd_rn(__fsub_rn(tmin(p.w, b.w), tmax(p.y, b.y)), off), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ap, box_area(b, off)), inter);
  return __fdiv_rn(inter, clamp_lo(uni, 1e-10f));
}

struct Args {
  const float4* boxes;   // (rows / rep, N) boxes, xyxy
  const float* scores;   // row r = (r / R2, r % R2): r1 * s1 + r2 * s2
  float* scratch;        // (rows, N) f32 where the row is not staged
  long long* keep_idx;   // (rows, max_out)
  float* keep_scores;    // (rows, max_out)
  long long s1, s2, sn;  // score strides, in elements
  int R2, N, rep, max_out;
  float thr, off;
};

template <bool kStaged>
__global__ void greedy_nms_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem[];
  __shared__ float red_s[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];

  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const float* src = a.scores + (row / a.R2) * a.s1 + (row % a.R2) * a.s2;
  const float4* gbox = a.boxes + (long long)(row / a.rep) * N;
  const float4* box = kStaged ? smem : gbox;
  float* sc = kStaged ? reinterpret_cast<float*>(smem + N)
                      : a.scratch + (long long)row * N;
  long long* out_idx = a.keep_idx + (long long)row * a.max_out;
  float* out_sc = a.keep_scores + (long long)row * a.max_out;

  // stage, and the first step's argmax over this thread's candidates
  float bs = -INFINITY;
  int bi = INT32_MAX;
  for (int n = tid; n < N; n += nt) {
    const float s = src[n * a.sn];
    sc[n] = s;
    if (kStaged) smem[n] = __ldg(gbox + n);
    if (better(s, n, bs, bi)) bs = s, bi = n;
  }

  for (int t = 0; t < a.max_out; ++t) {
    // the block's argmax: shuffles in each warp, one exchange of the
    // warps' winners (its barrier also publishes the staged boxes)
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(os, oi, bs, bi)) bs = os, bi = oi;
    }
    const int p = t & 1;
    if (lane == 0) red_s[p][warp] = bs, red_i[p][warp] = bi;
    __syncthreads();
    bs = red_s[p][0], bi = red_i[p][0];
    for (int w = 1; w < nwarps; ++w)
      if (better(red_s[p][w], red_i[p][w], bs, bi))
        bs = red_s[p][w], bi = red_i[p][w];

    if (!(bs > kValidAbove)) {  // exhausted (or NaN): the rest is empty
      for (int k = t + tid; k < a.max_out; k += nt)
        out_idx[k] = -1, out_sc[k] = kNegInf;
      return;
    }
    if (tid == 0) out_idx[t] = bi, out_sc[t] = bs;
    if (t + 1 == a.max_out) return;

    // suppress, and take the next step's argmax in the same pass
    const int pick = bi;
    const float4 pb = box[pick];
    const float pa = box_area(pb, a.off);
    bs = -INFINITY, bi = INT32_MAX;
    for (int n = tid; n < N; n += nt) {
      float s = sc[n];
      if (n == pick || iou(pb, pa, box[n], a.off) > a.thr) {
        s = kNegInf;
        sc[n] = s;
      }
      if (better(s, n, bs, bi)) bs = s, bi = n;
    }
  }
}

// 256 threads up to 4k candidates, 512 above (at most kMaxWarps warps)
inline int threads_for(int N) { return N > 4096 ? 512 : 256; }

inline size_t stage_bytes(int N) { return (size_t)N * kStageBytes; }

}  // namespace
}  // namespace kgdet

// f32 elements of global scratch a row needs: 0 where its scores and boxes
// fit in shared memory, else N.
extern "C" int kgdet_greedy_nms_scratch(int N) {
  using namespace kgdet;
  return stage_bytes(N) + kExchangeBytes <= (size_t)kSmemLimit ? 0 : N;
}

// boxes (rows / rep, N, 4) f32, contiguous, 16-byte aligned; scores: row r
// at (r / R2) * s1 + (r % R2) * s2, candidate n at + n * sn, f32; scratch
// (rows, N) f32 where kgdet_greedy_nms_scratch(N) asks for it, else NULL;
// keep_idx (rows, max_out) int64, keep_scores (rows, max_out) f32. Returns
// the launch's cudaError_t.
extern "C" int kgdet_greedy_nms(const void* boxes, const void* scores,
                                void* scratch, void* keep_idx,
                                void* keep_scores, int rows, int R2, int N,
                                int rep, long long s1, long long s2,
                                long long sn, int max_out, float iou_thr,
                                float offset, void* stream) {
  using namespace kgdet;
  if (rows <= 0 || N <= 0 || max_out <= 0 || R2 <= 0 || rep <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = kgdet_greedy_nms_scratch(N) == 0;
  if (!staged && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float4*>(boxes), static_cast<const float*>(scores),
         static_cast<float*>(scratch), static_cast<long long*>(keep_idx),
         static_cast<float*>(keep_scores), s1, s2, sn, R2, N, rep, max_out,
         iou_thr, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = threads_for(N);
  if (staged) {
    const size_t smem = stage_bytes(N);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          greedy_nms_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    greedy_nms_kernel<true><<<rows, nt, smem, s>>>(a);
  } else {
    greedy_nms_kernel<false><<<rows, nt, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
