// Eq. (1) score reduction + tie-broken argmin for EcoSched on Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/score_reduce.py:
//   * score_reduce        (_kernel via _reduce_jit, pallas_call at :138, plus
//                          the jnp _combine at :103)
//   * score_reduce_batch  (_kernel_batch via _reduce_batch_jit, pallas_call
//                          at :255, plus the vmapped jnp _combine at :273)
//   * score_reduce_multi  (_kernel_multi via _reduce_multi_jit, pallas_call at
//                          :374, plus the jnp scatter-min at :387-399)
//
// What bounds it on this card: neither bytes nor operations.  A call
// sends a few to a few thousand candidate rows of S <= 8 slots (on the
// main paths of chip_smoke.py at most 1321 rows in one score_reduce launch,
// and at most 16 nodes / 42 rows in one score_reduce_batch launch of the
// 256-node fleet cells), a few hundred KB at most: well under a
// microsecond of HBM time at 3.35 TB/s, and ~10 flops a row.  So the floor
// is launch latency: two launches for score_reduce, one for each packed
// form, and the ints the host reads back for its decisions.  The batch
// form's own bound is bytes: sum_k B_k * (2S, or 3S with f, + 3) * 4 read
// and sum_k B_k * 4 written.
//
// What the design does about it: it keeps the work to the fewest launches
// that stay deterministic without float atomics.  score_reduce is one thread
// per row in 256-thread blocks (pass 1 writes scores and one (min score,
// max sum g, min row) triple per block through warp shuffles and shared
// memory) and a single-block pass 2 that combines the triples with the same
// lexicographic compare; that compare is a total order on distinct rows, so
// the winner does not depend on reduction order.  score_reduce_batch and
// score_reduce_multi share one single-pass kernel over segments packed on
// the row axis (int32 offsets, one [lam, g_free, M, lam_f] params row per
// segment): each node of the batch form, or window of the multi form, gets
// one block that walks its contiguous row range with a strided loop and
// combines with the same compare.  That replaces the reference's padded
// (D, B, S) grid and its scatter-min, needs no second pass and no scratch,
// and stays correct for a node of any size (a 50,000-row node is one block
// looping 196 times; the fleet path's nodes fit one block's first step).
// All use the same row function and compare, so every node or window is
// bitwise equal to a solo call on it.
//
// Numerics: each row sums its S slots left to right in float32 and applies
// the reference's operation order
//     sum_dev/n_eff + (lam*(g_free - sum_g))/M + (lam_f*sum_f)/n_eff + bias
// with round-to-nearest intrinsics, so nothing is contracted into an FMA.
// Masked rows score +inf.  The plain PyTorch version in score_reduce.py runs
// the same column loop, so scores agree bitwise.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// every count an int; f, bias and mask may be null (all zero, all zero, all
// feasible).  Each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Best {
  float score;  // lowest score wins
  float tot;    // then the largest total unit count
  int row;      // then the earliest row
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.score != b.score) return a.score < b.score;
  if (a.tot != b.tot) return a.tot > b.tot;
  return a.row < b.row;
}

__device__ __forceinline__ Best none(int sentinel) {
  Best b;
  b.score = CUDART_INF_F;
  b.tot = -1.0f;
  b.row = sentinel;
  return b;
}

// One row's Eq. (1) score and sum of unit counts.
__device__ __forceinline__ void row_score(
    const float* __restrict__ dev, const float* __restrict__ g,
    const float* __restrict__ f, const float* __restrict__ n,
    const float* __restrict__ bias, const float* __restrict__ mask, int S,
    long row, float lam, float g_free, float M, float lam_f,
    float* score, float* tot) {
  const long base = row * S;
  float sd = 0.0f, sg = 0.0f, sf = 0.0f;
  for (int s = 0; s < S; ++s) {
    sd = __fadd_rn(sd, dev[base + s]);
    sg = __fadd_rn(sg, g[base + s]);
    if (f != nullptr) sf = __fadd_rn(sf, f[base + s]);
  }
  const float n_eff = fmaxf(n[row], 1.0f);
  const float a = __fdiv_rn(sd, n_eff);
  const float b = __fdiv_rn(__fmul_rn(lam, __fsub_rn(g_free, sg)), M);
  const float c = __fdiv_rn(__fmul_rn(lam_f, sf), n_eff);
  float v = __fadd_rn(__fadd_rn(a, b), c);
  if (bias != nullptr) v = __fadd_rn(v, bias[row]);
  const bool feasible = (mask == nullptr) || (mask[row] > 0.0f);
  *score = feasible ? v : CUDART_INF_F;
  *tot = sg;
}

// Block-wide lexicographic reduction; the result is valid in thread 0.
__device__ Best block_best(Best mine) {
  __shared__ Best warp_best[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(0xffffffffu, mine.score, off);
    o.tot = __shfl_down_sync(0xffffffffu, mine.tot, off);
    o.row = __shfl_down_sync(0xffffffffu, mine.row, off);
    if (better(o, mine)) mine = o;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    mine = lane < kWarps ? warp_best[lane] : none(0x7fffffff);
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.score = __shfl_down_sync(0xffffffffu, mine.score, off);
      o.tot = __shfl_down_sync(0xffffffffu, mine.tot, off);
      o.row = __shfl_down_sync(0xffffffffu, mine.row, off);
      if (better(o, mine)) mine = o;
    }
  }
  return mine;
}

__global__ void __launch_bounds__(kThreads) score_rows_kernel(
    const float* __restrict__ dev, const float* __restrict__ g,
    const float* __restrict__ f, const float* __restrict__ n,
    const float* __restrict__ bias, const float* __restrict__ mask, int B,
    int S, float lam, float g_free, float M, float lam_f,
    float* __restrict__ scores, float* __restrict__ bmin,
    float* __restrict__ btot, int* __restrict__ bidx) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  Best mine = none(B);
  if (row < B) {
    float sc, tot;
    row_score(dev, g, f, n, bias, mask, S, row, lam, g_free, M, lam_f, &sc,
              &tot);
    scores[row] = sc;
    mine.score = sc;
    mine.tot = tot;
    mine.row = row;
  }
  mine = block_best(mine);
  if (threadIdx.x == 0) {
    bmin[blockIdx.x] = mine.score;
    btot[blockIdx.x] = mine.tot;
    bidx[blockIdx.x] = mine.row;
  }
}

__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ bmin, const float* __restrict__ btot,
    const int* __restrict__ bidx, int nb, int B, int* __restrict__ best) {
  Best mine = none(B);
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    Best o;
    o.score = bmin[i];
    o.tot = btot[i];
    o.row = bidx[i];
    if (better(o, mine)) mine = o;
  }
  mine = block_best(mine);
  if (threadIdx.x == 0) *best = isinf(mine.score) ? -1 : mine.row;
}

__global__ void __launch_bounds__(kThreads) score_windows_kernel(
    const float* __restrict__ dev, const float* __restrict__ g,
    const float* __restrict__ f, const float* __restrict__ n,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const int* __restrict__ offsets, const float* __restrict__ params, int S,
    float* __restrict__ scores, int* __restrict__ best) {
  const int w = blockIdx.x;
  const int lo = offsets[w];
  const int hi = offsets[w + 1];
  const float lam = params[4 * w + 0];
  const float g_free = params[4 * w + 1];
  const float M = params[4 * w + 2];
  const float lam_f = params[4 * w + 3];
  Best mine = none(hi - lo);
  for (int row = lo + threadIdx.x; row < hi; row += kThreads) {
    float sc, tot;
    row_score(dev, g, f, n, bias, mask, S, row, lam, g_free, M, lam_f, &sc,
              &tot);
    scores[row] = sc;
    Best o;
    o.score = sc;
    o.tot = tot;
    o.row = row - lo;
    if (better(o, mine)) mine = o;
  }
  mine = block_best(mine);
  if (threadIdx.x == 0) best[w] = isinf(mine.score) ? -1 : mine.row;
}

}  // namespace

extern "C" {

// scores (B,), best (1,); scratch bmin/btot/bidx hold ceil(B/256) entries.
int score_reduce_launch(const void* dev, const void* g, const void* f,
                        const void* n, const void* bias, const void* mask,
                        int B, int S, float lam, float g_free, float M,
                        float lam_f, void* scores, void* bmin, void* btot,
                        void* bidx, void* best, void* stream) {
  const int nb = (B + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  score_rows_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const float*>(dev), static_cast<const float*>(g),
      static_cast<const float*>(f), static_cast<const float*>(n),
      static_cast<const float*>(bias), static_cast<const float*>(mask), B, S,
      lam, g_free, M, lam_f, static_cast<float*>(scores),
      static_cast<float*>(bmin), static_cast<float*>(btot),
      static_cast<int*>(bidx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(bmin), static_cast<const float*>(btot),
      static_cast<const int*>(bidx), nb, B, static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

// Segments packed on the row axis (the windows of score_reduce_multi, the
// nodes of score_reduce_batch): segment w owns rows [offsets[w],
// offsets[w+1]) and its [lam, g_free, M, lam_f] row params[4w:4w+4].
// scores (R,), best (W,) segment-local rows.
int score_reduce_multi_launch(const void* dev, const void* g, const void* f,
                              const void* n, const void* bias,
                              const void* mask, const void* offsets,
                              const void* params, int W, int S, void* scores,
                              void* best, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  score_windows_kernel<<<W, kThreads, 0, st>>>(
      static_cast<const float*>(dev), static_cast<const float*>(g),
      static_cast<const float*>(f), static_cast<const float*>(n),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const int*>(offsets), static_cast<const float*>(params), S,
      static_cast<float*>(scores), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
