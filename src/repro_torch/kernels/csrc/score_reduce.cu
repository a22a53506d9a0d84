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
// is launch latency: one launch per call, and the ints the host reads back
// for its decisions.  The batch form's own bound is bytes:
// sum_k B_k * (2S, or 3S with f, + 3) * 4 read and sum_k B_k * 4 written.
//
// What the design does about it: one launch per call, deterministic
// without float atomics.  score_reduce is one kernel: up to 8192 rows (every
// main-path call) it is one 1024-thread block that walks the rows with a
// strided loop, writes their scores and reduces two (min score, max sum g,
// min row) triples through warp shuffles and shared memory -- the argmin
// over the rows ``mask`` admits and, in the same pass, the one over the rows
// an optional second mask ``guard`` also admits (EcoSched's idle-node guard,
// which took a second call before).  Above 8192 rows each block of the grid
// writes its two triples to scratch and the block that draws the last int
// ticket combines them (last-block-done); the lexicographic compare is a
// total order on distinct rows, so the winners do not depend on which
// block is last.  score_reduce_batch and score_reduce_multi share one
// single-pass kernel over segments packed on the row axis (int32 offsets,
// one [lam, g_free, M, lam_f] params row per segment): each node of the
// batch form, or window of the multi form, gets one block that walks its
// contiguous row range with a strided loop and combines with the same
// compare, the two winners (mask; mask and an optional guard) in one tree
// as score_reduce does, so the fleet's idle-node guard rides in the same
// launch.  That replaces the reference's padded (D, B, S) grid and its
// scatter-min, needs no second pass and no scratch, and stays correct for
// a node of any size (a 50,000-row node is one block looping 196 times;
// the fleet path's nodes fit one block's first step).  All use the same
// row function and compare, so every node or window is bitwise equal to a
// solo call on it.
//
// Numerics: each row sums its S slots left to right in float32 and applies
// the reference's operation order
//     sum_dev/n_eff + (lam*(g_free - sum_g))/M + (lam_f*sum_f)/n_eff + bias
// with round-to-nearest intrinsics, so nothing is contracted into an FMA.
// Masked rows score +inf.  The plain PyTorch version in score_reduce.py runs
// the same column loop, so scores agree bitwise.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// every count an int; f, bias, mask and guard may be null (all zero, all
// zero, all feasible, no guard).  Each entry returns cudaGetLastError()
// after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;          // score_windows_kernel's block
constexpr int kSoloThreads = 1024;     // score_reduce_kernel's block
constexpr int kRowsPerBlock = 8192;    // its rows per block

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

// Block-wide lexicographic reduction of K candidates per thread over NT
// threads, the K trees side by side (one pair of __syncthreads()); the
// results are valid in thread 0.  Safe to call twice in a row (the shared
// slots are read before the second call's writes, behind its first
// __syncthreads()).
__device__ __forceinline__ void warp_best(Best& mine) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(0xffffffffu, mine.score, off);
    o.tot = __shfl_down_sync(0xffffffffu, mine.tot, off);
    o.row = __shfl_down_sync(0xffffffffu, mine.row, off);
    if (better(o, mine)) mine = o;
  }
}

template <int NT, int K>
__device__ void block_best(Best (&mine)[K]) {
  constexpr int kWarps = NT / 32;
  __shared__ Best slots[K][kWarps];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    warp_best(mine[k]);
    if (lane == 0) slots[k][warp] = mine[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mine[k] = lane < kWarps ? slots[k][lane] : none(0x7fffffff);
      warp_best(mine[k]);
    }
  }
}

// score_reduce: one launch.  Block k walks rows [k*kRowsPerBlock, ...) with
// a strided loop, writes their scores and keeps two winners, one over the
// rows ``mask`` admits and one over those ``guard`` also admits.  With one
// block (B <= kRowsPerBlock, every main-path call) block 0 writes both
// winners.  With more, each block writes its two triples to ``part`` and
// takes an int ticket after a __threadfence(); the block that draws the
// last ticket combines all triples with the same compare and resets the
// ticket to 0 for the next call.
__global__ void __launch_bounds__(kSoloThreads) score_reduce_kernel(
    const float* __restrict__ dev, const float* __restrict__ g,
    const float* __restrict__ f, const float* __restrict__ n,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ guard, int B, int S, float lam, float g_free,
    float M, float lam_f, float* __restrict__ scores, int* __restrict__ best,
    float* part, int* ticket) {
  const int lo = blockIdx.x * kRowsPerBlock;
  const int hi = min(B, lo + kRowsPerBlock);
  Best mine[2] = {none(B), none(B)};  // [0] mask, [1] mask and guard
  for (int row = lo + threadIdx.x; row < hi; row += kSoloThreads) {
    float sc, tot;
    row_score(dev, g, f, n, bias, mask, S, row, lam, g_free, M, lam_f, &sc,
              &tot);
    scores[row] = sc;
    Best o;
    o.score = sc;
    o.tot = tot;
    o.row = row;
    if (better(o, mine[0])) mine[0] = o;
    if (guard != nullptr) {
      if (!(guard[row] > 0.0f)) o.score = CUDART_INF_F;
      if (better(o, mine[1])) mine[1] = o;
    }
  }
  block_best<kSoloThreads>(mine);
  if (gridDim.x > 1) {
    __shared__ bool last;
    if (threadIdx.x == 0) {
      float* p = part + 6 * blockIdx.x;
      for (int k = 0; k < 2; ++k) {
        p[3 * k + 0] = mine[k].score;
        p[3 * k + 1] = mine[k].tot;
        p[3 * k + 2] = __int_as_float(mine[k].row);
      }
      __threadfence();
      last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const volatile float* vp = part;
    mine[0] = mine[1] = none(B);
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kSoloThreads) {
      for (int k = 0; k < 2; ++k) {
        Best o;
        o.score = vp[6 * i + 3 * k + 0];
        o.tot = vp[6 * i + 3 * k + 1];
        o.row = __float_as_int(vp[6 * i + 3 * k + 2]);
        if (better(o, mine[k])) mine[k] = o;
      }
    }
    block_best<kSoloThreads>(mine);
    if (threadIdx.x == 0) *ticket = 0;
  }
  if (threadIdx.x == 0) {
    best[0] = isinf(mine[0].score) ? -1 : mine[0].row;
    best[1] = isinf(mine[1].score) ? -1 : mine[1].row;
  }
}

__global__ void __launch_bounds__(kThreads) score_windows_kernel(
    const float* __restrict__ dev, const float* __restrict__ g,
    const float* __restrict__ f, const float* __restrict__ n,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ guard, const int* __restrict__ offsets,
    const float* __restrict__ params, int W, int S, float* __restrict__ scores,
    int* __restrict__ best) {
  const int w = blockIdx.x;
  const int lo = offsets[w];
  const int hi = offsets[w + 1];
  const float lam = params[4 * w + 0];
  const float g_free = params[4 * w + 1];
  const float M = params[4 * w + 2];
  const float lam_f = params[4 * w + 3];
  Best mine[2] = {none(hi - lo), none(hi - lo)};  // [0] mask, [1] mask and guard
  for (int row = lo + threadIdx.x; row < hi; row += kThreads) {
    float sc, tot;
    row_score(dev, g, f, n, bias, mask, S, row, lam, g_free, M, lam_f, &sc,
              &tot);
    scores[row] = sc;
    Best o;
    o.score = sc;
    o.tot = tot;
    o.row = row - lo;
    if (better(o, mine[0])) mine[0] = o;
    if (guard != nullptr) {
      if (!(guard[row] > 0.0f)) o.score = CUDART_INF_F;
      if (better(o, mine[1])) mine[1] = o;
    }
  }
  block_best<kThreads>(mine);
  if (threadIdx.x == 0) {
    best[w] = isinf(mine[0].score) ? -1 : mine[0].row;
    best[W + w] = isinf(mine[1].score) ? -1 : mine[1].row;
  }
}

}  // namespace

extern "C" {

// score_reduce: one launch.  out holds B float scores, then the two int
// winners (mask; mask and guard; -1 where none, and the second -1 when
// guard is null), then, when B > kRowsPerBlock, 6 words of scratch per
// block (ceil(B / kRowsPerBlock) blocks); ticket is a zeroed int of the
// device, used and reset only when there is more than one block.  With a
// host (pinned) pointer host_best the two winners are also copied there
// and the stream synchronised before the return; null leaves the call
// asynchronous.

int score_reduce_launch(const void* dev, const void* g, const void* f,
                        const void* n, const void* bias, const void* mask,
                        const void* guard, int B, int S, float lam,
                        float g_free, float M, float lam_f, void* out,
                        void* ticket, void* host_best, void* stream) {
  const int nb = B <= kRowsPerBlock ? 1 : (B + kRowsPerBlock - 1) / kRowsPerBlock;
  float* scores = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  score_reduce_kernel<<<nb, kSoloThreads, 0, st>>>(
      static_cast<const float*>(dev), static_cast<const float*>(g),
      static_cast<const float*>(f), static_cast<const float*>(n),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const float*>(guard), B, S, lam, g_free, M, lam_f, scores,
      reinterpret_cast<int*>(scores + B), scores + B + 2,
      static_cast<int*>(ticket));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || host_best == nullptr) return static_cast<int>(err);
  err = cudaMemcpyAsync(host_best, scores + B, 2 * sizeof(int),
                        cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return static_cast<int>(err);
}

// Segments packed on the row axis (the windows of score_reduce_multi, the
// nodes of score_reduce_batch): segment w owns rows [offsets[w],
// offsets[w+1]) of the R rows and its [lam, g_free, M, lam_f] row
// params[4w:4w+4].  out holds R float scores, then W int winners over the
// rows mask admits, then W over those guard admits as well (segment-local
// rows; -1 where none, every second winner -1 when guard is null; a
// segment whose guard rows are all 0 carries no guard).  With a host
// (pinned) pointer host_best the W winners, or the 2W with a guard, are
// also copied there and the stream synchronised before the return; null
// leaves the call asynchronous.
int score_reduce_multi_launch(const void* dev, const void* g, const void* f,
                              const void* n, const void* bias,
                              const void* mask, const void* guard,
                              const void* offsets, const void* params, int W,
                              int R, int S, void* out, void* host_best,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scores = static_cast<float*>(out);
  int* best = reinterpret_cast<int*>(scores + R);
  score_windows_kernel<<<W, kThreads, 0, st>>>(
      static_cast<const float*>(dev), static_cast<const float*>(g),
      static_cast<const float*>(f), static_cast<const float*>(n),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const float*>(guard), static_cast<const int*>(offsets),
      static_cast<const float*>(params), W, S, scores, best);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || host_best == nullptr) return static_cast<int>(err);
  const size_t words = static_cast<size_t>(guard != nullptr ? 2 * W : W);
  err = cudaMemcpyAsync(host_best, best, words * sizeof(int),
                        cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return static_cast<int>(err);
}

}  // extern "C"
