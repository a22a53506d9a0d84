// Flash attention (causal / sliding window / GQA / softcap) on Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py:
//   * flash_attention (_kernel, pallas_call at :127)
//
// What bounds it on this card: operations.  At hymba-1.5b's prefill
// (B 4, S 2048, H 25 over KVH 5, hd 64, window 1024) the unmasked (q, k)
// pairs number 1.573e8, at 4*hd flops each (q.k and p.v): 4.0e10 flops,
// 0.041 ms at the bf16 tensor-core rate (989 TFLOP/s) or 0.60 ms at the
// float32 rate outside the tensor cores (67 TFLOP/s).  Each input read once
// and the output written once move 63 MB in bf16, 0.019 ms at 3.35 TB/s.
//
// What the design does about it, simply: it keeps every score and the
// online-softmax state on chip, so device memory sees each q row once, each
// K/V tile once per block and each output row once, and it skips the KV
// tiles that lie wholly outside the causal band or the window, as the TPU
// kernel's should_run does, so windowed layers do near-linear work.  The
// arithmetic is float32 FMAs on the CUDA cores (inputs converted to float32
// as they are staged into shared memory), not wgmma: this first version is
// right and simple, and its time is far above the tensor-core bound.
//
// Layout for Hopper rather than the TPU's 5-D grid: one block per (query
// tile of 64 rows, query head, batch).  The TPU's sequential kv-block grid
// axis becomes a loop inside the block over KV tiles in ascending order;
// query head j reads KV head j / G.  Per tile the block stages K and V in
// shared memory, computes the 64 x BK score tile (each thread 4 rows x
// BK/CG columns), applies scale (to q, before the dot, as the reference),
// softcap, and the causal / window / ragged-edge masks, updates the running
// max and sum per row (a few threads per row, warp shuffles), and adds
// P.V into per-thread float32 accumulators (4 rows x hd/CG columns).  The
// output tile is written once, divided by max(l, 1e-30).  A masked score is
// -inf in the tile, so its p is exactly 0 even while a row has seen no
// unmasked key yet (the running max starts at -1e30, the reference's
// NEG_INF); the reference instead relies on a later tile to wipe that
// transient with alpha = 0.  The ragged last query and key tiles are
// masked, so any sequence length is taken.  Head dims 16, 32, 64, 96 and
// 128 use 128 threads and 64-key tiles (67 KB of dynamic shared memory at
// hd 64, 116 KB at hd 128); hd 256 uses 256 threads and 32-key tiles
// (141 KB).  Above 48 KB the launch opts in with cudaFuncSetAttribute.
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int, scalars float; dtype 0 is float32, 1 bfloat16 (q, k, v and o share
// it).  Tensors are contiguous: q and o (B, Sq, H, hd), k and v
// (B, Skv, KVH, hd).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim or type it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kBQ = 64;            // query rows per block
constexpr int kRG = 16;            // row groups: a thread owns rows ty + 16*i
constexpr int kRI = kBQ / kRG;     // rows per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int HD, int BK, int NT>
struct Tile {
  static constexpr int CG = NT / kRG;   // column groups
  static constexpr int SJ = BK / CG;    // score columns per thread
  static constexpr int OJ = HD / CG;    // output columns per thread
  static constexpr int TPR = NT / kBQ;  // threads per row in the softmax pass
  static constexpr int CPT = BK / TPR;  // score columns per thread there
  static constexpr int LD = HD + 1;     // padded row of the Q, K and V tiles
  static constexpr int LDS = BK + 1;    // padded row of the score tile
  static constexpr int kFloats = kBQ * LD + 2 * BK * LD + kBQ * LDS + 3 * kBQ;
  static_assert(NT % kRG == 0 && BK % CG == 0 && HD % CG == 0, "tiling");
  static_assert(NT % kBQ == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "rows");
};

template <typename T, int HD, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int H, int KVH, int causal, int window,
    float scale, float softcap) {
  using Sh = Tile<HD, BK, NT>;
  extern __shared__ float smem[];
  float* sQ = smem;                  // kBQ x LD, scaled
  float* sK = sQ + kBQ * Sh::LD;     // BK x LD
  float* sV = sK + BK * Sh::LD;      // BK x LD
  float* sS = sV + BK * Sh::LD;      // kBQ x LDS, scores then p
  float* sM = sS + kBQ * Sh::LDS;    // running max per row
  float* sL = sM + kBQ;              // running sum per row
  float* sA = sL + kBQ;              // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / Sh::CG;
  const int tx = tid % Sh::CG;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_step = (long)H * HD;     // between positions of q and o
  const long kv_step = (long)KVH * HD;  // between positions of k and v
  const T* qb = q + ((long)b * Sq * H + h) * HD;
  const T* kb = k + ((long)b * Skv * KVH + kvh) * HD;
  const T* vb = v + ((long)b * Skv * KVH + kvh) * HD;
  T* ob = o + ((long)b * Sq * H + h) * HD;

  for (int e = tid; e < kBQ * HD; e += NT) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    sQ[r * Sh::LD + d] = qi < Sq ? to_f(qb[qi * q_step + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  float acc[kRI][Sh::OJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < Sh::OJ; ++j) acc[i][j] = 0.f;

  // the KV tiles that can hold an unmasked key of this block's rows
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the Q tile is in; the last tile's readers are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD, kj = k0 + r;
      const bool in = kj < Skv;
      sK[r * Sh::LD + d] = in ? to_f(kb[kj * kv_step + d]) : 0.f;
      sV[r * Sh::LD + d] = in ? to_f(vb[kj * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float s[kRI][Sh::SJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < Sh::SJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[kRI], ka[Sh::SJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) qa[i] = sQ[(ty + kRG * i) * Sh::LD + d];
#pragma unroll
      for (int j = 0; j < Sh::SJ; ++j) ka[j] = sK[(tx + Sh::CG * j) * Sh::LD + d];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < Sh::SJ; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + kRG * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < Sh::SJ; ++j) {
        const int c = tx + Sh::CG * j, kj = k0 + c;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
        sS[r * Sh::LDS + c] = keep ? x : -CUDART_INF_F;
      }
    }
    __syncthreads();

    {  // online softmax: TPR neighbouring lanes share a row
      const int r = tid / Sh::TPR, part = tid % Sh::TPR;
      float* row = sS + r * Sh::LDS + part * Sh::CPT;
      float mx = -CUDART_INF_F;
      for (int c = 0; c < Sh::CPT; ++c) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = Sh::TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < Sh::CPT; ++c) {
        const float p = expf(row[c] - m_new);  // 0 where masked (-inf)
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = Sh::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const float a = sA[ty + kRG * i];
#pragma unroll
      for (int j = 0; j < Sh::OJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[kRI], va[Sh::OJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) pa[i] = sS[(ty + kRG * i) * Sh::LDS + c];
#pragma unroll
      for (int j = 0; j < Sh::OJ; ++j) va[j] = sV[c * Sh::LD + tx + Sh::CG * j];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < Sh::OJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + kRG * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < Sh::OJ; ++j)
      store(ob + qi * q_step + tx + Sh::CG * j, acc[i][j] / l);
  }
}

template <typename T, int HD, int BK, int NT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KVH, int causal, int window,
                   float scale, float softcap, cudaStream_t st) {
  const int bytes = Tile<HD, BK, NT>::kFloats * (int)sizeof(float);
  auto kern = flash_kernel<T, HD, BK, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KVH, causal,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Sq, int Skv, int H, int KVH,
                      int causal, int window, float scale, float softcap,
                      cudaStream_t st) {
#define REPRO_FLASH(HD, BK, NT)                                               \
  case HD:                                                                    \
    return launch<T, HD, BK, NT>(q, k, v, o, B, Sq, Skv, H, KVH, causal,      \
                                 window, scale, softcap, st);
  switch (hd) {
    REPRO_FLASH(16, 64, 128)
    REPRO_FLASH(32, 64, 128)
    REPRO_FLASH(64, 64, 128)
    REPRO_FLASH(96, 64, 128)
    REPRO_FLASH(128, 64, 128)
    REPRO_FLASH(256, 32, 256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int KVH,
                           int hd, int dtype, int causal, int window,
                           float scale, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal,
                            window, scale, softcap, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KVH,
                                    causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
