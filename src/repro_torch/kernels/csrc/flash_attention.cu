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
// Two routes, picked by the input type; the wrapper never falls back.
//
// bf16 (the serving type): flash_kernel_wgmma, both products on the tensor
// cores in bf16 with float32 accumulation.  One warpgroup (128 threads)
// owns a query tile of 64 rows of one head; the grid is (head, query tile,
// batch) with the head fastest, so the G query heads of one KV head run
// side by side and share its K/V tiles through L2 (K/V of a whole hymba
// call is 10.5 MB of the 50 MB L2), and query tiles run longest first.
//   * S = Q.K^T is wgmma m64nBKk16 with Q and a K tile of BK = 64 keys (32
//     at hd 256, where 64-key tiles spill registers) both read from shared
//     memory, K-major (rows hd-contiguous), in the 128-, 64- or 32-byte
//     swizzle that a panel row of 64, 32 or 16 columns takes; hd 96, 128
//     and 256 are 3, 2 and 4 such panels.
//   * The scale is applied to the float32 scores after the product, then
//     softcap, then the causal / window / ragged-edge masks -- those only on
//     a tile that straddles an edge; interior tiles skip them.  The KV-tile
//     range per query tile is the TPU kernel's should_run (at hymba's shape
//     408 tiles per (b, h), 94 % of their pairs unmasked).
//   * Online softmax in registers: a thread holds two rows of the
//     accumulator, a row's columns lie on the 4 threads of a quad, so the
//     running max and sum need two shuffles and no score tile goes through
//     shared memory.  A masked score is -inf, so its p is exactly 0 even
//     while a row has met no unmasked key (the running max starts at the
//     reference's -1e30).  l sums the float32 p.
//   * O += P.V is wgmma m64nPWk16 with P from registers: the S accumulator
//     of 16 key columns is already the A-fragment layout, so P is rounded
//     to bf16 pairs in place (FlashAttention-3's trick); V is read from
//     shared memory MN-major (transpose bit), one product per panel.
//   * K/V tiles go through two stages of shared memory filled by cp.async
//     (16-byte copies written in the swizzled layout, ragged rows
//     zero-filled): tile t+1 loads while tile t computes.  TMA would free
//     the threads' copy instructions; cp.async needs no tensor maps.
//   Shared memory: 41 KB at hd 64, 81 KB at hd 128, 97 KB at hd 256.
//
// float32 (parity runs; TF32 would keep about three decimal digits, too few
// for the 2e-5 tolerance): flash_kernel, float32 FMAs on the CUDA cores.
// One block per (query tile of 64 rows, query head, batch), a loop over the
// KV tiles in ascending order; query head j reads KV head j / G.  Per tile
// the block stages K and V in shared memory, computes the 64 x BK score
// tile (each thread 4 rows x BK/CG columns), applies scale (to q, before
// the dot, as the reference), softcap and the masks, updates the running
// max and sum per row (a few threads per row, warp shuffles), and adds P.V
// into per-thread float32 accumulators (4 rows x hd/CG columns).  Head dims
// 16-128 use 128 threads and 64-key tiles (67 KB of dynamic shared memory
// at hd 64, 116 KB at hd 128); hd 256 uses 256 threads and 32-key tiles
// (141 KB).
//
// Both: the output is written once, divided by max(l, 1e-30); the ragged
// last query and key tiles are masked, so any sequence length is taken;
// above 48 KB of shared memory the launch opts in with
// cudaFuncSetAttribute.
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int, scalars float; dtype 0 is float32, 1 bfloat16 (q, k, v and o share
// it).  Tensors are contiguous (the bf16 route also 16-byte aligned): q and
// o (B, Sq, H, hd), k and v (B, Skv, KVH, hd).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head dim or type it
// does not take.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kBQ = 64;            // query rows per block (both routes)

// ---------------------------------------------------------------------------
// float32 route: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRG = 16;            // row groups: a thread owns rows ty + 16*i
constexpr int kRI = kBQ / kRG;     // rows per thread

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

template <int HD, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H, int KVH, int causal, int window,
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
  const float* qb = q + ((long)b * Sq * H + h) * HD;
  const float* kb = k + ((long)b * Skv * KVH + kvh) * HD;
  const float* vb = v + ((long)b * Skv * KVH + kvh) * HD;
  float* ob = o + ((long)b * Sq * H + h) * HD;

  for (int e = tid; e < kBQ * HD; e += NT) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    sQ[r * Sh::LD + d] = qi < Sq ? qb[qi * q_step + d] * scale : 0.f;
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
      sK[r * Sh::LD + d] = in ? kb[kj * kv_step + d] : 0.f;
      sV[r * Sh::LD + d] = in ? vb[kj * kv_step + d] : 0.f;
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
      ob[qi * q_step + tx + Sh::CG * j] = acc[i][j] / l;
  }
}

template <int HD, int BK, int NT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KVH, int causal, int window,
                   float scale, float softcap, cudaStream_t st) {
  const int bytes = Tile<HD, BK, NT>::kFloats * (int)sizeof(float);
  auto kern = flash_kernel<HD, BK, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, NT, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KVH, causal,
      window, scale, softcap);
  return cudaGetLastError();
}

cudaError_t launch_f32(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Sq, int Skv, int H, int KVH,
                      int causal, int window, float scale, float softcap,
                      cudaStream_t st) {
#define REPRO_FLASH(HD, BK, NT)                                               \
  case HD:                                                                    \
    return launch<HD, BK, NT>(q, k, v, o, B, Sq, Skv, H, KVH, causal,         \
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

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // one warpgroup: 64 query rows

// The tiles' layout in shared memory.  A tile of R rows x HD columns (Q,
// or K or V: rows are positions, HD-contiguous) is stored as HD / PW
// panels of R rows x PW columns; a panel row is RB = 2*PW bytes (128, 64
// or 32) in the matching wgmma swizzle mode (128B, 64B, 32B): a linear
// byte offset off within the 1024-byte-aligned panel is stored at
// off ^ ((off >> 3) & (SWZ << 4)), the 16-byte chunk index XORed with the
// row's place in its 8-row swizzle atom -- what TMA's swizzle modes write.
template <int HD_, int BK_>
struct Tc {
  static constexpr int HD = HD_;
  static constexpr int BK = BK_;
  static constexpr int PW = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int NP = HD / PW;       // panels
  static constexpr int RB = 2 * PW;        // bytes of a panel row
  static constexpr uint32_t SWZ = RB / 16 - 1;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr int Q_BYTES = kBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  // 1024 bytes of alignment slack, Q, and two stages of K and V
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
  static_assert(HD % 16 == 0 && BK % 16 == 0, "wgmma k-steps");
  static_assert((kBQ * HD / 8) % kTcThreads == 0 &&
                (BK * HD / 8) % kTcThreads == 0, "tile loads");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies' generic-proxy writes made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the register
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (Q as A, K as B of Q.K^T): rows of a panel are the M/N
// index, 8-row groups one swizzle atom (8 * RB bytes) apart; a k-step of
// 16 columns advances the start address by 32 bytes within the row
template <class C>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return gmma_desc(addr, 16, 8 * C::RB, C::LAYOUT);
}
// MN-major operand (V as B of P.V, the transpose bit set): panel rows are
// the k index (keys), 8-key groups one atom apart, panels BK * RB apart
template <class C>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return gmma_desc(addr, C::BK * C::RB, 8 * C::RB, C::LAYOUT);
}

// wgmma.mma_async m64nNk16, bf16 in, float32 accumulators, D += A.B (the
// scale-d predicate is 1).  wgmma_ss: A and B from shared memory, both
// K-major.  wgmma_rs: A from registers, B from shared memory MN-major
// (the transpose bit).  Overloaded on the accumulator's N / 2 registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// R rows x HD columns from device memory rows r0.. (step elements apart)
// into the swizzled panels at dst; rows at or past n are zero-filled
template <int R, class C>
__device__ __forceinline__ void tc_load(uint32_t dst, const bf16* src,
                                        long step, int r0, int n) {
  constexpr int CPR = C::HD / 8;  // 16-byte chunks per row
  constexpr int CPP = C::PW / 8;  // ... per panel row
#pragma unroll
  for (int it = 0; it < R * CPR / kTcThreads; ++it) {
    const int e = it * kTcThreads + threadIdx.x;
    const int r = e / CPR, c = e % CPR;
    uint32_t off = r * C::RB + (c % CPP) * 16;
    off ^= (off >> 3) & (C::SWZ << 4);
    const bool in = r0 + r < n;
    cp_async16(dst + (c / CPP) * R * C::RB + off,
               src + (long)(in ? r0 + r : 0) * step + c * 8, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warpgroup per (head, query tile of 64 rows, batch); warp w owns rows
// 16w..16w+15 and each thread two of them (row0, row0 + 8) with the
// wgmma accumulator layout: element i of a 64 x N accumulator is row
// row0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).
template <int HD, int BK>
__global__ void __launch_bounds__(kTcThreads, 1) flash_kernel_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int H,
    int KVH, int causal, int window, float scale, float softcap) {
  using C = Tc<HD, BK>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t sQ = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K, then V, at 2s tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x;  // head fastest: a KV head's G heads run together
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_step = (long)H * HD, kv_step = (long)KVH * HD;
  const bf16* qb = q + ((long)b * Sq * H + h) * HD;
  const bf16* kb = k + ((long)b * Skv * KVH + kvh) * HD;
  const bf16* vb = v + ((long)b * Skv * KVH + kvh) * HD;
  bf16* ob = o + ((long)b * Sq * H + h) * HD;

  // the KV tiles that can hold an unmasked key of this block's rows (the
  // TPU kernel's should_run)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  tc_load<kBQ, C>(sQ, qb, q_step, q0, Sq);
  if (kt_begin < kt_end) {
    tc_load<BK, C>(sKV, kb, kv_step, kt_begin * BK, Skv);
    tc_load<BK, C>(sKV + C::KV_BYTES, vb, kv_step, kt_begin * BK, Skv);
  }
  cp_commit();

  float acc[C::NP][C::PW / 2];
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
#pragma unroll
    for (int i = 0; i < C::PW / 2; ++i) acc[p][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max of rows row0, row0 + 8
  float l_part[2] = {0.f, 0.f};  // this thread's share of the running sum
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const uint32_t sK = sKV + ((kt - kt_begin) & 1) * 2 * C::KV_BYTES;
    const uint32_t sV = sK + C::KV_BYTES;
    if (kt + 1 < kt_end) {  // the next tile loads while this one computes
      const uint32_t nK = sKV + ((kt + 1 - kt_begin) & 1) * 2 * C::KV_BYTES;
      tc_load<BK, C>(nK, kb, kv_step, (kt + 1) * BK, Skv);
      tc_load<BK, C>(nK + C::KV_BYTES, vb, kv_step, (kt + 1) * BK, Skv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q.K^T, float32 accumulators
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk * 16 / C::PW, cb = (kk * 16) % C::PW * 2;
      wgmma_ss(s, kmajor<C>(sQ + p * kBQ * C::RB + cb),
               kmajor<C>(sK + p * BK * C::RB + cb));
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // scale, softcap, and the masks only on a tile that straddles an edge
    const int k0 = kt * BK;
    const bool edge = !(k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || k0 > q0 + kBQ - 1 - window));
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (edge) {
        const int qi = row0 + 8 * ((i >> 1) & 1);
        const int kj = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const bool keep = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
        if (!keep) x = -CUDART_INF_F;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    // online softmax: a row's columns lie on the 4 threads of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = __expf(s[i] - m_run[r]);  // exactly 0 where masked
      s[i] = p;
      l_part[r] += p;
    }
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
#pragma unroll
      for (int i = 0; i < C::PW / 2; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

    // P as bf16 A fragments: key columns 16kk..16kk+15 of the S
    // accumulator are the m64k16 A-fragment layout already
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P.V, one 64 x PW product per panel
#pragma unroll
    for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        wgmma_rs(acc[p], pa[kk],
                 mnmajor<C>(sV + p * BK * C::RB + kk * 16 * C::RB));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
    __syncthreads();  // this stage's readers are done before it refills
  }
  cp_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
#pragma unroll
    for (int i = 0; i < C::PW / 2; i += 2) {
      const int r = (i >> 1) & 1, qi = row0 + 8 * r;
      if (qi >= Sq) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          ob + qi * q_step + p * C::PW + 8 * (i >> 2) + col0) =
          __floats2bfloat162_rn(acc[p][i] * inv[r], acc[p][i + 1] * inv[r]);
    }
}

template <int HD, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int B, int Sq, int Skv, int H, int KVH,
                         int causal, int window, float scale, float softcap,
                         cudaStream_t st) {
  auto kern = flash_kernel_wgmma<HD, BK>;
  const int bytes = Tc<HD, BK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kTcThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, KVH,
      causal, window, scale, softcap);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int KVH,
                        int causal, int window, float scale, float softcap,
                        cudaStream_t st) {
#define REPRO_FLASH_TC(HD, BK)                                                \
  case HD:                                                                    \
    return launch_wgmma<HD, BK>(q, k, v, o, B, Sq, Skv, H, KVH, causal,       \
                                window, scale, softcap, st);
  switch (hd) {
    REPRO_FLASH_TC(16, 64)
    REPRO_FLASH_TC(32, 64)
    REPRO_FLASH_TC(64, 64)
    REPRO_FLASH_TC(96, 64)
    REPRO_FLASH_TC(128, 64)
    REPRO_FLASH_TC(256, 32)  // 64-key tiles spill at hd 256
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_TC
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int KVH,
                           int hd, int dtype, int causal, int window,
                           float scale, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                      scale, softcap, st);
  if (dtype == 1)
    return launch_bf16(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                       scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
