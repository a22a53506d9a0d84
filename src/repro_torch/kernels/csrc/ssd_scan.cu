// Mamba2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py:
//   * ssd_scan (_kernel, pallas_call at :102)
//
// What bounds it on this card: bytes.  At mamba2-2.7b's layer (B 2,
// S 4096, nh 80, hp 64, N 128, chunk Q 256, bf16) the function needs, two
// operations a multiply-add, the causal half of C.B^T once per (batch,
// chunk) (2.7e8), and per (batch, head, chunk) the causal half of scores.x
// (1.08e10), the carried-state term and the state update (1.07e10 each):
// 3.25e10 operations, 0.033 ms at the bf16 tensor-core rate.  Each input
// read once and y (float32) and h written once move 263.7 MB, 0.079 ms at
// 3.35 TB/s, which is the bound.
//
// The design takes the chunk axis out of the serial loop.  With La the
// inclusive cumulative sum of dt*A within a chunk and Ltot its last value,
// one call runs four kernels on the stream:
//   1. ssd_cb_kernel, per (batch, chunk, 64x64 tile j <= i): C.B^T, once
//      for all heads, into scratch (float32, 8.4 MB at mamba2's shape,
//      which the 50 MB L2 holds for the readers of step 4).
//   2. ssd_state_kernel, per (batch, chunk, head): La by warp scans, then
//      the chunk-local state s_c = x^T (B * exp(Ltot - La) * dt) from zero,
//      into scratch (84 MB at mamba2's shape).
//   3. ssd_pass_kernel, per (batch, head, 1024 floats of the hp x N state):
//      in series over the chunks only, h <- exp(Ltot_c) h + s_c; it
//      overwrites s_c with the state chunk c starts from and writes the
//      final state.  Reads and writes the 84 MB once each.
//   4. ssd_out_kernel, per (batch, chunk, head): y = (C.B^T * exp(La_i -
//      La_j) * dt_j, j <= i) . x + exp(La_i) (C_i . h_{c-1}^T), tiled 64
//      rows by 64 columns; an off-diagonal tile's decays are exp(La_i -
//      La_r) exp(La_r - La_j) about its last column r (128 exps, not
//      4,096; both factors <= 1), the diagonal tile takes one exp of a
//      value <= 0 a score, and nothing above the diagonal is computed.
// Steps 1, 2 and 4 run B * nc * nh blocks or more (2,560 at mamba2's
// shape), so the card is full.  Bytes at that shape, each a bound of its
// kernel: step 1 reads B and C (4.2 MB) and writes the causal tiles of
// C.B^T (5.2 MB); step 2 reads x (84 MB) and writes the chunk states (84
// MB); step 3 reads and writes the states once (84 MB each way); step 4
// reads x and the states again (84 MB each) and writes y (168 MB), C.B^T,
// C and dt coming from L2.  About 0.51 GB in all against the function's
// 263.7 MB, 0.15 ms at 3.35 TB/s; the split products double the
// tensor-core work to about 6e10 operations, still under the bytes.  The
// loads of the next tile (x, C.B^T, and bf16 C) are started with cp.async
// before this tile's products; y goes out in streaming stores, so it does
// not push C.B^T and x, which every head of a chunk reads again, out of L2.
//
// Every product runs on the tensor cores (mma.sync.m16n8k16, bf16 in,
// float32 accumulation; operands of 16 by 16 fit every head dim and
// state size, where wgmma's tile is 64 rows).  bf16 inputs (x, B, C) go in
// as they are.  Each float32 operand (the scores, h_{c-1}, B * w, and for
// float32 inputs x, B and C too) is split into hi + lo bf16 (v - hi
// rounded again), and its product takes two mma (hi and lo against an
// exact bf16 operand) or three (hi.hi + hi.lo + lo.hi when both sides
// are split): about 2^-17 relative error a product, where one rounding to
// bf16 would give 2^-9.  Operands sit in shared memory with the reduction
// axis contiguous (loaded as 32-bit pairs) or with rows along it (loaded
// with ldmatrix .trans); rows are padded so neither load conflicts.
// Global loads are 16 bytes a thread wherever the row allows (cp.async or
// vector loads).  No float atomics: the state pass's series order fixes
// every sum.
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int; dtype 0 is float32, 1 bfloat16 for x, B and C (dt and A are always
// float32).  Tensors are contiguous: x (B, S, nh, hp), dt (B, S, nh), A
// (nh,), B and C (B, S, N); y (B, S, nh, hp) and h (B, nh, hp, N) float32.
// S is a multiple of Q.  ssd_scan_plan says whether a shape is taken and
// how many float32 words of scratch a call needs; ssd_scan_launch takes
// that scratch and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // every kernel: 8 warps
constexpr int kT = 64;         // rows (and columns) of a tile
constexpr int kLdT = kT + 8;   // padded row of a 64-wide bf16 tile
constexpr int kMaxChunk = 1024;
constexpr int kMaxSmem = 231424;  // a block's 227 KB, less 1 KB of static slots

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync.m16n8k16, bf16 in, float32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// A fragment (16 x 16 at m0, k0) of A stored [m][k], k contiguous.
__device__ __forceinline__ void frag_a_k(uint32_t (&a)[4], const bf16* A, int ld, int m0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = A + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A fragment of A stored [k][m], m contiguous (ldmatrix .trans).
__device__ __forceinline__ void frag_a_mn(uint32_t (&a)[4], const bf16* A, int ld, int m0,
                                          int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  ldsm_x4_t(a, A + (k0 + (mat >> 1) * 8 + (lane & 7)) * ld + m0 + (mat & 1) * 8);
}

// B fragment (16 x 8 at k0, n0) of B stored [n][k], k contiguous.
__device__ __forceinline__ void frag_b_k(uint32_t (&b)[2], const bf16* B, int ld, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = B + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragments of the two 8-column tiles n0 and n0 + 8 of B stored [k][n],
// n contiguous: b[0], b[1] for n0 and b[2], b[3] for n0 + 8.
__device__ __forceinline__ void frag_b_mn2(uint32_t (&b)[4], const bf16* B, int ld, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  ldsm_x4_t(b, B + (k0 + (mat & 1) * 8 + (lane & 7)) * ld + n0 + (mat >> 1) * 8);
}

// The same for one tile n0.
__device__ __forceinline__ void frag_b_mn1(uint32_t (&b)[2], const bf16* B, int ld, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x2_t(b, B + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0);
}

// acc[j] += A[m0:m0+16, 0:k1] . B[n0+8j : n0+8j+8, 0:k1]^T for j < nt, both
// stored with k contiguous.  ALO / BLO: the operand has a lo part.
template <int NT, bool ALO, bool BLO>
__device__ __forceinline__ void mma_kk(float (&acc)[NT][4], const bf16* Ah, const bf16* Al,
                                       int lda, int m0, const bf16* Bh, const bf16* Bl,
                                       int ldb, int n0, int nt, int k1) {
  for (int k = 0; k < k1; k += 16) {
    uint32_t ah[4], al[4];
    frag_a_k(ah, Ah, lda, m0, k);
    if constexpr (ALO) frag_a_k(al, Al, lda, m0, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bh[2];
        frag_b_k(bh, Bh, ldb, n0 + 8 * j, k);
        mma(acc[j], ah, bh[0], bh[1]);
        if constexpr (BLO) {
          uint32_t bl[2];
          frag_b_k(bl, Bl, ldb, n0 + 8 * j, k);
          mma(acc[j], ah, bl[0], bl[1]);
        }
        if constexpr (ALO) mma(acc[j], al, bh[0], bh[1]);
      }
    }
  }
}

// The same with B stored [k][n] (n contiguous), and A stored [m][k] or,
// with A_MN, [k][m].
template <int NT, bool A_MN, bool ALO, bool BLO>
__device__ __forceinline__ void mma_mn(float (&acc)[NT][4], const bf16* Ah, const bf16* Al,
                                       int lda, int m0, const bf16* Bh, const bf16* Bl,
                                       int ldb, int n0, int nt, int k1) {
  for (int k = 0; k < k1; k += 16) {
    uint32_t ah[4], al[4];
    if constexpr (A_MN) frag_a_mn(ah, Ah, lda, m0, k);
    else frag_a_k(ah, Ah, lda, m0, k);
    if constexpr (ALO) {
      if constexpr (A_MN) frag_a_mn(al, Al, lda, m0, k);
      else frag_a_k(al, Al, lda, m0, k);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j + 1 < nt) {  // two tiles from one ldmatrix
        uint32_t bh[4];
        frag_b_mn2(bh, Bh, ldb, n0 + 8 * j, k);
        mma(acc[j], ah, bh[0], bh[1]);
        mma(acc[j + 1], ah, bh[2], bh[3]);
        if constexpr (BLO) {
          uint32_t bl[4];
          frag_b_mn2(bl, Bl, ldb, n0 + 8 * j, k);
          mma(acc[j], ah, bl[0], bl[1]);
          mma(acc[j + 1], ah, bl[2], bl[3]);
        }
        if constexpr (ALO) {
          mma(acc[j], al, bh[0], bh[1]);
          mma(acc[j + 1], al, bh[2], bh[3]);
        }
      } else if (j < nt) {
        uint32_t bh[2];
        frag_b_mn1(bh, Bh, ldb, n0 + 8 * j, k);
        mma(acc[j], ah, bh[0], bh[1]);
        if constexpr (BLO) {
          uint32_t bl[2];
          frag_b_mn1(bl, Bl, ldb, n0 + 8 * j, k);
          mma(acc[j], ah, bl[0], bl[1]);
        }
        if constexpr (ALO) mma(acc[j], al, bh[0], bh[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Staging: global rows into bf16 hi (/ lo) tiles of shared memory
// ---------------------------------------------------------------------------

// Eight consecutive elements from p (``valid`` of them real, the rest 0),
// 16 bytes a load when ``vec`` (p 16-byte aligned) and all eight are real.
__device__ __forceinline__ void load8(const bf16* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(q[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? __bfloat162float(p[e]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// Store v[0:N] (N 4 or 8) as bf16 at hi, and with LO the rounding rest
// v - hi as bf16 at lo (8- or 16-byte stores; the addresses are aligned).
template <bool LO, int N>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, const float* v) {
  uint32_t h[N / 2], l[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const bf16 h0 = __float2bfloat16_rn(v[2 * k]);
    const bf16 h1 = __float2bfloat16_rn(v[2 * k + 1]);
    h[k] = pack2(h0, h1);
    if constexpr (LO)
      l[k] = pack2(__float2bfloat16_rn(v[2 * k] - __bfloat162float(h0)),
                   __float2bfloat16_rn(v[2 * k + 1] - __bfloat162float(h1)));
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (LO) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
  } else {
    *reinterpret_cast<uint2*>(hi) = make_uint2(h[0], h[1]);
    if constexpr (LO) *reinterpret_cast<uint2*>(lo) = make_uint2(l[0], l[1]);
  }
}

// rows [0, rows) of a row-major global matrix (row r at src + r * stride,
// ``cols`` real columns; rows from ``rows_valid`` on are zero) into the
// tile hi (/ lo) [rows][ld], columns zero-padded to cols_pad (a multiple
// of 8).  With ``scale`` each row is multiplied by scale[r] first.
template <bool LO, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long stride, int rows,
                                      int rows_valid, int cols, int cols_pad, bool vec,
                                      const float* scale, bf16* hi, bf16* lo, int ld) {
  constexpr int kBatch = 4;  // loads in flight a thread
  const int per_row = cols_pad / 8, total = rows * per_row;
  for (int v0 = threadIdx.x; v0 < total; v0 += kBatch * kThreads) {
    float e[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * kThreads;
      const int r = v / per_row, c = (v % per_row) * 8;
      const int valid = v < total && r < rows_valid ? min(8, cols - c) : 0;
      load8(src + r * stride + c, valid, vec, e[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= total) break;
      const int r = v / per_row, c = (v % per_row) * 8;
      if (scale != nullptr && r < rows_valid) {
        const float sc = scale[r];
#pragma unroll
        for (int k = 0; k < 8; ++k) e[u][k] *= sc;
      }
      store_split<LO, 8>(hi + r * ld + c, lo + r * ld + c, e[u]);
    }
  }
}

// Asynchronous copies: 16 bytes a thread straight into shared memory
// (cp.async), so the next tile's loads fly while this tile's products run.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(bf16& v) { v = __float2bfloat16_rn(0.f); }

// rows [0, rows) of a row-major global matrix (row r at src + r * stride,
// ``cols`` real columns) into dst [rows][ld] (columns up to cols_pad) of
// the same type, zero past rows_valid and cols: cp.async of 16 bytes when
// ``vec`` (16-byte aligned rows of whole 16-byte pieces), else element
// loads.
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ src, long stride, int rows,
                                      int rows_valid, int cols, int cols_pad, bool vec,
                                      T* raw, int ld) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = cols_pad / E;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v % per_row) * E;
    T* dst = raw + r * ld + c;
    const bool real = r < rows_valid && c < cols;
    if (vec) {
      cp_async16(dst, real ? src + r * stride + c : src, real ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (real && c + e < cols) dst[e] = src[r * stride + c + e];
        else set_zero(dst[e]);
      }
    }
  }
}

// raw [rows][cols_pad] (shared memory) into the tile hi (/ lo) [rows][ld];
// with ``scale`` each of the first rows_valid rows is multiplied by
// scale[r] first.
template <bool LO, typename T>
__device__ __forceinline__ void convert(const T* raw, int rows, int rows_valid, int cols_pad,
                                        const float* scale, bf16* hi, bf16* lo, int ld) {
  const int per_row = cols_pad / 8;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v % per_row) * 8;
    if constexpr (std::is_same<T, bf16>::value && !LO) {
      if (scale == nullptr) {  // bf16 as it is: a 16-byte copy
        *reinterpret_cast<uint4*>(hi + r * ld + c) =
            *reinterpret_cast<const uint4*>(raw + r * cols_pad + c);
        continue;
      }
    }
    float e[8];
    load8(raw + r * cols_pad + c, 8, true, e);
    if (scale != nullptr && r < rows_valid) {
      const float s = scale[r];
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] *= s;
    }
    store_split<LO, 8>(hi + r * ld + c, lo + r * ld + c, e);
  }
}

// La = inclusive cumulative sum of dt * a over the chunk's Q rows (dt at
// dt[t * nh]), by warp scans: thread t owns rows 4t .. 4t+3 (Q <= 1024).
// Fills sDt and sLa for rows < Qp (past Q: dt 0, La = Ltot).
__device__ __forceinline__ void chunk_scan(const float* __restrict__ dt, int nh, float a,
                                           int Q, int Qp, float* sDt, float* sLa) {
  __shared__ float warp_tot[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float d[4], loc[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * tid + k;
    d[k] = t < Q ? dt[(long)t * nh] : 0.f;
    run += d[k] * a;
    loc[k] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  float base = inc - run;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * tid + k;
    if (t < Qp) {
      sDt[t] = d[k];
      sLa[t] = base + loc[k];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The four kernels
// ---------------------------------------------------------------------------

struct Dims {
  int S, nh, N, Q, Qp, Np, nc;
};

// 1. C.B^T of one 64 x 64 tile (ti, tj), tj <= ti, of one (batch, chunk),
//    float32 into cb [B][nc][Qp][Qp].  Warp w: rows 16 (w % 4), columns
//    32 (w / 4) of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb, Dims d,
    bool vec) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = d.Np + 8;
  bf16* sCh = reinterpret_cast<bf16*>(smem_raw);
  bf16* sCl = sCh + kT * ldn;
  bf16* sBh = sCh + (kSplit ? 2 : 1) * kT * ldn;
  bf16* sBl = sBh + kT * ldn;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const long row0 = (long)b * d.S + (long)c * d.Q;
  const int i0 = ti * kT, j0 = tj * kT;
  stage<kSplit>(Cm + (row0 + i0) * d.N, d.N, kT, d.Q - i0, d.N, d.Np, vec, nullptr, sCh,
                sCl, ldn);
  stage<kSplit>(Bm + (row0 + j0) * d.N, d.N, kT, d.Q - j0, d.N, d.Np, vec, nullptr, sBh,
                sBl, ldn);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float acc[4][4] = {};
  mma_kk<4, kSplit, kSplit>(acc, sCh, sCl, ldn, m0, sBh, sBl, ldn, n0, 4, d.Np);
  float* out = cb + ((long)(b * d.nc + c) * d.Qp + i0 + m0 + (lane >> 2)) * d.Qp + j0 + n0 +
               2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + 8 * d.Qp + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
}

// 2. The chunk-local state of one (batch, chunk, head), s = x^T (B * w) with
//    w_j = exp(Ltot - La_j) dt_j, float32 into states [B][nc][nh][HP][N],
//    and Ltot into ltot [B][nc][nh].  Warp w: rows 16 (w % MT) of the state,
//    NT2 8-column tiles of its column group w / MT; wide N takes passes.
//    The next 64 rows of x and B are copied in while this tile's products
//    run.
template <typename T, int HP>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, float* __restrict__ states, float* __restrict__ ltot, Dims d,
    bool vec_b, bool vec_x) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int MT = HP / 16, G = 8 / MT, NT2 = HP == 128 ? 16 : 8;
  constexpr int ldx = HP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = d.Np + 8;
  float* sDt = reinterpret_cast<float*>(smem_raw);
  float* sLa = sDt + d.Qp;
  float* sW = sLa + d.Qp;
  T* rawX = reinterpret_cast<T*>(sW + d.Qp);  // [kT][HP]
  T* rawB = rawX + kT * HP;                   // [kT][Np]
  bf16* sXh = reinterpret_cast<bf16*>(rawB + kT * d.Np);
  bf16* sXl = sXh + kT * ldx;
  bf16* sBh = sXh + (kSplit ? 2 : 1) * kT * ldx;
  bf16* sBl = sBh + kT * ldn;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long row0 = (long)b * d.S + (long)c * d.Q;
  auto prefetch = [&](int j0) {
    fetch(x + ((row0 + j0) * d.nh + h) * HP, (long)d.nh * HP, kT, d.Q - j0, HP, HP, vec_x,
          rawX, HP);
    fetch(Bm + (row0 + j0) * d.N, d.N, kT, d.Q - j0, d.N, d.Np, vec_b, rawB, d.Np);
  };
  prefetch(0);
  chunk_scan(dt + row0 * d.nh + h, d.nh, A[h], d.Q, d.Qp, sDt, sLa);
  const float Ltot = sLa[d.Q - 1];
  for (int t = threadIdx.x; t < d.Qp; t += kThreads)
    sW[t] = t < d.Q ? expf(Ltot - sLa[t]) * sDt[t] : 0.f;
  const long bch = (long)(b * d.nc + c) * d.nh + h;
  if (threadIdx.x == 0) ltot[bch] = Ltot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp % MT) * 16, grp = warp / MT;
  float* out = states + bch * HP * d.N;
  for (int pass = 0; pass < d.Np; pass += G * NT2 * 8) {
    const int n0 = pass + grp * NT2 * 8;
    const int nt = min(NT2, max(0, (d.Np - n0) / 8));
    float acc[NT2][4] = {};
    if (pass > 0) prefetch(0);
    for (int j0 = 0; j0 < d.Q; j0 += kT) {
      cp_async_wait_all();
      __syncthreads();  // the tile is in (and sW); the last tile's readers are done
      convert<kSplit>(rawX, kT, kT, HP, nullptr, sXh, sXl, ldx);
      convert<true>(rawB, kT, d.Q - j0, d.Np, sW + j0, sBh, sBl, ldn);
      __syncthreads();
      if (j0 + kT < d.Q) prefetch(j0 + kT);
      mma_mn<NT2, true, kSplit, true>(acc, sXh, sXl, ldx, m0, sBh, sBl, ldn, n0, nt, kT);
    }
    const int p = m0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (j < nt) {
        if (n < d.N) out[p * d.N + n] = acc[j][0];
        if (n + 1 < d.N) out[p * d.N + n + 1] = acc[j][1];
        if (n < d.N) out[(p + 8) * d.N + n] = acc[j][2];
        if (n + 1 < d.N) out[(p + 8) * d.N + n + 1] = acc[j][3];
      }
    }
  }
}

// 3. In series over the chunks, for 4 consecutive floats of the hp x N
//    state a thread: states[c] <- h (the state chunk c starts from), then
//    h <- exp(Ltot_c) h + s_c; the final h into hout [B][nh][HP][N].  The
//    chunks' loads go out kPassDepth at a time.
constexpr int kPassDepth = 8;

__global__ void __launch_bounds__(kThreads) ssd_pass_kernel(
    float* __restrict__ states, const float* __restrict__ ltot, float* __restrict__ hout,
    int nh, int nc, int size) {
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= size) return;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 s[kPassDepth];
    float l[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      if (c0 + k < nc) {
        const long bch = (long)(b * nc + c0 + k) * nh + h;
        s[k] = *reinterpret_cast<const float4*>(states + bch * size + e);
        l[k] = ltot[bch];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      if (c0 + k < nc) {
        const long bch = (long)(b * nc + c0 + k) * nh + h;
        *reinterpret_cast<float4*>(states + bch * size + e) = run;
        const float g = expf(l[k]);
        run = make_float4(g * run.x + s[k].x, g * run.y + s[k].y, g * run.z + s[k].z,
                          g * run.w + s[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(hout + ((long)b * nh + h) * size + e) = run;
}

// 4. y of one (batch, chunk, head), 64 rows at a time: the carried-state
//    term exp(La_i) (C_i . h^T), then the causal tiles j <= i of
//    (C.B^T * exp(La_i - La_j) * dt_j) . x_j.  Warp w: rows 16 (w % 4),
//    columns HP/2 (w / 4).  The next tile's x and C.B^T are copied in while
//    this tile's products run.
template <typename T, int HP>
__global__ void __launch_bounds__(kThreads) ssd_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Cm, const float* __restrict__ cb, const float* __restrict__ states,
    float* __restrict__ y, Dims d, bool vec_c, bool vec_x, bool vec_s) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NT = HP / 16;
  constexpr int ldx = HP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = d.Np + 8;
  float* sDt = reinterpret_cast<float*>(smem_raw);
  float* sLa = sDt + d.Qp;
  float* sU = sLa + d.Qp;                      // [kT] exp(La_i - La_r)
  float* sV = sU + kT;                          // [kT] exp(La_r - La_j) dt_j
  float* rawCB = sV + kT;                       // [kT][kT]
  T* rawX = reinterpret_cast<T*>(rawCB + kT * kT);  // [kT][HP]
  bf16* sHh = reinterpret_cast<bf16*>(rawX + kT * HP);
  bf16* sHl = sHh + HP * ldn;
  bf16* sCh = sHl + HP * ldn;
  bf16* sCl = sCh + kT * ldn;
  bf16* sXh = sCh + (kSplit ? 2 : 1) * kT * ldn;
  bf16* sXl = sXh + kT * ldx;
  bf16* sPh = sXh + (kSplit ? 2 : 1) * kT * ldx;
  bf16* sPl = sPh + kT * kLdT;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long row0 = (long)b * d.S + (long)c * d.Q;
  const long bch = (long)(b * d.nc + c) * d.nh + h;
  const float* cbc = cb + (long)(b * d.nc + c) * d.Qp * d.Qp;
  auto prefetch = [&](int i0, int j0) {
    fetch(x + ((row0 + j0) * d.nh + h) * HP, (long)d.nh * HP, kT, d.Q - j0, HP, HP, vec_x,
          rawX, HP);
    fetch(cbc + (long)i0 * d.Qp + j0, d.Qp, kT, kT, kT, kT, true, rawCB, kT);
  };
  // bf16 C rows go into sC as they are, by cp.async: the next row tile's
  // while this one's score tiles run (float32 C is split as it is staged)
  auto prefetch_c = [&](int i0) {
    if constexpr (!kSplit)
      fetch(Cm + (row0 + i0) * d.N, d.N, kT, d.Q - i0, d.N, d.Np, vec_c, sCh, ldn);
  };
  if (c > 0) prefetch_c(0);
  prefetch(0, 0);
  chunk_scan(dt + row0 * d.nh + h, d.nh, A[h], d.Q, d.Qp, sDt, sLa);
  if (c > 0)  // the state chunk c starts from (zero for the first chunk)
    stage<true>(states + bch * HP * d.N, d.N, HP, HP, d.N, d.Np, vec_s, nullptr, sHh, sHl,
                ldn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, m0 = wr * 16, n0 = (warp >> 2) * (HP / 2);
  for (int i0 = 0; i0 < d.Q; i0 += kT) {
    float acc[NT][4] = {};
    const int r_lo = i0 + m0 + (lane >> 2), r_hi = r_lo + 8;
    if (c > 0) {
      if constexpr (kSplit) {
        __syncthreads();  // sC's last readers are done
        stage<true>(Cm + (row0 + i0) * d.N, d.N, kT, d.Q - i0, d.N, d.Np, vec_c, nullptr,
                    sCh, sCl, ldn);
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      mma_kk<NT, kSplit, true>(acc, sCh, sCl, ldn, m0, sHh, sHl, ldn, n0, NT, d.Np);
      const float g_lo = expf(sLa[r_lo]), g_hi = expf(sLa[r_hi]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= g_lo;
        acc[j][1] *= g_lo;
        acc[j][2] *= g_hi;
        acc[j][3] *= g_hi;
      }
    }
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      cp_async_wait_all();
      __syncthreads();  // the tile is in; sX and sP's last readers are done
      convert<kSplit>(rawX, kT, kT, HP, nullptr, sXh, sXl, ldx);
      // the scores of the tile, 4 columns a thread, only where j <= i.  Off
      // the diagonal exp(La_i - La_j) = u_i v_j with u_i = exp(La_i - La_r)
      // and v_j = exp(La_r - La_j) dt_j about the tile's last column r, so
      // the tile takes 2 x 64 exps: both factors are at most 1 there (a
      // factor underflows only where the score is below 1e-38 of C.B^T).
      // On the diagonal u_i could overflow (64 steps of dt A reach -100 in
      // trained models), so each score takes its own exp, of a value <= 0.
      const bool diag = j0 == i0;
      if (!diag) {
        const float la_r = sLa[j0 + kT - 1];
        if (threadIdx.x < kT) sU[threadIdx.x] = expf(sLa[i0 + threadIdx.x] - la_r);
        else if (threadIdx.x < 2 * kT)
          sV[threadIdx.x - kT] =
              expf(la_r - sLa[j0 + threadIdx.x - kT]) * sDt[j0 + threadIdx.x - kT];
      }
      __syncthreads();
      for (int v = threadIdx.x; v < kT * kT / 4; v += kThreads) {
        const int ii = v / (kT / 4), jj = (v % (kT / 4)) * 4;
        const int i = i0 + ii, j = j0 + jj;
        // rows and columns past Q hold zeros (C.B^T of zero rows; dt 0),
        // so only the diagonal's upper half needs the mask
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (j <= i) {
          const float4 q = *reinterpret_cast<const float4*>(rawCB + ii * kT + jj);
          const float cq[4] = {q.x, q.y, q.z, q.w};
          if (diag) {
            const float la = sLa[i];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (j + k <= i) s[k] = cq[k] * expf(la - sLa[j + k]) * sDt[j + k];
          } else {
            const float4 w = *reinterpret_cast<const float4*>(sV + jj);
            const float u = sU[ii];
            s[0] = cq[0] * (u * w.x);
            s[1] = cq[1] * (u * w.y);
            s[2] = cq[2] * (u * w.z);
            s[3] = cq[3] * (u * w.w);
          }
        }
        store_split<true, 4>(sPh + ii * kLdT + jj, sPl + ii * kLdT + jj, s);
      }
      __syncthreads();
      if (c > 0 && j0 == 0 && i0 + kT < d.Q) prefetch_c(i0 + kT);  // sC's readers are done
      if (j0 < i0) prefetch(i0, j0 + kT);
      else if (i0 + kT < d.Q) prefetch(i0 + kT, 0);
      // above the diagonal the warp's rows see only zero scores
      const int k1 = j0 == i0 ? m0 + 16 : kT;
      mma_mn<NT, false, true, kSplit>(acc, sPh, sPl, kLdT, m0, sXh, sXl, ldx, n0, NT, k1);
    }
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // streaming stores: y is not read again here
      if (r_lo < d.Q)
        __stcs(reinterpret_cast<float2*>(y + ((row0 + r_lo) * d.nh + h) * HP + col + 8 * j),
               make_float2(acc[j][0], acc[j][1]));
      if (r_hi < d.Q)
        __stcs(reinterpret_cast<float2*>(y + ((row0 + r_hi) * d.nh + h) * HP + col + 8 * j),
               make_float2(acc[j][2], acc[j][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Smem {
  int cb, state, out;
};

// Dynamic shared memory of each kernel, in bytes.
Smem smem_of(int HP, bool split, const Dims& d) {
  const int planes = split ? 2 : 1, ldn = d.Np + 8, ldx = HP + 8;
  Smem s;
  s.cb = 2 * planes * kT * ldn * 2;
  const int in = split ? 4 : 2;  // bytes of an input element
  s.state = 3 * d.Qp * 4 + kT * (HP + d.Np) * in + planes * kT * ldx * 2 + 2 * kT * ldn * 2;
  s.out = 2 * d.Qp * 4 + 2 * kT * 4 + kT * kT * 4 + kT * HP * in + 2 * HP * ldn * 2 +
          planes * kT * ldn * 2 + planes * kT * ldx * 2 + 2 * kT * kLdT * 2;
  return s;
}

Dims dims(int S, int nh, int N, int Q) {
  return Dims{S, nh, N, Q, round_up(Q, kT), round_up(N, 16), S / Q};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HP>
cudaError_t launch(const void* x_, const void* dt_, const void* A_, const void* Bm_,
                   const void* Cm_, void* y_, void* h_, void* scratch, int B, int S, int nh,
                   int N, int Q, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const float* dt = static_cast<const float*>(dt_);
  const float* A = static_cast<const float*>(A_);
  const T* Bm = static_cast<const T*>(Bm_);
  const T* Cm = static_cast<const T*>(Cm_);
  const Dims d = dims(S, nh, N, Q);
  const Smem sm = smem_of(HP, std::is_same<T, float>::value, d);
  if (sm.cb > kMaxSmem || sm.state > kMaxSmem || sm.out > kMaxSmem)
    return cudaErrorInvalidValue;
  float* cb = static_cast<float*>(scratch);
  float* states = cb + (long)B * d.nc * d.Qp * d.Qp;
  float* ltot = states + (long)B * d.nc * nh * HP * N;
  const bool vec_bc = N % (16 / (int)sizeof(T)) == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_x = aligned16(x);
  const bool vec_s = N % 4 == 0;
  auto k_cb = ssd_cb_kernel<T>;
  auto k_state = ssd_state_kernel<T, HP>;
  auto k_out = ssd_out_kernel<T, HP>;
  cudaError_t err = allow_smem(k_cb, sm.cb);
  if (err == cudaSuccess) err = allow_smem(k_state, sm.state);
  if (err == cudaSuccess) err = allow_smem(k_out, sm.out);
  if (err != cudaSuccess) return err;
  const int tiles = d.Qp / kT;
  k_cb<<<dim3(tiles * (tiles + 1) / 2, d.nc, B), kThreads, sm.cb, st>>>(Bm, Cm, cb, d,
                                                                        vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_state<<<dim3(nh, d.nc, B), kThreads, sm.state, st>>>(x, dt, A, Bm, states, ltot, d,
                                                         vec_bc, vec_x);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int size = HP * N;
  ssd_pass_kernel<<<dim3((size / 4 + kThreads - 1) / kThreads, nh, B), kThreads, 0, st>>>(
      states, ltot, static_cast<float*>(h_), nh, d.nc, size);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_out<<<dim3(nh, d.nc, B), kThreads, sm.out, st>>>(x, dt, A, Cm, cb, states,
                                                     static_cast<float*>(y_), d, vec_bc,
                                                     vec_x, vec_s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hp(int hp, const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, void* y, void* h, void* scratch, int B, int S, int nh,
                      int N, int Q, cudaStream_t st) {
  switch (hp) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
    case 128: return launch<T, 128>(x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Whether the kernels take a shape: 0 when they do, with the float32 words
// of scratch a call needs in *scratch_floats; 1 for an hp, chunk, size or
// type they do not take; 2 when a kernel would need more than a block's
// 227 KB of shared memory.  *smem_bytes is the largest kernel's need.
int ssd_scan_plan(int B, int S, int nh, int hp, int N, int Q, int dtype,
                  long long* scratch_floats, int* smem_bytes) {
  *scratch_floats = 0;
  *smem_bytes = 0;
  if ((hp != 16 && hp != 32 && hp != 64 && hp != 128) || Q < 1 || Q > kMaxChunk || N < 1 ||
      S % Q != 0 || (dtype != 0 && dtype != 1))
    return 1;
  const Dims d = dims(S, nh, N, Q);
  const Smem sm = smem_of(hp, dtype == 0, d);
  *smem_bytes = sm.cb > sm.state ? (sm.cb > sm.out ? sm.cb : sm.out)
                                 : (sm.state > sm.out ? sm.state : sm.out);
  *scratch_floats = (long long)B * d.nc * ((long long)d.Qp * d.Qp + (long long)nh * hp * N + nh);
  return *smem_bytes > kMaxSmem ? 2 : 0;
}

int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                    const void* Cm, void* y, void* h, void* scratch, int B, int S, int nh,
                    int hp, int N, int Q, int dtype, void* stream) {
  if (Q < 1 || Q > kMaxChunk || N < 1 || S % Q != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hp<float>(hp, x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
  if (dtype == 1)
    return launch_hp<bf16>(hp, x, dt, A, Bm, Cm, y, h, scratch, B, S, nh, N, Q, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
