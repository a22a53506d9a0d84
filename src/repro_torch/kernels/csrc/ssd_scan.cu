// Mamba2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py:
//   * ssd_scan (_kernel, pallas_call at :102)
//
// What bounds it on this card: bytes.  At mamba2-2.7b's layer (B 2,
// S 4096, nh 80, hp 64, N 128, chunk Q 256) the function needs, two
// operations a multiply-add, the causal half of C.B^T once per (batch,
// chunk) (2.7e8), and per (batch, head, chunk) the causal half of scores.x
// (1.08e10), the carried-state term and the state update (1.07e10 each):
// 3.25e10 operations, 0.033 ms at the bf16 tensor-core rate.  Each input
// read once and y (float32) and h written once move 263.7 MB, 0.079 ms at
// 3.35 TB/s, which is the bound.  This kernel, like the TPU kernel, does
// more: it recomputes C.B^T for every head (80x that term) -- computing it
// once per (batch, chunk) is left for the PR that makes this kernel fast.
//
// What the design does about it, simply: the (hp x N) state never leaves
// shared memory between chunks, so device memory sees one read of x, dt, B
// and C and one write of y per token, and the Q x Q score block never
// exists in device memory either.  The arithmetic is float32 FMAs on the
// CUDA cores, not wgmma: this first version is right and simple.
//
// Layout for Hopper: one block of 256 threads per (head, batch).  The TPU's
// sequential chunk grid axis cannot carry state between CUDA blocks, so the
// block walks the chunks in a loop.  Per chunk it stages dt, takes the
// inclusive cumulative sum La of dt*A with a block scan, and walks the
// chunk's rows in 64-row sub-tiles i; for each it stages C_i, adds the
// carried-state term exp(La_i)*(C_i.h^T), then for every 64-row sub-tile
// j <= i stages B_j and x_j, forms the 64 x 64 scores (C_i.B_j) *
// exp(La_i - La_j) * dt_j only where j <= i (exp is never taken above the
// diagonal, where the reference computes it and masks it with where), and
// adds scores.x_j.  The last sub-tile i visits every j, so the state update
// h <- exp(La_Q)*h + sum_j x_j^T (B_j*exp(La_Q - La_j)*dt_j) rides along
// with it after its carried-state term has read h.  Sub-tiling the rows is
// what keeps shared memory in bounds: a whole chunk's B and C at mamba2's
// shape (Q 256, N 128) would take 256 KB in float32, above a block's 227 KB;
// the sub-tiled working set there is 136 KB (dynamic shared memory, opted
// in with cudaFuncSetAttribute).
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int; dtype 0 is float32, 1 bfloat16 for x, B and C (dt and A are always
// float32).  Tensors are contiguous: x (B, S, nh, hp), dt (B, S, nh), A
// (nh,), B and C (B, S, N); y (B, S, nh, hp) and h (B, nh, hp, N) float32.
// S is a multiple of Q.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an hp, chunk or type it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a sub-tile
constexpr int kRG = 16;         // 16 x 16 threads; 4 rows x 4 columns each
constexpr int kRI = kT / kRG;   // rows (and score columns) per thread
constexpr int kLDP = kT + 1;    // padded row of the score tile
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HP>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ hout,
    int S, int nh, int N, int Q) {
  constexpr int OJ = HP / kRG;   // y columns per thread
  constexpr int LDX = HP + 1;    // padded row of the x tile
  const int LDN = N + 1;         // padded row of the state, B and C tiles
  extern __shared__ float smem[];
  float* sH = smem;              // HP x LDN   the carried state
  float* sC = sH + HP * LDN;     // kT x LDN   C rows of sub-tile i
  float* sB = sC + kT * LDN;     // kT x LDN   B rows of sub-tile j
  float* sX = sB + kT * LDN;     // kT x LDX   x rows of sub-tile j
  float* sP = sX + kT * LDX;     // kT x kLDP  scores of (i, j)
  float* sDt = sP + kT * kLDP;   // Q
  float* sW = sDt + Q;           // Q   exp(La_Q - La_j) * dt_j
  float* sScan = sW + Q;         // 2Q  ping-pong buffers of the scan

  const int tid = threadIdx.x;
  const int ty = tid / kRG, tx = tid % kRG;
  const int hd = blockIdx.x, b = blockIdx.y;
  const float a_h = A[hd];
  const long row0 = (long)b * S;  // position 0 of this batch row

  for (int e = tid; e < HP * N; e += kThreads) sH[(e / N) * LDN + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the last chunk is done with every buffer
    float* src = sScan;
    float* dst = sScan + Q;
    for (int t = tid; t < Q; t += kThreads) {
      const float d = dt[(row0 + c0 + t) * nh + hd];
      sDt[t] = d;
      src[t] = d * a_h;
    }
    __syncthreads();
    for (int off = 1; off < Q; off <<= 1) {  // inclusive scan
      for (int t = tid; t < Q; t += kThreads)
        dst[t] = t >= off ? src[t] + src[t - off] : src[t];
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    const float* La = src;
    const float Ltot = La[Q - 1];
    for (int t = tid; t < Q; t += kThreads) sW[t] = expf(Ltot - La[t]) * sDt[t];

    for (int i0 = 0; i0 < Q; i0 += kT) {
      const bool last = i0 + kT >= Q;
      __syncthreads();  // sW is in; the last sub-tile's readers are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N, t = i0 + r;
        sC[r * LDN + n] = t < Q ? to_f(Cm[(row0 + c0 + t) * N + n]) : 0.f;
      }
      __syncthreads();

      // carried-state term: exp(La_i) * (C_i . h^T)
      float acc[kRI][OJ];
#pragma unroll
      for (int a = 0; a < kRI; ++a)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[a][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float ca[kRI], hv[OJ];
#pragma unroll
        for (int a = 0; a < kRI; ++a) ca[a] = sC[(ty + kRG * a) * LDN + n];
#pragma unroll
        for (int j = 0; j < OJ; ++j) hv[j] = sH[(tx + kRG * j) * LDN + n];
#pragma unroll
        for (int a = 0; a < kRI; ++a)
#pragma unroll
          for (int j = 0; j < OJ; ++j) acc[a][j] = fmaf(ca[a], hv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < kRI; ++a) {
        const int i = i0 + ty + kRG * a;
        const float g = i < Q ? expf(La[i]) : 0.f;
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[a][j] *= g;
      }
      if (last) {  // h has been read for this chunk: decay it across the chunk
        __syncthreads();
        const float dec = expf(Ltot);
        for (int e = tid; e < HP * N; e += kThreads) sH[(e / N) * LDN + e % N] *= dec;
      }

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int jn = min(kT, Q - j0);
        __syncthreads();
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          sB[r * LDN + n] = r < jn ? to_f(Bm[(row0 + c0 + j0 + r) * N + n]) : 0.f;
        }
        for (int e = tid; e < kT * HP; e += kThreads) {
          const int r = e / HP, p = e % HP;
          sX[r * LDX + p] =
              r < jn ? to_f(x[((row0 + c0 + j0 + r) * nh + hd) * HP + p]) : 0.f;
        }
        __syncthreads();

        float s[kRI][kRI];
#pragma unroll
        for (int a = 0; a < kRI; ++a)
#pragma unroll
          for (int c = 0; c < kRI; ++c) s[a][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float ca[kRI], ba[kRI];
#pragma unroll
          for (int a = 0; a < kRI; ++a) ca[a] = sC[(ty + kRG * a) * LDN + n];
#pragma unroll
          for (int c = 0; c < kRI; ++c) ba[c] = sB[(tx + kRG * c) * LDN + n];
#pragma unroll
          for (int a = 0; a < kRI; ++a)
#pragma unroll
            for (int c = 0; c < kRI; ++c) s[a][c] = fmaf(ca[a], ba[c], s[a][c]);
        }
#pragma unroll
        for (int a = 0; a < kRI; ++a) {
          const int i = i0 + ty + kRG * a;
#pragma unroll
          for (int c = 0; c < kRI; ++c) {
            const int j = j0 + tx + kRG * c;
            sP[(ty + kRG * a) * kLDP + tx + kRG * c] =
                (j <= i && i < Q) ? s[a][c] * expf(La[i] - La[j]) * sDt[j] : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int jj = 0; jj < kT; ++jj) {
          float pa[kRI], xv[OJ];
#pragma unroll
          for (int a = 0; a < kRI; ++a) pa[a] = sP[(ty + kRG * a) * kLDP + jj];
#pragma unroll
          for (int j = 0; j < OJ; ++j) xv[j] = sX[jj * LDX + tx + kRG * j];
#pragma unroll
          for (int a = 0; a < kRI; ++a)
#pragma unroll
            for (int j = 0; j < OJ; ++j) acc[a][j] = fmaf(pa[a], xv[j], acc[a][j]);
        }
        if (last) {  // h += x_j^T (B_j * w_j)
          for (int e = tid; e < HP * N; e += kThreads) {
            const int p = e / N, n = e % N;
            float u = 0.f;
            for (int jj = 0; jj < jn; ++jj)
              u = fmaf(sX[jj * LDX + p], sB[jj * LDN + n] * sW[j0 + jj], u);
            sH[p * LDN + n] += u;
          }
        }
      }

#pragma unroll
      for (int a = 0; a < kRI; ++a) {
        const int i = i0 + ty + kRG * a;
        if (i >= Q) continue;
        float* yr = y + ((row0 + c0 + i) * nh + hd) * HP;
#pragma unroll
        for (int j = 0; j < OJ; ++j) yr[tx + kRG * j] = acc[a][j];
      }
    }
  }
  __syncthreads();
  float* ho = hout + ((long)b * nh + hd) * HP * N;
  for (int e = tid; e < HP * N; e += kThreads) ho[e] = sH[(e / N) * LDN + e % N];
}

template <typename T, int HP>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* h, int B, int S, int nh, int N,
                   int Q, cudaStream_t st) {
  const long floats = (long)(HP + 2 * kT) * (N + 1) + (long)kT * (HP + 1) +
                      (long)kT * kLDP + 4L * Q;
  const long bytes = floats * (long)sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;  // a block's 227 KB
  auto kern = ssd_kernel<T, HP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(h), S, nh, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hp(int hp, const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, void* h, int B,
                      int S, int nh, int N, int Q, cudaStream_t st) {
  switch (hp) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
    case 128: return launch<T, 128>(x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* h, int B,
                    int S, int nh, int hp, int N, int Q, int dtype,
                    void* stream) {
  if (Q < 1 || Q > kMaxChunk || N < 1 || S % Q != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hp<float>(hp, x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
  if (dtype == 1)
    return launch_hp<__nv_bfloat16>(hp, x, dt, A, Bm, Cm, y, h, B, S, nh, N, Q, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
