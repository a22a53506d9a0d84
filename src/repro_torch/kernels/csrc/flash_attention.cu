// Flash attention (causal / sliding window / GQA / softcap) on Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py:
//   * flash_attention (_kernel, pallas_call at :127)
//
// What bounds it on this card: operations.  At hymba-1.5b's prefill
// (B 4, S 2048, H 25 over KVH 5, hd 64, window 1024) the unmasked (q, k)
// pairs number 1.573e8, at 4*hd flops each (q.k and p.v): 4.0e10 flops,
// 0.041 ms at the bf16 tensor-core rate (989 TFLOP/s), and 0.081 ms at the
// TF32 rate (495 TFLOP/s), the fastest the card takes float32 operands.
// The float32 route issues three TF32 products for each: 1.21e11 flops,
// 0.244 ms at that rate (the work once in float32 FMAs outside the tensor
// cores would take 0.60 ms at 67 TFLOP/s).  Each input read once
// and the output written once move 63 MB in bf16, 0.019 ms at 3.35 TB/s
// (126 MB in float32, 0.038 ms).
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
// float32 (the parity runs, held to 2e-5): flash_kernel_tf32, both
// products on the tensor cores as a three-pass TF32 split (3xTF32).  One
// TF32 product keeps 10 mantissa bits, about three decimal digits, which
// the exp of a score of size 9 turns into errors 400 times the tolerance.
// So every float32 operand x is split into hi = tf32(x) (cvt.rna: to
// nearest, low 13 bits zero) and lo = tf32(x - hi), and a product is
// lo.hi + hi.lo + hi.hi, three wgmma m64nNk8 .tf32 chains into one float32
// accumulator (lo.lo, about 2^-22 of it, is left out).  hi and lo are
// stored already rounded, since wgmma truncates the float32 bits it reads.
//   * Pre-pass, flash_split_kv_kernel, once per call: K -> K_hi, K_lo
//     (B, KVH, Skp, hd) and V -> V^T_hi, V^T_lo (B, KVH, hd, Skp) in the
//     scratch the wrapper allocates (4 * B * KVH * Skp * hd floats, Skp =
//     Skv rounded up to 64 keys, zero-filled past Skv; 42 MB at hymba's
//     shape).  The G query heads of a KV head then share one split instead
//     of redoing it in every block, and the main kernel's K/V loads stay
//     plain cp.async copies.
//   * The main kernel keeps the bf16 route's frame: one warpgroup per
//     query tile of 64 rows, grid (head, query tile, batch) with the head
//     fastest and the longest rows first, the KV-tile range of should_run,
//     online softmax in the accumulator registers with quad shuffles, masks
//     only on edge tiles, the swizzled panels (a TF32 panel row of 32
//     columns is 128 bytes; 16 columns, 64 bytes).  The scale goes on q in
//     float32 before the split, as the reference does; Q_hi and Q_lo are
//     split once per block into shared memory.
//   * TF32 wgmma reads shared-memory operands K-major only (no transpose
//     bit).  S = Q.K^T is K-major as it stands (rows are positions, hd
//     contiguous).  For O = P.V the B operand is V with the keys as the
//     reduction axis, hence V^T in the scratch: hd rows, keys contiguous.
//   * P comes from registers as the A operand, split into hi and lo in
//     place (a masked p is exactly 0, so both parts are).  The float32
//     accumulator gives a thread the key columns {2t, 2t+1} of each 8-key
//     slice, where the m64k8 TF32 A fragment wants {t, t+4}.  Nothing is
//     shuffled: the pre-pass stores each 8-key group of V^T in the order
//     0,2,4,6,1,3,5,7, so the A fragment's k index t holds key 2t and t+4
//     holds key 2t+1, and a sum over keys does not care about their order.
//   * K_hi, K_lo, V^T_hi and V^T_lo tiles come in by cp.async, in two
//     stages (the next tile loads while this one computes) or in one
//     (loaded after this one's products), whichever measured faster
//     (tools/flash_tf32_tiles.py): a block of 168-254 registers a thread,
//     shared memory and the stages together set how many blocks an SM
//     holds, and more blocks hide one block's softmax behind another's
//     products better than a second stage does.  Shared memory (Q hi + lo
//     and the stages): hd 16 and 32 take 64-key tiles, two stages (41 and
//     81 KB); hd 64 and 96 32-key tiles, one stage (65 and 97 KB); hd 128
//     32-key tiles, two stages (193 KB); hd 256 16-key tiles, one stage
//     (193 KB; the O accumulator alone is 128 registers, and 160 bytes
//     spill).  Built with
//     -DREPRO_FLASH_F32_ONE_PASS the kernel drops the lo terms (hi.hi
//     only): a planted fault that the float32 checks must catch.
//
// Both: the output is written once, divided by max(l, 1e-30); the ragged
// last query and key tiles are masked, so any sequence length is taken;
// above 48 KB of shared memory the launch opts in with
// cudaFuncSetAttribute.
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int, scalars float; dtype 0 is float32, 1 bfloat16 (q, k, v and o share
// it).  Tensors are contiguous and 16-byte aligned: q and o (B, Sq, H,
// hd), k and v (B, Skv, KVH, hd).  flash_attention_scratch gives the
// float32 words of scratch a call needs (0 for bf16); flash_attention_launch
// takes that scratch and returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a head dim or type it does not take.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kBQ = 64;            // query rows per block (both routes)

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

// ---------------------------------------------------------------------------
// float32 route: three-pass TF32 (3xTF32) wgmma on the tensor cores
// ---------------------------------------------------------------------------

#ifdef REPRO_FLASH_F32_ONE_PASS
constexpr bool kThreePass = false;  // planted fault: the lo terms dropped
#else
constexpr bool kThreePass = true;
#endif
constexpr int kSplitKeys = 64;  // the pre-pass pads each head's keys to this
constexpr int kSplitRows = 32;  // keys per block of the pre-pass
constexpr int kSplitThreads = 256;

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// the value a TF32 wgmma reads exactly
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);  // x - hi is exact in float32
}

// The panels of a float32 tile of COLS columns: panel rows of PW columns
// (128 or 64 bytes) in the matching swizzle, as the bf16 route's Tc
template <int COLS>
struct Pf {
  static constexpr int PW = COLS % 32 == 0 ? 32 : 16;
  static constexpr int RB = 4 * PW;
  static constexpr uint32_t SWZ = RB / 16 - 1;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;
  static_assert(COLS % 16 == 0, "panels of 16 or 32 floats");
};
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t swz) {
  return off ^ ((off >> 3) & (swz << 4));
}
// byte offset of k-step kk (8 columns) in a tile of R rows in P's panels
template <class P>
__device__ __forceinline__ uint32_t kstep(int kk, int R) {
  return (kk * 8 / P::PW) * R * P::RB + (kk * 8 % P::PW) * 4;
}

template <int HD_, int BK_, int ST_>
struct Tf {
  static constexpr int HD = HD_, BK = BK_, ST = ST_;
  using QK = Pf<HD>;  // Q and K tiles: rows are positions, HD columns
  using VT = Pf<BK>;  // V^T tiles: HD rows, BK keys
  // columns of one P.V product (its accumulator: ON / 2 registers)
  static constexpr int ON = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int Q_BYTES = kBQ * HD * 4;  // Q_hi or Q_lo
  static constexpr int T_BYTES = BK * HD * 4;   // K_hi, K_lo, V^T_hi or V^T_lo
  // 1024 bytes of alignment slack, Q hi and lo, and ST stages of four tiles
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + ST * 4 * T_BYTES;
  static_assert(kSplitKeys % BK == 0 && (ST == 1 || ST == 2), "tiles");
  static_assert((kBQ * HD / 4) % kTcThreads == 0 &&
                (BK * HD / 4) % kTcThreads == 0, "tile loads");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// wgmma.mma_async m64nNk8, TF32 in, float32 accumulators, D += A.B.  _ss:
// A and B from shared memory, both K-major; _rs: A from registers (4 TF32
// values a thread), B from shared memory K-major.  TF32 has no transpose
// bit.  Overloaded on the accumulator's N / 2 registers.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The pre-pass: 32 keys of one (batch, KV head) a block.  K rows are split
// as they are; V goes through shared memory to be written transposed, each
// 8-key group in the order 0,2,4,6,1,3,5,7 (see the header).  Keys from Skv
// to Skp are written as zeros, so the main kernel's tiles need no bounds.
__global__ void __launch_bounds__(kSplitThreads) flash_split_kv_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ scratch, int Skv, int Skp, int KVH, int hd) {
  __shared__ float tile[kSplitRows * (256 + 1)];
  const int ld = hd + 1;  // odd: the transposed reads hit 32 banks
  const int j0 = blockIdx.x * kSplitRows, kvh = blockIdx.y, b = blockIdx.z;
  const long n = (long)gridDim.z * KVH * Skp * hd;  // floats of one array
  const long head = (long)b * KVH + kvh;
  float* khi = scratch + head * Skp * hd;
  float* klo = khi + n;
  float* vhi = scratch + 2 * n + head * hd * Skp;
  float* vlo = vhi + n;
  const long step = (long)KVH * hd;  // between positions of k and v
  const float* kb = k + ((long)b * Skv * KVH + kvh) * hd;
  const float* vb = v + ((long)b * Skv * KVH + kvh) * hd;
  for (int e = threadIdx.x; e < kSplitRows * hd; e += kSplitThreads) {
    const int r = e / hd, d = e % hd, j = j0 + r;
    const bool in = j < Skv;
    float hi, lo;
    split_tf32(in ? kb[j * step + d] : 0.f, hi, lo);
    khi[(long)j * hd + d] = hi;
    klo[(long)j * hd + d] = lo;
    tile[r * ld + d] = in ? vb[j * step + d] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSplitRows * hd; e += kSplitThreads) {
    const int d = e / kSplitRows, c = e % kSplitRows;
    const int r = (c & ~7) | (2 * (c & 3) + ((c >> 2) & 1));  // key at slot c
    float hi, lo;
    split_tf32(tile[r * ld + d], hi, lo);
    vhi[(long)d * Skp + j0 + c] = hi;
    vlo[(long)d * Skp + j0 + c] = lo;
  }
}

// R rows x COLS floats from device memory (rows ld floats apart) into the
// swizzled panels at dst, by 16-byte cp.async copies
template <int R, int COLS>
__device__ __forceinline__ void tf_load(uint32_t dst, const float* src, long ld) {
  using P = Pf<COLS>;
  constexpr int CPR = COLS / 4;  // 16-byte chunks per row
  constexpr int CPP = P::PW / 4;  // ... per panel row
#pragma unroll
  for (int it = 0; it < R * CPR / kTcThreads; ++it) {
    const int e = it * kTcThreads + threadIdx.x;
    const int r = e / CPR, c = e % CPR;
    cp_async16(dst + (c / CPP) * R * P::RB + swizzle(r * P::RB + (c % CPP) * 16, P::SWZ),
               src + r * ld + c * 4, 16);
  }
}

// the split K and V^T tiles of the keys k0.. into one stage at dst
template <class C>
__device__ __forceinline__ void tf_load_kv(uint32_t dst, const float* kh,
                                           const float* kl, const float* vh,
                                           const float* vl, int k0, int Skp) {
  tf_load<C::BK, C::HD>(dst, kh + (long)k0 * C::HD, C::HD);
  tf_load<C::BK, C::HD>(dst + C::T_BYTES, kl + (long)k0 * C::HD, C::HD);
  tf_load<C::HD, C::BK>(dst + 2 * C::T_BYTES, vh + k0, Skp);
  tf_load<C::HD, C::BK>(dst + 3 * C::T_BYTES, vl + k0, Skp);
}

// One warpgroup per (head, query tile of 64 rows, batch), the bf16 route's
// frame and accumulator layout; q and o as the caller gave them, K and V
// from the pre-pass's split (kh, kl: rows are keys; vh, vl: rows are head
// dims, Skp keys each).
template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kTcThreads, 1) flash_kernel_tf32(
    const float* __restrict__ q, const float* __restrict__ split,
    float* __restrict__ o, int Sq, int Skv, int Skp, int H, int KVH,
    int causal, int window, float scale, float softcap) {
  using C = Tf<HD, BK, ST>;
  using QK = typename C::QK;
  using VT = typename C::VT;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* smem = tc_smem + ((1024u - (smem_u32(tc_smem) & 1023u)) & 1023u);
  const uint32_t sQh = smem_u32(smem), sQl = sQh + C::Q_BYTES;
  const uint32_t sKV = sQl + C::Q_BYTES;  // stage s: K_hi, K_lo, V^T_hi, V^T_lo

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x;  // head fastest: a KV head's G heads run together
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_step = (long)H * HD;
  const float* qb = q + ((long)b * Sq * H + h) * HD;
  float* ob = o + ((long)b * Sq * H + h) * HD;
  const long n = (long)gridDim.z * KVH * Skp * HD;
  const long head = (long)b * KVH + kvh;
  const float* kh = split + head * Skp * HD;
  const float* kl = kh + n;
  const float* vh = split + 2 * n + head * HD * Skp;
  const float* vl = vh + n;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  if (kt_begin < kt_end) tf_load_kv<C>(sKV, kh, kl, vh, vl, kt_begin * BK, Skp);
  cp_commit();
  {  // Q * scale, split into hi and lo panels; rows past Sq are zeros
    constexpr int CPR = HD / 4, CPP = QK::PW / 4;
#pragma unroll
    for (int it = 0; it < kBQ * CPR / kTcThreads; ++it) {
      const int e = it * kTcThreads + threadIdx.x;
      const int r = e / CPR, c = e % CPR;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq)
        x = __ldg(reinterpret_cast<const float4*>(qb + (q0 + r) * q_step + c * 4));
      float4 hi, lo;
      split_tf32(x.x * scale, hi.x, lo.x);
      split_tf32(x.y * scale, hi.y, lo.y);
      split_tf32(x.z * scale, hi.z, lo.z);
      split_tf32(x.w * scale, hi.w, lo.w);
      const uint32_t off = (c / CPP) * kBQ * QK::RB +
                           swizzle(r * QK::RB + (c % CPP) * 16, QK::SWZ);
      *reinterpret_cast<float4*>(smem + off) = hi;
      *reinterpret_cast<float4*>(smem + C::Q_BYTES + off) = lo;
    }
  }

  float acc[HD / C::ON][C::ON / 2];
#pragma unroll
  for (int p = 0; p < HD / C::ON; ++p)
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) acc[p][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max of rows row0, row0 + 8
  float l_part[2] = {0.f, 0.f};  // this thread's share of the running sum
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = ST == 2 ? (kt - kt_begin) & 1 : 0;
    const uint32_t sKh = sKV + stage * 4 * C::T_BYTES;
    const uint32_t sKl = sKh + C::T_BYTES;
    const uint32_t sVh = sKh + 2 * C::T_BYTES, sVl = sKh + 3 * C::T_BYTES;
    if (ST == 2 && kt + 1 < kt_end) {  // the next tile loads while this one computes
      tf_load_kv<C>(sKV + (stage ^ 1) * 4 * C::T_BYTES, kh, kl, vh, vl,
                    (kt + 1) * BK, Skp);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();  // this tile's copies and Q's stores, to wgmma
    __syncthreads();

    // S = Q.K^T: the small terms first, then hi.hi
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    if (kThreePass) {
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        wgmma_tf32_ss(s, kmajor<QK>(sQl + kstep<QK>(kk, kBQ)),
                      kmajor<QK>(sKh + kstep<QK>(kk, BK)));
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        wgmma_tf32_ss(s, kmajor<QK>(sQh + kstep<QK>(kk, kBQ)),
                      kmajor<QK>(sKl + kstep<QK>(kk, BK)));
    }
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      wgmma_tf32_ss(s, kmajor<QK>(sQh + kstep<QK>(kk, kBQ)),
                    kmajor<QK>(sKh + kstep<QK>(kk, BK)));
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // softcap, and the masks only on a tile that straddles an edge
    const int k0 = kt * BK;
    const bool edge = !(k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || k0 > q0 + kBQ - 1 - window));
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i];
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
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = expf(s[i] - m_run[r]);  // exactly 0 where masked
      s[i] = p;
      l_part[r] += p;
    }
#pragma unroll
    for (int p = 0; p < HD / C::ON; ++p)
#pragma unroll
      for (int i = 0; i < C::ON / 2; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

    // P as TF32 A fragments, hi and lo: k-step j is key slice 8j..8j+7,
    // whose V^T rows hold the keys in the order 0,2,4,6,1,3,5,7, so the
    // fragment's (row0, t), (row0 + 8, t), (row0, t + 4), (row0 + 8, t + 4)
    // are this thread's accumulator entries 4j, 4j + 2, 4j + 1, 4j + 3
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float x[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        split_tf32(x[e], hi, lo);
        ph[j][e] = __float_as_uint(hi);
        pl[j][e] = __float_as_uint(lo);
      }
    }
    // O += P.V, one 64 x ON product per ON columns of V^T's rows
#pragma unroll
    for (int p = 0; p < HD / C::ON; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int p = 0; p < HD / C::ON; ++p) {
        const uint32_t off = kstep<VT>(j, HD) + p * C::ON * VT::RB;
        if (kThreePass) {
          wgmma_tf32_rs(acc[p], pl[j], kmajor<VT>(sVh + off));
          wgmma_tf32_rs(acc[p], ph[j], kmajor<VT>(sVl + off));
        }
        wgmma_tf32_rs(acc[p], ph[j], kmajor<VT>(sVh + off));
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < HD / C::ON; ++p) fence_regs(acc[p]);
    __syncthreads();  // this stage's readers are done before it refills
    if (ST == 1 && kt + 1 < kt_end) {
      tf_load_kv<C>(sKV, kh, kl, vh, vl, (kt + 1) * BK, Skp);
      cp_commit();
    }
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
  for (int p = 0; p < HD / C::ON; ++p)
#pragma unroll
    for (int i = 0; i < C::ON / 2; i += 2) {
      const int r = (i >> 1) & 1, qi = row0 + 8 * r;
      if (qi >= Sq) continue;
      *reinterpret_cast<float2*>(ob + qi * q_step + p * C::ON + 8 * (i >> 2) + col0) =
          make_float2(acc[p][i] * inv[r], acc[p][i + 1] * inv[r]);
    }
}

int split_keys(int Skv) { return (Skv + kSplitKeys - 1) / kSplitKeys * kSplitKeys; }

template <int HD, int BK, int ST>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        void* scratch, int B, int Sq, int Skv, int H, int KVH,
                        int causal, int window, float scale, float softcap,
                        cudaStream_t st) {
  const int Skp = split_keys(Skv);
  flash_split_kv_kernel<<<dim3(Skp / kSplitRows, KVH, B), kSplitThreads, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(scratch), Skv, Skp, KVH, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = flash_kernel_tf32<HD, BK, ST>;
  const int bytes = Tf<HD, BK, ST>::SMEM;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kTcThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(scratch),
      static_cast<float*>(o), Sq, Skv, Skp, H, KVH, causal, window, scale,
      softcap);
  return cudaGetLastError();
}

// Each head dim's KV tile (BK keys) and cp.async stages are in the switch
// below.  Built with -DREPRO_FLASH_TF32_HD=<hd> -DREPRO_FLASH_TF32_BK=<BK>
// -DREPRO_FLASH_TF32_ST=<stages>, that head dim takes another choice
// (tools/flash_tf32_tiles.py).
#ifndef REPRO_FLASH_TF32_HD
#define REPRO_FLASH_TF32_HD 0
#define REPRO_FLASH_TF32_BK 0
#define REPRO_FLASH_TF32_ST 0
#endif

cudaError_t launch_f32(int hd, const void* q, const void* k, const void* v,
                       void* o, void* scratch, int B, int Sq, int Skv, int H,
                       int KVH, int causal, int window, float scale,
                       float softcap, cudaStream_t st) {
#define REPRO_FLASH_TF32(HD, BK, ST)                                          \
  case HD:                                                                    \
    return launch_tf32<HD, (HD == REPRO_FLASH_TF32_HD ? REPRO_FLASH_TF32_BK   \
                                                      : BK),                  \
                       (HD == REPRO_FLASH_TF32_HD ? REPRO_FLASH_TF32_ST       \
                                                  : ST)>(                     \
        q, k, v, o, scratch, B, Sq, Skv, H, KVH, causal, window, scale,       \
        softcap, st);
  switch (hd) {
    REPRO_FLASH_TF32(16, 64, 2)
    REPRO_FLASH_TF32(32, 64, 2)
    REPRO_FLASH_TF32(64, 32, 1)  // 65 KB: 3 blocks an SM (2 with two stages)
    REPRO_FLASH_TF32(96, 32, 1)  // 97 KB: 2 blocks an SM (1 with two stages)
    REPRO_FLASH_TF32(128, 32, 2)
    REPRO_FLASH_TF32(256, 16, 1)  // Q hi + lo alone take 128 KB
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_TF32
}

}  // namespace

extern "C" {

long long flash_attention_scratch(int B, int Skv, int KVH, int hd, int dtype) {
  return dtype == 0 ? 4LL * B * KVH * split_keys(Skv) * hd : 0;
}

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* scratch, int B, int Sq, int Skv,
                           int H, int KVH, int hd, int dtype, int causal,
                           int window, float scale, float softcap,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(hd, q, k, v, o, scratch, B, Sq, Skv, H, KVH, causal,
                      window, scale, softcap, st);
  if (dtype == 1)
    return launch_bf16(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                       scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
