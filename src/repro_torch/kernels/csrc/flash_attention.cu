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
// At the hd-128 configs' causal prefill (B 4, S 2048) it is 6.9e10 flops
// (qwen2-moe-a2.7b, 16 heads) and 1.4e11 (granite-8b, 32 heads over 8):
// 0.070 and 0.139 ms in bf16.  The float32 route issues three TF32
// products for each: 1.21e11 flops at hymba's shape, 0.244 ms at that rate
// (the work once in float32 FMAs outside the tensor cores would take 0.60
// ms at 67 TFLOP/s).  Each input read once and the output written once
// move 63 MB in bf16 at hymba's shape, 0.019 ms at 3.35 TB/s (126 MB in
// float32, 0.038 ms).
//
// Two routes, picked by the input type; the wrapper never falls back.
//
// bf16 (the serving type): flash_kernel_ws, FlashAttention-3's shape, both
// products on the tensor cores in bf16 with float32 accumulation.  A block
// of three warpgroups (384 threads) owns a query tile of 128 rows of one
// head at a time.  The tiles are numbered with the head fastest, so the G
// query heads of one KV head run side by side and share its K/V tiles
// through L2, then the query tiles longest first, then the batch, so the
// blocks in flight read one batch row's K/V (all of qwen2-moe-a2.7b's
// prefill K/V, 64 MB, would not stay in the 50 MB L2).
//   * The grid.  A block's own overhead -- its first loads, its last P.V
//     alone on the tensor cores, writing O -- was a sixth of a 16-round
//     block at qwen2-moe-a2.7b's prefill (clock64 traces,
//     tools/flash_ws_trace.py), so where the tiles allow the grid is
//     persistent: one block an SM walks tiles, and the producer loads the
//     next tile's Q and K/V while the consumers finish this one.  Under a
//     causal mask without a window a walk's item is a pair of tiles of one
//     head, the long (nq - 1 - i) and the short (i): nq + 1 key tiles
//     between them whatever i is, so a static stride over the items
//     balances the blocks.  Without a mask every tile is the same work and
//     the walk strides over single tiles.  A windowed launch (tiles of
//     unequal length), one with fewer items than SMs, and hd 256 (two Q
//     buffers do not fit) get a block a tile, which the hardware hands to
//     whichever SM frees first, from an instantiation without the walk's
//     loop (WALK false: 6 % faster than the walking one at hymba's
//     windowed prefill).
//   * Warp specialisation.  Warpgroup 0 is the producer: it gives registers
//     back (setmaxnreg.dec to 40) and one thread issues TMA loads -- each
//     tile's Q into one of two buffers (one at hd 256), then its K and V
//     tiles of BK keys into a ring of ST stages that runs on across tiles,
//     each buffer and stage with a full and an empty mbarrier (full: the
//     TMA's byte count; empty: the consumers' arrivals).  Warpgroups 1 and
//     2 are consumers (setmaxnreg.inc to 232): each owns 64 of the 128
//     query rows and reads every K/V tile, so a tile loaded serves 128
//     rows.  No thread of a consumer loads anything.
//   * TMA tensor maps (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so nothing links libcuda) see q, k, v and o
//     as 4-D (hd, heads, positions, batch); one box is a panel of PW
//     columns by the tile's rows, in the 128-, 64- or 32-byte swizzle that
//     a panel row of 64, 32 or 16 columns takes -- the layout wgmma reads.
//     Rows past the sequence are zero-filled on loads and not written on
//     stores.
//   * S = Q.K^T is wgmma m64nBKk16 with both operands in shared memory,
//     K-major (rows hd-contiguous); hd 96, 128 and 256 are 3, 2 and 4
//     panels.  The scale goes on the float32 scores after the product,
//     then softcap, then the causal / window / ragged-edge masks -- those
//     only on a tile that straddles an edge for the consumer's 64 rows, as
//     a per-row range of kept columns.  The KV-tile range per query tile
//     is the TPU kernel's should_run.
//   * Online softmax in registers: a thread holds two rows of the
//     accumulator and a row's columns lie on the 4 threads of a quad (two
//     shuffles for the max; the sum is reduced once, at the end).  exp is
//     2^(one FFMA) in the log2 domain, on the MUFU (ex2.approx).  A round
//     is not bound by the MUFU but by the tensor cores' issue (below):
//     sending a share of each tile's exps to the FMA pipes (a range
//     reduction and a cubic, FlashAttention-4's way off the MUFU) lost or
//     tied at every share and head dim measured.  A masked score is -inf,
//     so its p is exactly 0 even while a row has met no unmasked key (the
//     running max starts at the reference's -1e30).  l sums the float32 p.
//   * O += P.V is wgmma m64nHDk16 (two m64n128 at hd 256) with P from
//     registers: the S accumulator of 16 key columns is already the
//     A-fragment layout, so P is rounded to bf16 pairs in place; V is read
//     MN-major (transpose bit), its panels the descriptor's leading-byte
//     steps along N.
//   * A round j of a consumer: pack P_{j-1} (kept in S's registers since
//     the last softmax, so no product in flight reads the registers it
//     writes), issue S_j, rescale O by the last softmax's alpha while S_j
//     runs (skipped where no row of the warp moved its max), issue
//     P_{j-1}.V_{j-1} behind it, wait for S_j alone (wgmma.wait_group 1),
//     softmax, then wait for P_{j-1}.V_{j-1}.  Named barriers pass a turn
//     between the two consumers around each issue, so one's products run
//     while the other does its softmax (ping-pong).  Issuing a warpgroup's
//     16 wgmma takes about as long as its products run (the clock64 traces:
//     the issue returns when S_j has nearly landed), so the softmax cannot
//     run under the warpgroup's own P.V whatever the order; ptxas also
//     places the wait for P_{j-1}.V_{j-1} ahead of the softmax's exps (the
//     SASS), and pinning it behind them (an mbarrier arrival that reads the
//     row sums) measured no faster.  The two warpgroups' alternation is the
//     overlap there is.
//   * The epilogue: a consumer normalises its rows of O, rounds them to
//     bf16, writes them over its own rows of the tile's Q buffer (its last
//     Q.K^T has landed) in the panels' swizzle, and one thread stores them
//     with a TMA store a panel; it waits for the store to have read them
//     only after the next tile's first softmax, and then releases the
//     buffer.  (Writing O straight from registers took 3,000-6,000 clocks
//     a tile with the tensor cores idle, and waiting for the store at
//     once 2,000-5,700.)
//   * No atomics: two calls give bitwise the same output.
//   Tiles (BK keys, ST stages) and shared memory (Q buffers, then the
//   ring): hd 16-128 take BK 128, two stages and two Q buffers: 24, 48, 96,
//   144 and 192 KB; hd 256 takes BK 64 (its O accumulator is 128
//   registers), two stages and one Q buffer, 192 KB.
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
//   * The main kernel: one warpgroup per query tile of 64 rows, grid
//     (head, query tile, batch) with the head fastest and the longest rows
//     first, the KV-tile range of should_run, online softmax in the
//     accumulator registers with quad shuffles, masks only on edge tiles,
//     swizzled panels (a TF32 panel row of 32 columns is 128 bytes; 16
//     columns, 64 bytes).  The scale goes on q in float32 before the
//     split, as the reference does; Q_hi and Q_lo are split once per block
//     into shared memory.
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
// cudaFuncSetAttribute (the bf16 route once per instantiation and device).
//
// C interface, bound with ctypes: pointers and the stream are void*, counts
// int, scalars float; dtype 0 is float32, 1 bfloat16 (q, k, v and o share
// it).  Tensors are contiguous and 16-byte aligned: q and o (B, Sq, H,
// hd), k and v (B, Skv, KVH, hd).  flash_attention_scratch gives the
// float32 words of scratch a call needs (0 for bf16); flash_attention_launch
// takes that scratch and returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a head dim or type it does not take (or a
// tensor map that cuTensorMapEncodeTiled refuses).

#include <atomic>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kBQ = 64;            // query rows per block (float32 route)
constexpr int kTcThreads = 128;    // one warpgroup (float32 route)

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
// at most N committed wgmma groups still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// bf16 route: warp-specialised, TMA-fed wgmma (FlashAttention-3's shape)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWsBQ = 128;          // query rows per block: 64 per consumer
constexpr int kWsThreads = 384;     // a producer warpgroup and two consumers
// each thread starts with 65536 / 384 = 168; 128 * 40 + 256 * 232 = 384 *
// 168.  The producer's walk needs 40 (24 spilled); the consumers lost
// nothing measurable going from 240 to 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// The tiles' layout in shared memory.  A tile of R rows x HD columns (Q,
// or K or V: rows are positions, HD-contiguous) is HD / PW panels of R
// rows x PW columns; a panel row is RB = 2*PW bytes (128, 64 or 32) in the
// matching swizzle (128B, 64B, 32B): the byte at linear offset off of the
// 1024-byte-aligned panel lies at off ^ ((off >> 3) & (RB - 16)), the
// 16-byte chunk index XORed with the row's place in its 8-row swizzle
// atom, which is what the TMA writes and wgmma reads in that mode.
template <int HD_, int BK_, int ST_>
struct Ws {
  static constexpr int HD = HD_, BK = BK_, ST = ST_;
  static constexpr int PW = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int NP = HD / PW;  // panels
  static constexpr int RB = 2 * PW;   // bytes of a panel row
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr int Q_BYTES = kWsBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  // two Q buffers where they fit, so that the next tile's Q loads while
  // this one runs (one at hd 256: there the next Q loads once this tile's
  // last Q.K^T has landed)
  static constexpr int QB = 1024 + 2 * Q_BYTES + 2 * ST * KV_BYTES <= 227 * 1024 ? 2 : 1;
  // 1024 bytes of alignment slack, the Q buffers, and ST stages of K and V
  static constexpr int SMEM = 1024 + QB * Q_BYTES + 2 * ST * KV_BYTES;
  static constexpr int NBAR = 2 * QB + 4 * ST;  // Q full, empty; K, V full; K, V empty
  static_assert(HD % 16 == 0 && BK % 16 == 0 && BK <= 256, "wgmma shapes");
  static_assert(ST >= 2, "a ring of at least two stages");
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
};

// wgmma.mma_async m64nNk16, bf16 in, float32 accumulators.  wgmma_ss: A
// and B from shared memory, both K-major, D = A.B + (scale_d ? D : 0).
// wgmma_rs: A from registers, B from shared memory MN-major (the transpose
// bit), D += A.B; its N is the head dim, across the panels of V.
// Overloaded on the accumulator's N / 2 registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
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

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// mbarriers (shared-memory barriers that count arrivals and TMA bytes)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a PW x rows box of a 4-D tensor map (coordinates innermost first) into
// shared memory at dst; the bytes complete on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// a PW x rows box of shared memory at src to a 4-D tensor map (rows past
// the tensor are not written), in the bulk group of the issuing thread
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk groups have read their shared memory (the writes to global
// memory complete on their own, before the kernel does)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// named barriers 1 and 2 pass the turn between the consumers: consumer c
// waits on 1 + c, and hands the turn on by arriving at the other's
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}
// named barrier 3 + c: the 128 threads of consumer c
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#ifdef REPRO_FLASH_WS_TRACE
// clock64 stamps of the consumers' rounds (tools/flash_ws_trace.py): the
// first four blocks of the grid and four from its middle, each consumer,
// rounds 0..kTrRounds-2, kTrEvents stamps a round; round kTrRounds-1
// holds the consumer's start (0) and the end of its epilogue (1)
constexpr int kTrBlocks = 8, kTrRounds = 40, kTrEvents = 10;
__device__ unsigned long long ws_trace[kTrBlocks][2][kTrRounds][kTrEvents];
__device__ __forceinline__ int ws_trace_slot() {
  const int mid = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x / 2);
  return blockIdx.x < 4 ? static_cast<int>(blockIdx.x) : (mid >= 0 && mid < 4 ? 4 + mid : -1);
}
// thread 0 of a consumer warpgroup stores the clock, predicated (no branch)
__device__ __forceinline__ void ws_stamp(int slot, int c, int j, int ev) {
  const int on = slot >= 0 && j < kTrRounds && (threadIdx.x & 127) == 0;  // kTrRounds - 1: start, end
  unsigned long long* p = &ws_trace[on ? slot : 0][c][on ? j : 0][ev];
  asm volatile(
      "{\n.reg .pred q;\n.reg .u64 t;\nsetp.ne.s32 q, %1, 0;\n"
      "mov.u64 t, %%clock64;\n@q st.global.u64 [%0], t;\n}\n" ::"l"(p),
      "r"(on)
      : "memory");
}
#define WS_STAMP(j, ev) ws_stamp(tr, c, (j), (ev))
#else
#define WS_STAMP(j, ev) \
  do {                  \
  } while (0)
#endif
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q.K^T for one consumer's 64 rows: Q at sQc (its rows of each panel,
// panels kWsBQ * RB apart), K at sK; the first k-step overwrites S
template <class C>
__device__ __forceinline__ void ws_qk(float (&s)[C::BK / 2], uint32_t sQc,
                                      uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < C::HD / 16; ++kk) {
    const int p = kk * 16 / C::PW, cb = (kk * 16) % C::PW * 2;
    wgmma_ss(s, kmajor<C>(sQc + p * kWsBQ * C::RB + cb),
             kmajor<C>(sK + p * C::BK * C::RB + cb), kk > 0);
  }
}
// O += P.V, 64 x ON products (ON = HD up to 128 columns) per 16-key step:
// V's panels are the descriptor's leading-byte-offset steps along N
template <class C>
__device__ __forceinline__ void ws_pv(float (&acc)[C::HD / 2],
                                      const uint32_t (&pa)[C::BK / 16][4],
                                      uint32_t sV) {
  constexpr int ON = C::HD > 128 ? 128 : C::HD;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < C::HD / ON; ++n)
      wgmma_rs(*reinterpret_cast<float(*)[ON / 2]>(&acc[n * ON / 2]), pa[kk],
               mnmajor<C>(sV + n * (ON / C::PW) * C::BK * C::RB + kk * 16 * C::RB));
}

// The softmax of one S tile in place (S -> p, unrounded), with the running
// max m (in score units) and this thread's share of the running sum l.
// alpha is the factor O is to be rescaled by.  Scores x are s * scale, or
// softcap * tanh(s * scale / softcap); exp(x - m) is 2^(one FFMA) with
// sl2 = log2(e) * (scale, or 1 under softcap), on the MUFU (ex2).
// Softcap and the masks (an edge tile of the consumer's rows
// r0..r0+63 only) are passes of their own behind uniform branches, so an
// interior tile costs a max, an FFMA, an exp and an add a score; maxima
// and sums run in four partial chains.
template <class C>
__device__ __forceinline__ void ws_softmax(float (&s)[C::BK / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           int k0, int r0, int row0, int col0,
                                           int Skv, int causal, int window,
                                           float scale, float softcap,
                                           float sl2) {
  constexpr int N = C::BK / 2;
  if (softcap > 0.f) {
    const float a = scale / softcap;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = softcap * tanhf(s[i] * a);
  }
  if (!(k0 + C::BK <= Skv && (!causal || k0 + C::BK - 1 <= r0) &&
        (window <= 0 || k0 > r0 + 63 - window))) {
    // row r keeps the tile's columns lo[r] <= c <= hi[r], counted from this
    // thread's first column (c = 8 * (i >> 2) + (i & 1))
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      hi[r] = (causal ? min(qi, Skv - 1) : Skv - 1) - k0 - col0;
      lo[r] = (window > 0 ? qi - window + 1 : 0) - k0 - col0;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1, c = 8 * (i >> 2) + (i & 1);
      if (c < lo[r] || c > hi[r]) s[i] = -CUDART_INF_F;
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x);
    alpha[r] = ex2((m[r] - m_new) * sl2);
    m[r] = m_new;
    mb[r] = m_new * sl2;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float x = fmaf(s[i], sl2, -mb[r]);
    const float p = ex2(x);  // 0 where masked
    s[i] = p;
    sum[r][(i >> 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], alpha[r], (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}
// O *= alpha, skipped where no row of the warp moved its max (faster, in
// turns, at every prefill shape the rescale was timed at)
template <class C>
__device__ __forceinline__ void ws_rescale(float (&acc)[C::HD / 2],
                                           const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
    for (int i = 0; i < C::HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}
// P as bf16 A fragments: key columns 16kk..16kk+15 of the S accumulator
// are the m64k16 A-fragment layout already
template <class C>
__device__ __forceinline__ void ws_pack(uint32_t (&pa)[C::BK / 16][4],
                                        const float (&s)[C::BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// A block walks tiles of 128 query rows of one (batch, head).  With
// paired set (causal, no window), item i of the walk is a pair of tiles of
// one (batch, head): the long one (nq - 1 - i) and then the short one
// (i), nq + 1 key tiles between them whatever i is, so every item is the
// same work and a static stride over them balances the blocks.  Otherwise
// an item is one tile, the longest first; a grid with a block an item
// (the windowed and hd-256 launches) hands items to SMs as they free.
// Items are numbered with the head fastest (the G heads of a KV head side
// by side, sharing its K/V tiles through L2), then i, then the batch.
struct WsTile {
  int b, h, q0, kt_begin, n;  // n key tiles from kt_begin (n <= 0: none)
};
// the k-th tile of this block's walk; false past its end.  q0 < 0 marks
// the empty second half of an odd nq's middle pair.  (The kernel's
// arguments come straight from its parameter space: nothing of the walk
// stays in registers between tiles.)
template <int BK>
__device__ __forceinline__ bool ws_tile(int Sq, int Skv, int H, int B, int causal,
                                        int window, int paired, int k, WsTile& t) {
  const int nq = (Sq + kWsBQ - 1) / kWsBQ;
  int qt;
  if (paired) {
    const int np = (nq + 1) / 2;
    const int item = blockIdx.x + (k >> 1) * gridDim.x;
    if (item >= B * H * np) return false;
    const int i = item / H % np;
    t.h = item % H;
    t.b = item / (H * np);
    qt = (k & 1) ? i : nq - 1 - i;
    if ((k & 1) && qt == nq - 1 - i) {
      t.q0 = -1, t.n = 0;
      return true;
    }
  } else {
    const int item = blockIdx.x + k * gridDim.x;
    if (item >= B * H * nq) return false;
    t.h = item % H;
    qt = nq - 1 - item / H % nq;
    t.b = item / (H * nq);
  }
  t.q0 = qt * kWsBQ;
  // the KV tiles that can hold an unmasked key of the tile's rows (the
  // TPU kernel's should_run)
  const int q_last = min(t.q0 + kWsBQ, Sq) - 1;
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  t.kt_begin = 0;
  if (window > 0 && t.q0 - window + 1 > 0) t.kt_begin = (t.q0 - window + 1) / BK;
  t.n = kt_end - t.kt_begin;
  return true;
}

// A consumer's rows of O for a tile: normalised by the row sums, rounded
// to bf16 and written over its own rows of the tile's Q buffer (its last
// Q.K^T has landed) in the panels' swizzle; then thread 0 of the consumer
// stores them with one TMA store a panel (rows past Sq are not written).
// The caller releases the Q buffer once the store has read it.  A warp's
// 4-byte writes land in 8 rows of one 16-byte column, which the swizzle
// spreads over the banks.
template <class C>
__device__ __forceinline__ void ws_store_o(const CUtensorMap* to, const float (&acc)[C::HD / 2],
                                           const float (&l_part)[2], uint32_t sQc, int c,
                                           int warp, int lane, const WsTile& t) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < C::HD / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = 16 * warp + (lane >> 2) + 8 * r, col = 8 * (i >> 2) + 2 * (lane & 3);
    const uint32_t off = row * C::RB + (col % C::PW) * 2;
    const uint32_t dst = sQc + (col / C::PW) * kWsBQ * C::RB + (off ^ ((off >> 3) & (C::RB - 16)));
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                 "r"(pack_bf16(acc[i] * inv[r], acc[i + 1] * inv[r]))
                 : "memory");
  }
  fence_proxy_async();  // the writes, visible to the TMA's async proxy
  consumer_sync(c);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
      tma_store(to, sQc + p * kWsBQ * C::RB, p * C::PW, t.h, t.q0 + 64 * c, t.b);
    bulk_commit();
  }
}
// the last tile's TMA store has read its Q buffer: release the buffer
__device__ __forceinline__ void ws_release_q(uint32_t empty_q) {
  if ((threadIdx.x & 127) == 0) {
    bulk_wait_read();
    mbar_arrive(empty_q);
  }
}

// One block per SM (or per item, if fewer), three warpgroups: a producer
// and two consumers of 64 query rows each.  In a consumer, warp w of the
// warpgroup owns rows 16w..16w+15 of the consumer's 64 and each thread two
// of them (row0, row0 + 8) with the wgmma accumulator layout: element i
// of a 64 x N accumulator is row row0 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).  The producer and both
// consumers walk the same tiles and count the same rounds (g, across
// tiles, for the K/V ring's stages and phases) and the same tiles with
// keys (u, for the Q buffers'); the producer loads the next tile's Q and
// K/V while the consumers finish this one.  A tile without key tiles (a
// window past Skv) loads nothing and its rows of O are zeros.
template <int HD, int BK, int ST, bool WALK>
__global__ void __launch_bounds__(kWsThreads, 1) flash_kernel_ws(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    bf16* __restrict__ o, int Sq, int Skv, int H, int KVH, int B, int causal, int window,
    int paired, float scale, float softcap) {
  using C = Ws<HD, BK, ST>;
  static_assert(!WALK || C::QB == 2, "a walk loads the next Q while this tile runs");
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  __shared__ __align__(8) uint64_t ws_bars[C::NBAR];
  const uint32_t base = (smem_u32(ws_smem) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(ws_bars);
  // Q buffer u % QB, then stage s's K tile (V is the tile after it)
  auto sQ = [&](int u) { return base + (u % C::QB) * C::Q_BYTES; };
  auto sK = [&](int s) { return base + C::QB * C::Q_BYTES + 2 * s * C::KV_BYTES; };
  // mbarriers: Q full and Q empty for each Q buffer; K full, V full, K
  // empty, V empty for each stage
  auto full_q = [&](int u) { return bar0 + 8 * (u % C::QB); };
  auto empty_q = [&](int u) { return bar0 + 8 * (C::QB + u % C::QB); };
  auto full_k = [&](int s) { return bar0 + 8 * (2 * C::QB + s); };
  auto full_v = [&](int s) { return bar0 + 8 * (2 * C::QB + ST + s); };
  auto empty_k = [&](int s) { return bar0 + 8 * (2 * C::QB + 2 * ST + s); };
  auto empty_v = [&](int s) { return bar0 + 8 * (2 * C::QB + 3 * ST + s); };
#define WS_TILE(k, t) ws_tile<BK>(Sq, Skv, H, B, causal, window, paired, (k), (t))

  if (threadIdx.x == 0) {
    for (int q = 0; q < C::QB; ++q) {
      mbar_init(full_q(q), 1);
      mbar_init(empty_q(q), 2);  // one arrival from each consumer's store
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival from each consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      WsTile t;
      for (int k = 0, g = 0, u = 0; (WALK || k == 0) && WS_TILE(k, t); ++k) {
        if (t.n <= 0) continue;
        const int kvh = t.h / (H / KVH);
        mbar_wait(empty_q(u), ((u / C::QB) & 1) ^ 1);
        mbar_expect_tx(full_q(u), C::Q_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(sQ(u) + p * kWsBQ * C::RB, &tq, full_q(u), p * C::PW, t.h, t.q0, t.b);
        ++u;
        for (int j = 0; j < t.n; ++j, ++g) {
          const int s = g % ST, ph = (g / ST) & 1;
          const int k0 = (t.kt_begin + j) * BK;
          mbar_wait(empty_k(s), ph ^ 1);
          mbar_expect_tx(full_k(s), C::KV_BYTES);
          for (int p = 0; p < C::NP; ++p)
            tma_load(sK(s) + p * BK * C::RB, &tk, full_k(s), p * C::PW, kvh, k0, t.b);
          mbar_wait(empty_v(s), ph ^ 1);
          mbar_expect_tx(full_v(s), C::KV_BYTES);
          for (int p = 0; p < C::NP; ++p)
            tma_load(sK(s) + C::KV_BYTES + p * BK * C::RB, &tv, full_v(s), p * C::PW,
                     kvh, k0, t.b);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int col0 = 2 * (lane & 3);
    const float sl2 = (softcap > 0.f ? 1.f : scale) * kLog2e;
#ifdef REPRO_FLASH_WS_TRACE
    const int slot = ws_trace_slot();
    ws_stamp(slot, c, kTrRounds - 1, 0);
#endif

    float acc[HD / 2];
    float m_run[2], l_part[2], alpha[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    WsTile t;
    bool more = WS_TILE(0, t);
    int stored = -1;  // the Q buffer whose O store has not been waited for
    if (c == 1) turn_pass(c);  // consumer 0 takes the first turn
    for (int k = 0, g = 0, u = 0; more; ++k, more = WALK && WS_TILE(k, t)) {
#ifdef REPRO_FLASH_WS_TRACE
      const int tr = k == 0 ? slot : -1;  // the block's first tile's rounds
#endif
      const int n = t.n;
      const int r0 = t.q0 + 64 * c;
      const int row0 = r0 + 16 * warp + (lane >> 2);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = kNegInf;  // running max of rows row0, row0 + 8
      l_part[0] = l_part[1] = 0.f;    // this thread's share of the running sum
      if (n > 0) {
        const uint32_t sQc = sQ(u) + 64 * c * C::RB;
        const int qph = (u / C::QB) & 1, qu = u;
        ++u;
        WS_STAMP(0, 0);
        mbar_wait(full_q(qu), qph);
        // S_0
        mbar_wait(full_k(g % ST), (g / ST) & 1);
        WS_STAMP(0, 1);
        turn_wait(c);
        WS_STAMP(0, 2);
        wg_fence();
        ws_qk<C>(s, sQc, sK(g % ST));
        wg_commit();
        turn_pass(c);
        WS_STAMP(0, 4);
        wg_wait<0>();
        fence_regs(s);
        WS_STAMP(0, 5);
        if (lane == 0) mbar_arrive(empty_k(g % ST));
        ws_softmax<C>(s, m_run, l_part, alpha, t.kt_begin * BK, r0, row0, col0, Skv,
                      causal, window, scale, softcap, sl2);
        // the last tile's O store has long read its Q buffer by now
        if (stored >= 0) ws_release_q(empty_q(stored));
        stored = -1;
        WS_STAMP(0, 6);
        for (int j = 1; j < n; ++j) {
          // P_{j-1}, in S's registers since the last softmax, is packed to
          // bf16 first: the last P.V has landed, so nothing in flight reads
          // pa.  Then S_j = Q.K_j^T goes in, O is rescaled by the last alpha
          // while it runs, and P_{j-1}.V_{j-1} goes in behind it.
          const int gj = g + j, st = gj % ST, sp = (gj - 1) % ST;
          WS_STAMP(j, 0);
          mbar_wait(full_k(st), (gj / ST) & 1);
          WS_STAMP(j, 1);
          ws_pack<C>(pa, s);
          turn_wait(c);
          WS_STAMP(j, 2);
          wg_fence();
          ws_qk<C>(s, sQc, sK(st));
          wg_commit();
          WS_STAMP(j, 3);
          ws_rescale<C>(acc, alpha);
          mbar_wait(full_v(sp), ((gj - 1) / ST) & 1);
          fence_regs(acc);
          wg_fence();
          ws_pv<C>(acc, pa, sK(sp) + C::KV_BYTES);
          wg_commit();
          turn_pass(c);
          WS_STAMP(j, 4);
          wg_wait<1>();  // S_j has landed; P_{j-1}.V_{j-1} may still run
          fence_regs(s);
          WS_STAMP(j, 5);
          if (lane == 0) mbar_arrive(empty_k(st));
          ws_softmax<C>(s, m_run, l_part, alpha, (t.kt_begin + j) * BK, r0, row0, col0,
                        Skv, causal, window, scale, softcap, sl2);
          fence_regs(s);  // the softmax is done before the wait below
          WS_STAMP(j, 6);
          wg_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // P_{j-1} was read until here
#pragma unroll
            for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
          WS_STAMP(j, 7);
          if (lane == 0) mbar_arrive(empty_v(sp));
          WS_STAMP(j, 8);
        }
        // P_{n-1}.V_{n-1}
        const int sp = (g + n - 1) % ST;
        WS_STAMP(n, 0);
        ws_pack<C>(pa, s);
        ws_rescale<C>(acc, alpha);
        mbar_wait(full_v(sp), ((g + n - 1) / ST) & 1);
        turn_wait(c);
        WS_STAMP(n, 2);
        fence_regs(acc);
        wg_fence();
        ws_pv<C>(acc, pa, sK(sp) + C::KV_BYTES);
        wg_commit();
        // consumer 1 passes no turn after the block's last products: a walk
        // has at most one tile without keys in a row (an odd nq's middle)
        WsTile x;
        if (c == 0 || (WALK && ((WS_TILE(k + 1, x) && x.n > 0) ||
                                (WS_TILE(k + 2, x) && x.n > 0))))
          turn_pass(c);
        WS_STAMP(n, 4);
        wg_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
        if (lane == 0) mbar_arrive(empty_v(sp));
        WS_STAMP(n, 7);
        g += n;
      }
      if (n > 0) {
        ws_store_o<C>(&to, acc, l_part, sQ(u - 1) + 64 * c * C::RB, c, warp, lane, t);
        stored = u - 1;
      } else if (t.q0 >= 0) {
        // a tile without keys: zeros, written directly
        const long q_step = (long)H * HD;
        bf16* ob = o + ((long)t.b * Sq * H + t.h) * HD;
#pragma unroll
        for (int i = 0; i < HD / 2; i += 2) {
          const int qi = row0 + 8 * ((i >> 1) & 1);
          if (qi < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + qi * q_step + 8 * (i >> 2) + col0) =
                __floats2bfloat162_rn(0.f, 0.f);
        }
      }
#ifdef REPRO_FLASH_WS_TRACE
      if (k == 0) ws_stamp(slot, c, kTrRounds - 1, 1);
#endif
    }
#undef WS_TILE
    // the last O store has read its shared memory before the block ends
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
#ifdef REPRO_FLASH_WS_TRACE
    ws_stamp(slot, c, kTrRounds - 1, 2);
#endif
  }
}

// cuTensorMapEncodeTiled, an entry point of libcuda reached through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, S, heads, HD) bf16 tensor seen as 4-D (HD,
// heads, S, B), one box a panel of PW columns by `rows` positions of one
// head, in the panel's swizzle; positions past S read as zeros
template <class C>
bool ws_map(CUtensorMap* map, const void* base, int B, int S, int heads, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C::HD, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C::HD * 2, (cuuint64_t)heads * C::HD * 2,
                                 (cuuint64_t)S * heads * C::HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::PW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (C::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SMs into *n, read once per device (cached for the first 32)
cudaError_t sm_count(int dev, int* n) {
  static std::atomic<int> cached[32];
  *n = dev >= 0 && dev < 32 ? cached[dev].load(std::memory_order_acquire) : 0;
  if (*n > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*n <= 0) return cudaErrorInvalidValue;
  if (dev < 32) cached[dev].store(*n, std::memory_order_release);
  return cudaSuccess;
}

template <int HD, int BK, int ST>
cudaError_t launch_ws(const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Skv, int H, int KVH, int causal, int window,
                      float scale, float softcap, cudaStream_t st) {
  using C = Ws<HD, BK, ST>;
  CUtensorMap tq, tk, tv, to;
  if (!ws_map<C>(&tq, q, B, Sq, H, kWsBQ) || !ws_map<C>(&tk, k, B, Skv, KVH, BK) ||
      !ws_map<C>(&tv, v, B, Skv, KVH, BK) || !ws_map<C>(&to, o, B, Sq, H, 64))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  // The walk: pairs of tiles (causal without a window), or single tiles
  // of equal length (no mask), a block an SM, where there are more items
  // than SMs; otherwise a block a tile, from an instantiation without the
  // walk's loop (6 % faster there at hymba's windowed prefill), whose
  // tiles of unequal length the hardware's block scheduler balances.  hd
  // 256 takes a block a tile: two Q buffers do not fit.
  const long nq = (Sq + kWsBQ - 1) / kWsBQ;
  const long pairs = (nq + 1) / 2 * H * B, tiles = nq * H * B;
  constexpr bool kWalks = C::QB == 2;
  const int paired = kWalks && causal && window <= 0 && pairs >= sms;
  const bool walk = paired || (kWalks && !causal && window <= 0 && tiles > sms);
  auto kern = walk ? flash_kernel_ws<HD, BK, ST, kWalks>
                   : flash_kernel_ws<HD, BK, ST, false>;
  // the shared-memory opt-in once per instantiation (this function's own
  // statics) and device, not on every call
  static std::atomic<unsigned> opted[2];  // a bit per device
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(opted[walk].load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    opted[walk].fetch_or(bit, std::memory_order_release);
  }
  kern<<<(unsigned)(walk ? sms : tiles), kWsThreads, C::SMEM, st>>>(
      tq, tk, tv, to, static_cast<bf16*>(o), Sq, Skv, H, KVH, B, causal, window, paired,
      scale, softcap);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int KVH,
                        int causal, int window, float scale, float softcap,
                        cudaStream_t st) {
#define REPRO_FLASH_WS(HD, BK, ST)                                            \
  case HD:                                                                    \
    return launch_ws<HD, BK, ST>(q, k, v, o, B, Sq, Skv, H, KVH, causal,      \
                                 window, scale, softcap, st);
  switch (hd) {
    REPRO_FLASH_WS(16, 128, 2)
    REPRO_FLASH_WS(32, 128, 2)
    REPRO_FLASH_WS(64, 128, 2)
    REPRO_FLASH_WS(96, 128, 2)
    REPRO_FLASH_WS(128, 128, 2)
    REPRO_FLASH_WS(256, 64, 2)  // the O accumulator alone is 128 registers
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_WS
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

#ifdef REPRO_FLASH_WS_TRACE
// the consumers' clock64 stamps (kTrBlocks x 2 x kTrRounds x kTrEvents
// uint64, 0 where nothing was stamped) into host memory, then zeroed
int flash_attention_trace(void* host, long long bytes) {
  if (bytes != (long long)sizeof(ws_trace)) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyFromSymbol(host, ws_trace, sizeof(ws_trace));
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[sizeof(ws_trace) / 8];
  return cudaMemcpyToSymbol(ws_trace, zeros, sizeof(ws_trace));
}
#endif

}  // extern "C"
