// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:96,
//   flash_attention_fwd / _flash_fwd_kernel (the Pallas TPU kernel),
//   reached through ops.flash_attention.
//
// What it computes: full-sequence attention with an fp32 online softmax.
// q (B,Sq,H,D), k/v (B,Skv,Hkv,D) in the model's layout, out (B,Sq,H,D);
// q head h reads kv head h / (H/Hkv).  Scores are scaled by D^-1/2 and
// optionally soft-capped (tanh(s/c)*c) before masking.  Causal masking is
// top-left aligned, qpos >= kpos, as in the Pallas kernel; positions
// kpos >= Skv are always masked, so ragged lengths need no padding by the
// caller.  Two kernels, each at every head_dim D that is a multiple of 16
// from 16 to 128, and a wide twin of each for every multiple of 16 from
// 144 to 256 (the head_dim a runtime value there):
// - bf16 and fp16: flash_kernel<T, ...> below (TMA + wgmma), one
//   template for both 2-byte types, which differ only in the wgmma
//   instruction's input type (.bf16 or .f16), P's packing, the output's
//   rounding and the TMA maps' data type; tiles, shared memory and
//   registers are the same.  D 16, 32 and 48 run its
//   D-64 tiles, D 80, 96 and 112 its D-128 tiles: the TMA maps span the
//   real D columns, so the box that holds column D-1 fills the columns
//   past D with zeros, which change neither Q·K^T (its 16-column steps
//   past D are skipped) nor the D live columns of P·V; the epilogue
//   stores those D at a row stride of D.
// - fp32: flash_fp32_kernel further down, 3xTF32 wgmma: each operand
//   split into two TF32 values and each product taken as three TF32
//   products (one alone rounds its inputs to 10 mantissa bits, too coarse
//   for the reference's fp32 tolerance of 2e-5); TMA + wgmma as in bf16.
// - D 144 to 256: wide::flash_kernel_wide (bf16, fp16; 256-wide tiles,
//   a producer warpgroup, the softmax under the P·V product, a block a
//   pair of 64-row q units) and f32::flash_fp32_kernel_wide (3xTF32, a
//   producer warpgroup that loads and splits each tile, two consumers
//   splitting D, the softmax under the P·V product), each described
//   where it is defined.
//
// What bounds the bf16 kernel on this card: at the serving path's
// prefill shapes (B 1, Sq = Skv = 64 ... 2048, H 32, D 128, causal) the
// least time is the bytes (q, k, v and out once each, over 3.35 TB/s)
// below about 1200 tokens and the arithmetic above (4·D flops per
// attended (q,k) pair, about Sq·Skv/2 pairs, over 989 TFLOP/s of bf16
// tensor cores).  Met in practice: the tensor cores' rate, and below 512
// tokens the host's cost of a call (PERF.md).
//
// Precision of the 2-byte kernels: S and O accumulate in fp32 in either
// type.  P is rounded to the input type before P·V: fp16 keeps 10
// mantissa bits of each probability where bf16 keeps 7, but keeps those
// below 2^-14 with fewer bits and rounds those below 2^-25 to zero
// (fp16's smallest subnormal is 2^-24), where bf16's 8-bit exponent
// keeps them; l, the softmax's denominator, sums the unrounded fp32
// values in both.  The output is rounded once, to the input type.
//
// What the bf16 design does about it (FlashAttention-3's shape, without
// its overlap tricks):
// - One block of three warpgroups per (128-row q tile, head, batch), the
//   q tiles launched longest first (the causal rows that see most keys)
//   so that the short ones fill the last wave.
// - Warpgroup 0 is the producer: one thread issues TMA loads of Q once and
//   of K and V into a 2-stage ring of 128-row tiles.  Each stage has a
//   "full" mbarrier (TMA completes its bytes) and an "empty" one (every
//   consumer warp arrives once the PV product that read the stage has
//   retired); the parity flips on each wrap.  The producer gives up
//   registers (setmaxnreg 40), the consumers take them (232).
// - TMA reads 4-D maps over (D, H, S, B) in boxes of 64 columns x 128 rows
//   with the 128-byte swizzle, so a D-128 tile is two boxes; rows past S
//   arrive as zeros.  The maps are encoded on the host at every call
//   through cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint,
//   so the library needs no -lcuda.  A barrier wait of over a second
//   traps (out of line, wait_failed): a lost arrival fails the launch
//   instead of holding the card.
// - Warpgroups 1 and 2 own 64 q rows each.  S = Q·K^T is wgmma m64n128k16
//   with both operands in shared memory, accumulated in registers.  The
//   online softmax runs in registers (each thread holds two rows of its
//   warp's 16, reduced over the 4-thread quad) with exp2 and log2(e)
//   folded into the scale; the mask is applied only on tiles that cross
//   the diagonal or the Skv edge, and tiles wholly above the diagonal
//   are never loaded.  P is packed to bf16 in registers, where the
//   accumulator layout already is wgmma's A-operand layout, and
//   O += P·V is wgmma m64n{D}k16 with V (row-major, so MN-major for B)
//   read transposed from shared memory.  O stays in registers for the
//   whole sweep; the rescale by exp2(m_old - m_new) is a register
//   multiply.
//
// Left for later: overlapping one tile's softmax with the next tile's
// QK^T inside a warpgroup, ping-pong scheduling of the two consumer
// warpgroups, a persistent tile scheduler, a TMA store of O, and fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;          // q rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;          // kv rows per tile
constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kBoxCols = 64;      // 2-byte columns of a TMA box: 128 bytes
constexpr int kBoxBytes = kBN * kBoxCols * 2;
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory, byte offsets from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes).
template <int D>
struct Smem {
  static constexpr int TILE = kBN * D * 2;   // one 128-row tile, 2 bytes
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + kStages * TILE;
  static constexpr int BAR = V + kStages * TILE;   // q, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A lost barrier arrival: trap, so that the launch fails instead of
// holding the card.  A function of its own: a trap inlined in a kernel's
// body keeps ptxas from giving the consumers of a 384-thread kernel the
// registers of their setmaxnreg (it then spills and serialises every
// wgmma, C7512), and every kernel here waits through mbar_wait.  It
// does not return: a wait that could go on past it cost
// flash_fp32_kernel 9 registers and 5% of its time.
__device__ __noinline__ __attribute__((noreturn)) void wait_failed() {
  __trap();
  __builtin_unreachable();
}

// The same trap, declared to return.  wide::flash_kernel_wide waits
// through it: with wait_failed it ran about 1% slower at its served
// shape (32/32 heads of 256), and a returning trap costs it no
// registers, as it does flash_fp32_kernel.
__device__ __noinline__ void wait_failed_returning() { __trap(); }

// Spin until the barrier's phase of the given parity has completed; a
// wait of over a second traps (out of line, through
// wait_failed_returning where kReturning).
template <bool kReturning = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > 1000000000ull) {
      if constexpr (kReturning) wait_failed_returning();
      else wait_failed();
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 2-byte element types of flash_kernel: a pair of them from two
// fp32 values (rounded to nearest), and the TMA maps' data type.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};

template <>
struct Elem<__half> {
  using Pair = __half2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  typename Elem<T>::Pair v = Elem<T>::pair(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// The 2-byte kernel's three wgmma products, each below as the asm
// statement of an input type AB ("bf16" or "f16"), which the instruction
// names, and a function of T that picks one.
#define FLASH_WGMMA_SS_N128(AB)                                          \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                         \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                         \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                         \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                         \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "l"(da), "l"(db), "r"(scale_d)                                   \
      : "memory")

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (128 x 16, smem)^T, both
// K-major with the 128-byte swizzle; scale_d 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (kHalf<T>)
    FLASH_WGMMA_SS_N128("f16");
  else
    FLASH_WGMMA_SS_N128("bf16");
}

#define FLASH_WGMMA_RS_N128(AB)                                          \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                         \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                         \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                         \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                         \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)      \
      : "memory")

// D (64 x 128, fp32) += A (64 x 16, T registers) * B (16 x 128, smem),
// B MN-major (transposed) with the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (kHalf<T>)
    FLASH_WGMMA_RS_N128("f16");
  else
    FLASH_WGMMA_RS_N128("bf16");
}

#define FLASH_WGMMA_RS_N64(AB)                                           \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)      \
      : "memory")

// D (64 x 64, fp32) += A (64 x 16, T registers) * B (16 x 64, smem),
// B MN-major (transposed) with the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (kHalf<T>)
    FLASH_WGMMA_RS_N64("f16");
  else
    FLASH_WGMMA_RS_N64("bf16");
}


#define FLASH_WGMMA_SS_N64(AB)                                           \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                           \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                         \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                         \
      : "l"(da), "l"(db), "r"(scale_d)                                   \
      : "memory")

// D (64 x 64, fp32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T, both
// K-major with the 128-byte swizzle; scale_d 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (kHalf<T>)
    FLASH_WGMMA_SS_N64("f16");
  else
    FLASH_WGMMA_SS_N64("bf16");
}

// O += P·V for one 16-row slice of the tile's keys.
template <typename T, int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[4],
                                   uint64_t dv) {
  if constexpr (D == 128)
    wgmma_rs_n128<T>(o, p, dv);
  else
    wgmma_rs_n64<T>(o, p, dv);
}

__device__ __forceinline__ int kv_tiles(int q0, int skv, int causal) {
  int n = (skv + kBN - 1) / kBN;
  if (causal) n = min(n, (q0 + kBM - 1) / kBN + 1);
  return n;
}

// T: the element type (__nv_bfloat16 or __half); D: the tile width (64
// or 128); DV: the tensors' head_dim (D, or a narrower multiple of 16
// whose last live column lies in the tile's last box), the row stride of
// out and the columns stored.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
             int sq, int skv, int h, int hkv, int causal, float scale,
             float softcap) {
  using L = Smem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t full = q_full + 8;                // + 8 * stage
  const uint32_t empty = full + 8 * kStages;       // + 8 * stage

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // longest rows first
  const int kvh = head / (h / hkv);
  const int n_tiles = kv_tiles(q0, skv, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring filled.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(base + L::Q + x * kBoxBytes, &tq, q_full, x * kBoxCols,
                 head, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * stage, (t / kStages - 1) & 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * L::TILE);
        for (int x = 0; x < kBoxes; ++x) {
          const uint32_t off = stage * L::TILE + x * kBoxBytes;
          tma_load(base + L::K + off, &tk, bar, x * kBoxCols, kvh, t * kBN, b);
          tma_load(base + L::V + off, &tv, bar, x * kBoxCols, kvh, t * kBN, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [r_wg, r_wg + 64) of the q tile; a
  // thread holds rows row0 and row0 + 8, and in each 8-column block of a
  // product the columns cq and cq + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int lane = wt % 32;
  const int r_wg = (wg - 1) * 64;
  const int row0 = r_wg + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl = (softcap > 0.f ? 1.f : scale) * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const uint32_t q_tile = base + L::Q + r_wg * 128;   // 128 bytes a row

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int kv0 = t * kBN;
    const uint32_t k_tile = base + L::K + stage * L::TILE;
    const uint32_t v_tile = base + L::V + stage * L::TILE;
    mbar_wait(full + 8 * stage, (t / kStages) & 1);

    // S = Q K^T: K-major operands; a 16-column step moves 32 bytes
    // inside a box, and every fourth step moves to the next box.  Steps
    // past DV would add only the zero-filled columns.
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (DV + 15) / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128<T>(s, sw128_desc(q_tile + off, 16, 1024),
                    sw128_desc(k_tile + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    keep(s);

    // Online softmax in registers: s[4j + e] is row row0 + 8 (e / 2),
    // key kv0 + 8 j + cq + e % 2.
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        s[i] = tanhf(s[i] * scale / softcap) * softcap;
    }
    const bool edge = (causal && kv0 + kBN - 1 > q0 + r_wg) || kv0 + kBN > skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl;
        if (edge) {
          const int qpos = q0 + row0 + 8 * (e / 2);
          const int kpos = kv0 + 8 * j + cq + e % 2;
          const bool ok = kpos < skv && (!causal || qpos >= kpos);
          if (!ok) x = -INFINITY;
        }
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      const float alpha = exp2_approx(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }
    // P in T as the A operand: registers 8kk .. 8kk+7 of S are the
    // fragment of keys 16kk .. 16kk+15, in order.
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = exp2_approx(s[8 * kk + 2 * r] - mu[r % 2]);
        const float p1 = exp2_approx(s[8 * kk + 2 * r + 1] - mu[r % 2]);
        l[r % 2] += p0 + p1;
        p[kk][r] = pack<T>(p0, p1);
      }
    }

    // O += P V: V is MN-major; a 16-key step moves 16 rows (2048 bytes),
    // the second 64 columns lie one box (the leading offset) further.
    keep(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      pv<T, D>(o, p[kk],
               sw128_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait0();
    keep(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);   // the stage is free
  }

  // Epilogue: O / l in T, rows past Sq and columns past DV not
  // stored; rows DV apart.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row0 + 8 * i;
    if (qpos >= sq) continue;
    const float inv = 1.f / l[i];
    T* dst = out + (((size_t)blockIdx.y * sq + qpos) * h + head) * DV + cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<typename Elem<T>::Pair*>(dst + 8 * j) =
          Elem<T>::pair(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (d, heads, s, batch) of a (batch, s, heads, d) tensor of
// esize-byte elements, read in boxes of box_cols columns (128 bytes) x
// box_rows rows of one head with the 128-byte swizzle; rows past s read
// as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int s,
                int heads, int d, CUtensorMapDataType type, int esize,
                int box_cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * esize,
                                 (cuuint64_t)heads * d * esize,
                                 (cuuint64_t)s * heads * d * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int DV = D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int h, int hkv, int causal, float scale,
           float softcap, cudaStream_t stream) {
  static_assert(DV % 16 == 0 && DV <= D && D - DV < kBoxCols,
                "the last box holds the last live column");
  static_assert(sizeof(T) == 2, "the 2-byte kernel");
  constexpr CUtensorMapDataType kMap = Elem<T>::kMap;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, batch, sq, h, DV, kMap, 2, kBoxCols, kBM) ||
      !tensor_map(&tk, k, batch, skv, hkv, DV, kMap, 2, kBoxCols, kBN) ||
      !tensor_map(&tv, v, batch, skv, hkv, DV, kMap, 2, kBoxCols, kBN))
    return -2;
  constexpr int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, batch, (sq + kBM - 1) / kBM);
  flash_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), sq, skv, h, hkv, causal, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 and fp16 at head_dims 144 to 256: flash_kernel_wide, 256-wide tiles.
//
// The shape above does not hold D 256: its 128-row K/V tiles in two
// stages and the q tile take 320 KB of shared memory.  A consumer's O
// (64 x 256 fp32 over 128 threads) takes 128 registers before S and P.
// What bounds it on this card: at causal S 1024 the tensor cores (4·D
// flops an attended pair over 989 TFLOP/s), and a causal grid whose
// longest block sets the wall.  This one:
// - Three warpgroups (384 threads), FlashAttention-3's shape.  Warpgroup
//   0 is the producer: it gives up registers (setmaxnreg 40, the
//   consumers take 232: 128 x 40 + 256 x 232 is the 168 a thread that
//   384 threads launch with), and one thread issues every TMA load: Q
//   once, then K and V into rings of their own (2 K stages, 3 V stages of
//   64 keys), each stage refilled as soon as its "empty" barrier
//   completes.  A consumer frees K once S has retired and V once P·V
//   has.  Shared memory: Q 2 x 32 KB + K 2 x 32 KB + V 3 x 32 KB = 224 KB.
//   ptxas gives the consumer code its 232 registers only if no trap is
//   inlined in the kernel (wait calls one out of line); with one,
//   it spilled 1 KB and serialised every wgmma (C7512).
// - The unit of work is 64 q rows, one consumer warpgroup's rows.  A
//   block takes a pair of units of one (head, batch), the longer unit b
//   and a shorter a.  Consumer 1 sweeps b's key tiles; consumer 0 sweeps
//   a's at its side, on the same K/V tiles, and stores it; the tiles of b
//   past a's go to the two in turn (consumer 1 the first, consumer 0 the
//   next, ...), and consumer 0's share of b is merged into consumer 1's
//   through shared memory (the rings, idle by then) before consumer 1
//   stores b.  Two pairings (U = ceil(Sq/64) units a (head, batch)):
//   - when the blocks fit in one wave on the card's SMs, where the
//     longest block sets the wall, block z takes b = U-1-z and its mirror
//     a = z: at causal Sq = Skv every pair holds U + 1 tile-steps and its
//     longer consumer ceil((U + 1)/2), where a 128-row q tile a block
//     took its last tile's 2·ceil(Sq/128) steps on both consumers (at S
//     1024: 9 tile-steps against 16).  A pair of an odd U's middle unit
//     with itself is one unit that both consumers share in turn.  Grid
//     (ceil(U/2), H, B): a head's blocks launch together, and a wave
//     reads fewer heads' K and V from L2;
//   - past one wave, block z takes b = U-1-2z and its neighbour a = b-1,
//     which share every tile but b's last (the 128-row q tiles of the
//     kernel before), so that a K/V tile serves 128 q rows and no block
//     merges; grid (H, B, ceil(U/2)), every head's longest block first,
//     and the card's scheduler evens out the blocks' lengths.
//   ops.wide_schedule states the same rule in Python for the tests.
// - The softmax overlaps the products inside a warpgroup: S of tile t is
//   issued with P·V of the warpgroup's tile before it, the softmax of t
//   runs once S has retired (wait_group 1) while P·V still runs, and O
//   takes its rescale once P·V has retired.  (Ping-pong turns between the
//   two consumers, named barriers ordering their products, moved no time
//   at the head_dim-256 shapes and were taken out: PERF.md, PR 34.)
// - O leaves through shared memory: each unit's O / l is written into
//   its Q tile (idle by then) in the 128-byte swizzle and stored with
//   TMA, which clips rows past Sq and columns past dv; consumer 0 goes on
//   with its share of b while a's store runs.
// - TMA boxes of 64 columns (128 bytes) x 64 rows with the 128-byte
//   swizzle, four a row of a tile; only the boxes that hold a column
//   below the head_dim dv are loaded (the columns of the last one past
//   dv arrive as zeros), and the block zeroes the boxes of Q, K and V
//   past it once, so every product runs its full width with no branch
//   around a wgmma (ptxas serialises wgmma issued under a runtime
//   condition).  dv is a runtime value (every multiple of 16 from 144 to
//   256 runs one kernel a type); at 144 and 192 the products still run
//   256 wide.
// - S = Q·K^T is wgmma m64n64k16 (16 k-steps), O += P·V two m64n128k16
//   a 16-key step, one a half of O's columns, P from registers as in
//   flash_kernel; the online softmax as there, the softcap's tanh as
//   1 - 2 / (1 + e^2x).
// - Registers of a consumer: O 128, S 32 (then P in fp32 while the P·V
//   before it runs), P 16; everything else stays in uniform registers
//   (the consumer's index is a warp shuffle, which ptxas knows to be
//   uniform).
namespace wide {

constexpr int kD = 256;           // tile width: columns of Q, K, V and O
constexpr int kUnit = 64;         // q rows of a unit, one consumer's rows
constexpr int kBN = 64;           // kv rows per tile
constexpr int kKStages = 2;       // depth of the K ring
constexpr int kVStages = 3;       // depth of the V ring
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kBoxes = kD / kBoxCols;          // boxes a row of a tile
constexpr int kBox = kUnit * kBoxCols * 2;     // one box of 64 rows
constexpr int kTile = kBoxes * kBox;           // a unit's Q, a K or V tile
constexpr int kConsumerWarps = 8;
constexpr int kMergeFloats = 132;   // O 128, m 2, l 2 a consumer thread

// Dynamic shared memory, byte offsets from a 1024-byte aligned base.
struct Smem {
  static constexpr int Q = 0;                        // unit a, then unit b
  static constexpr int K = Q + 2 * kTile;
  static constexpr int V = K + kKStages * kTile;
  static constexpr int BAR = V + kVStages * kTile;   // q, K and V full/empty
  static constexpr int MERGE = K;                    // once both sweeps end
  static constexpr int BYTES =
      BAR + 8 * (1 + 2 * (kKStages + kVStages)) + 1024;
};
static_assert(Smem::MERGE + kMergeFloats * 128 * 4 <= Smem::BAR,
              "the merge fits in the rings");

// Whether a launch pairs each q unit with its mirror (mirror_pairs) or
// with its neighbour: the mirror when the blocks fit in one wave on the
// card's SMs, where the longest block sets the wall; past one wave the
// card's own block scheduler evens out blocks of unequal lengths, and
// neighbouring units share every K/V tile but the last, with no merge.
inline bool mirror_pairs(int batch, int sq, int h) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long pairs = ((sq + kUnit - 1) / kUnit + 1) / 2;
  return pairs * h * batch <= sms;
}

// The grid of a launch, one block a pair: mirror pairs (pairs, heads,
// batch), the pairs of a head launched together so that a wave reads
// fewer heads' K and V from L2; neighbour pairs (heads, batch, pairs),
// every head's longest pair first, so that the card's scheduler takes
// the blocks longest first (scripts/wide_flash_variants.py times the
// other orders).
inline dim3 grid(int batch, int sq, int h, bool mirror) {
  const int pairs = ((sq + kUnit - 1) / kUnit + 1) / 2;
  return mirror ? dim3(pairs, h, batch) : dim3(h, batch, pairs);
}

// 16 zero bytes at a shared address.
__device__ __forceinline__ void zero16(uint32_t a) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(a), "r"(0)
               : "memory");
}

__device__ __forceinline__ void st_f32(uint32_t a, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(x) : "memory");
}

__device__ __forceinline__ float ld_f32(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a) : "memory");
  return x;
}

// keep() for both halves of O.
__device__ __forceinline__ void keep_o(float (&o)[2][64]) {
  keep(o[0]);
  keep(o[1]);
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps P·V's A operand in its registers until the product has retired.
__device__ __forceinline__ void hold(const uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(p[i][j]) : "memory");
}

// Key tiles that a q row up to qlast attends.
__device__ __forceinline__ int key_tiles(int qlast, int skv, int causal) {
  int n = (skv + kBN - 1) / kBN;
  if (causal) n = min(n, qlast / kBN + 1);
  return n;
}

// mbar_wait, its trap declared to return (wait_failed_returning).
__device__ __forceinline__ void wait(uint32_t bar, int parity) {
  mbar_wait<true>(bar, parity);
}

// The K and V rings, at fixed offsets from the shared base (the one
// register a consumer keeps for them): tile t lies in stage t % stages,
// and its barriers complete once a wrap.
struct Ring {
  uint32_t base;

  __device__ __forceinline__ uint32_t k(int t) const {
    return base + Smem::K + kTile * (t % kKStages);
  }
  __device__ __forceinline__ uint32_t kfull(int t) const {
    return base + Smem::BAR + 8 + 8 * (t % kKStages);
  }
  __device__ __forceinline__ uint32_t kempty(int t) const {
    return base + Smem::BAR + 8 + 8 * (kKStages + t % kKStages);
  }
  __device__ __forceinline__ uint32_t vfull(int t) const {
    return base + Smem::BAR + 8 + 8 * (2 * kKStages + t % kVStages);
  }
  __device__ __forceinline__ uint32_t vempty(int t) const {
    return base + Smem::BAR + 8 + 8 * (2 * kKStages + kVStages + t % kVStages);
  }
  __device__ __forceinline__ void wait_k(int t) const {
    wait(kfull(t), (t / kKStages) & 1);
  }
  __device__ __forceinline__ void wait_v(int t) const {
    wait(vfull(t), (t / kVStages) & 1);
  }
  // every consumer warp arrives once it is done with the stage
  __device__ __forceinline__ void free_k(int t) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(kempty(t));
  }
  __device__ __forceinline__ void free_v(int t) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(vempty(t));
  }
  // Another warpgroup's tile: wait for it to land (so that no arrival
  // counts towards an earlier fill of its stage) and free it.
  __device__ __forceinline__ void pass(int t) const {
    wait_k(t);
    free_k(t);
    wait_v(t);
    free_v(t);
  }
  // The next tile of a sweep from n on: every tile below mid, then every
  // other one from mid; the tile between is passed.
  __device__ __forceinline__ int next(int n, int mid, int hi) const {
    if (n < hi && n > mid && (n - mid) % 2 == 1) {
      pass(n);
      ++n;
    }
    return n;
  }
};

// This thread's warpgroup, as a value the compiler knows to be the same
// across a warp (a shuffle from lane 0), so that what derives from it
// (tile indices, shared addresses, wgmma descriptors) stays in uniform
// registers and out of the vector registers that O, S and P fill.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Block z's pair of 64-row q units and their key tiles, the longest
// unit b first: with mirror pairs b = U-1-z and a = z (a == b for the
// middle unit of an odd U, which the block sweeps alone: has_a false,
// na 0); with neighbour pairs b = U-1-2z and a = b-1 (none below 0).
struct Pair {
  int z, head, batch, unit_a, unit_b, na, nb;
  bool has_a;

  __device__ __forceinline__ Pair(int sq, int skv, int causal, int mirror) {
    z = mirror ? blockIdx.x : blockIdx.z;
    head = mirror ? blockIdx.y : blockIdx.x;
    batch = mirror ? blockIdx.z : blockIdx.y;
    const int units = (sq + kUnit - 1) / kUnit;
    if (mirror) {
      unit_b = units - 1 - z;   // the longest unit first
      unit_a = z;
      has_a = unit_a < unit_b;
    } else {
      unit_b = units - 1 - 2 * z;   // the longest pair first
      unit_a = unit_b - 1;
      has_a = unit_a >= 0;
    }
    nb = key_tiles(unit_b * kUnit + kUnit - 1, skv, causal);
    na = has_a ? key_tiles(unit_a * kUnit + kUnit - 1, skv, causal) : 0;
  }
};

// The shared base, 1024-byte aligned (the 128-byte swizzle repeats every
// 1024 bytes).
__device__ __forceinline__ uint32_t shared_base(const void* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

// S (64 x 64, fp32) = Q (64 rows at q) · K (the tile at k)^T: a 16-column
// step moves 32 bytes inside a box, every fourth step to the next box;
// the steps past dv add zeros.
template <typename T>
__device__ __forceinline__ void qk_product(float (&s)[kBN / 2], uint32_t q,
                                           uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64<T>(s, sw128_desc(q + off, 16, 1024),
                    sw128_desc(k + off, 16, 1024), kk > 0);
  }
}

// O += P·V (the tile at v): V is MN-major; a 16-key step moves 16 rows
// (2048 bytes); O's second half starts two boxes (128 columns) further.
template <typename T>
__device__ __forceinline__ void pv_product(float (&o)[2][64],
                                           const uint32_t (&p)[kBN / 16][4],
                                           uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t vk = v + kk * 16 * 128;
    wgmma_rs_n128<T>(o[0], p[kk], sw128_desc(vk, kBox, 1024));
    wgmma_rs_n128<T>(o[1], p[kk], sw128_desc(vk + 2 * kBox, kBox, 1024));
  }
}

// The online softmax of one tile in registers: s[4j + e] is row row0 + 8
// (e / 2) of the unit at q0, key kv0 + 8 j + cq + e % 2.  Turns S into
// P = exp2(s - m) in fp32 in place, updates m and l, and gives the
// factor alpha that O takes once the P·V product before it has retired.
// The softcap's tanh is 1 - 2 / (1 + e^2x) on ex2.approx, within about
// 1e-7 of tanh (about 1e-5 of a logit at a cap of 50).
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int q0,
                                             int kv0, int skv, int causal,
                                             float scale, float softcap) {
  const int wt = threadIdx.x % 128;
  const int row0 = (wt / 32) * 16 + (wt % 32) / 4;
  const int cq = 2 * (wt % 4);
  if (softcap > 0.f) {
    const float k2 = scale / softcap * (2.f * kLog2e);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      s[i] = softcap - __fdividef(2.f * softcap,
                                  1.f + exp2_approx(s[i] * k2));
  }
  const float sl = (softcap > 0.f ? 1.f : scale) * kLog2e;
  const bool edge = (causal && kv0 + kBN - 1 > q0) || kv0 + kBN > skv;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sl;
      if (edge) {
        const int qpos = q0 + row0 + 8 * (e / 2);
        const int kpos = kv0 + 8 * j + cq + e % 2;
        if (skv <= kpos || (causal && qpos < kpos)) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    alpha[i] = exp2_approx(m[i] - mu[i]);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    s[i] = exp2_approx(s[i] - mu[(i / 2) % 2]);
    l[(i / 2) % 2] += s[i];
  }
}

// P in T as P·V's A operand: registers 8kk .. 8kk+7 of S are the
// fragment of keys 16kk .. 16kk+15, in order.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2],
                                       uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[2][64],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][4 * j + e] *= alpha[e / 2];
      o[1][4 * j + e] *= alpha[e / 2];
    }
}

__device__ __forceinline__ void st_b32(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(x) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// O / l in T for the unit at q0 of this block's (head, batch), through
// shared memory: each thread writes its rows into buf (the unit's Q
// tile, which no product reads any more) in the 128-byte swizzle, and
// one thread stores the boxes below dv with TMA, which writes no row
// past Sq and no column past dv (the map's bounds).  The thread that
// issued the stores waits for them to read buf before its warpgroup
// ends (store_done).
template <typename T>
__device__ __forceinline__ void store_unit(const float (&o)[2][64],
                                           float (&l)[2], uint32_t buf,
                                           const CUtensorMap* to, int q0,
                                           int dv, int head, int batch) {
  const int wt = threadIdx.x % 128;
  const int row0 = (wt / 32) * 16 + (wt % 32) / 4;
  const int cq = 2 * (wt % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / l[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      // columns 8j .. 8j+7: box j / 8, 16-byte chunk j % 8 of row r
      const int c = 4 * (j % 16) + 2 * i;
      const float x0 = j < 16 ? o[0][c] : o[1][c];
      const float x1 = j < 16 ? o[0][c + 1] : o[1][c + 1];
      st_b32(buf + (j / 8) * kBox + r * 128 + (((j % 8) ^ (r % 8)) << 4) +
                 2 * cq,
             pack<T>(x0 * l[i], x1 * l[i]));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // this warpgroup's 128 threads (barrier 2 or 3)
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + threadIdx.x / 128 - 1)
               : "memory");
  if (wt == 0) {
    for (int x = 0; x < (dv + kBoxCols - 1) / kBoxCols; ++x)
      tma_store(to, buf + x * kBox, x * kBoxCols, head, q0, batch);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

__device__ __forceinline__ void store_done() {
  if (threadIdx.x % 128 == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One consumer warpgroup's sweep of a unit (its Q rows at q, the first
// row at position q0) over the key tiles of [lo, hi) that are its own:
// every one below mid, then every other one from mid (the ones between
// are the other consumer's; this one passes them).  lo is its own.  The
// state (o, m, l) starts empty: O 0, m -inf, l 0.
//
// Each round issues S of tile t and P·V of the tile before it as two
// groups, runs the softmax of t once the first has retired (wait_group
// 1) while the second still runs, and rescales O once the second has.
// One S product and one P·V product stand in the code, each a site of
// its own in registers: the first round's P·V multiplies a zero P (with
// V of the first tile, which lands with its K) and the last round's S is
// the last tile's again, discarded, whose K stage stays held until then.
template <typename T>
__device__ __forceinline__ void sweep(float (&o)[2][64], float (&m)[2],
                                      float (&l)[2], const Ring& r,
                                      uint32_t q, int q0, int lo, int mid,
                                      int hi, int skv, int causal,
                                      float scale, float softcap) {
  if (lo >= hi) return;
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  uint32_t p[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < kBN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0u;
  float alpha[2];
  int prev = lo;
  int t = lo;
  for (;;) {
    const bool past = t >= hi;
    const int tk = past ? prev : t;
    r.wait_k(tk);
    r.wait_v(prev);
    const uint32_t v_prev = r.base + Smem::V + kTile * (prev % kVStages);
    keep_o(o);
    wgmma_fence();
    qk_product<T>(s, q, r.k(tk));
    wgmma_commit();
    pv_product<T>(o, p, v_prev);
    wgmma_commit();
    wgmma_wait1();
    keep(s);
    int after = t + 1;   // this sweep's tile after t
    if (after > mid && (after - mid) % 2 == 1) ++after;
    if (past || after < hi) r.free_k(tk);
    if (!past)
      softmax_tile(s, m, l, alpha, q0, t * kBN, skv, causal, scale, softcap);
    wgmma_wait0();
    keep_o(o);
    hold(p);
    if (t != lo) r.free_v(prev);
    if (past) break;
    rescale(o, alpha);
    pack_p<T>(s, p);
    prev = t;
    t = r.next(t + 1, mid, hi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wide(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, int sq, int skv,
                  int h, int hkv, int dv, int causal, float scale,
                  float softcap, int mirror) {
  extern __shared__ __align__(1024) unsigned char smem_wide[];
  {
    const uint32_t base = shared_base(smem_wide);
    const Ring ring{base};
    if (threadIdx.x == 0) {
      mbar_init(base + Smem::BAR, 1);   // Q
      for (int s = 0; s < kKStages; ++s) {
        mbar_init(ring.kfull(s), 1);
        mbar_init(ring.kempty(s), kConsumerWarps);
      }
      for (int s = 0; s < kVStages; ++s) {
        mbar_init(ring.vfull(s), 1);
        mbar_init(ring.vempty(s), kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // Zeros in the boxes past dv (never loaded): of both units' Q and of
    // every K and V stage, seven tiles in a row from the base.
    const int boxes = (dv + kBoxCols - 1) / kBoxCols;
    const int pad = (kBoxes - boxes) * kBox / 16;
    for (int i = threadIdx.x; i < 7 * pad; i += kThreads)
      zero16(base + (i / pad) * kTile + boxes * kBox + 16 * (i % pad));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {
    // Producer: one thread keeps both rings filled.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const uint32_t base = shared_base(smem_wide);
      const Ring ring{base};
      const Pair pr(sq, skv, causal, mirror);
      const int head = pr.head;
      const int b = pr.batch;
      const int kvh = head / (h / hkv);
      const int boxes = (dv + kBoxCols - 1) / kBoxCols;
      const uint32_t q_full = base + Smem::BAR;
      mbar_expect_tx(q_full, (pr.has_a ? 2 : 1) * boxes * kBox);
      for (int x = 0; x < boxes; ++x) {
        if (pr.has_a)
          tma_load(base + Smem::Q + x * kBox, &tq, q_full, x * kBoxCols,
                   head, pr.unit_a * kUnit, b);
        tma_load(base + Smem::Q + kTile + x * kBox, &tq, q_full,
                 x * kBoxCols, head, pr.unit_b * kUnit, b);
      }
      for (int t = 0; t < pr.nb; ++t) {
        if (t >= kKStages)
          wait(ring.kempty(t), (t / kKStages - 1) & 1);
        mbar_expect_tx(ring.kfull(t), boxes * kBox);
        for (int x = 0; x < boxes; ++x)
          tma_load(ring.k(t) + x * kBox, &tk, ring.kfull(t), x * kBoxCols,
                   kvh, t * kBN, b);
        if (t >= kVStages)
          wait(ring.vempty(t), (t / kVStages - 1) & 1);
        mbar_expect_tx(ring.vfull(t), boxes * kBox);
        for (int x = 0; x < boxes; ++x)
          tma_load(base + Smem::V + kTile * (t % kVStages) + x * kBox, &tv,
                   ring.vfull(t), x * kBoxCols, kvh, t * kBN, b);
      }
    }
    return;
  }

  // Consumers: a thread holds rows row0 and row0 + 8 of its unit, and in
  // each 8-column block of a product the columns cq and cq + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const Pair pr(sq, skv, causal, mirror);
  const uint32_t base = shared_base(smem_wide);
  const Ring ring{base};

  // O: columns 0-127 in o[0], 128-255 in o[1], each in the m64n128
  // accumulator layout.
  float o[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  wait(base + Smem::BAR, 0);   // Q
  // The sweeps, one call site for both consumers (each site of a wgmma
  // holds its accumulators in registers of its own): consumer 0 sweeps
  // unit a (segment 0), passes consumer 1's first tile past a and stores
  // a, then sweeps its share of unit b from na + 1 (segment 1); consumer
  // 1 sweeps unit b (segment 1): every tile below na, then every other
  // one from na.
  if (c == 0 && !pr.has_a) ring.pass(0);
#pragma unroll 1
  for (int seg = c == 0 && pr.has_a ? 0 : 1; seg < 2; ++seg) {
    const bool is_a = seg == 0;
    const int from = c == 1 || is_a ? 0 : pr.na + 1;
    const int mid = c == 1 || is_a ? pr.na : pr.na + 1;
    sweep<T>(o, m, l, ring, base + Smem::Q + (is_a ? 0 : kTile),
             (is_a ? pr.unit_a : pr.unit_b) * kUnit, from, mid,
             is_a ? pr.na : pr.nb, skv, causal, scale, softcap);
    if (is_a) {
      if (pr.na < pr.nb) ring.pass(pr.na);
      store_unit<T>(o, l, base + Smem::Q, &to, pr.unit_a * kUnit, dv,
                    pr.head, pr.batch);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
  }
  if (pr.na + 1 < pr.nb) {
    // Consumer 0 swept a share of unit b: its (O, m, l) to consumer 1
    // through the rings, a thread's 132 floats 512 bytes apart (thread
    // wt of each warpgroup holds the same rows and columns).
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const uint32_t mine = base + Smem::MERGE + 4 * (threadIdx.x % 128);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        st_f32(mine + 512 * i, o[0][i]);
        st_f32(mine + 512 * (64 + i), o[1][i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st_f32(mine + 512 * (128 + i), m[i]);
        st_f32(mine + 512 * (130 + i), l[i]);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (c == 0) {
      store_done();
      return;
    }
    float f1[2], f0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m0 = ld_f32(mine + 512 * (128 + i));
      const float m_new = fmaxf(m[i], m0);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      f1[i] = exp2_approx(m[i] - mu);
      f0[i] = exp2_approx(m0 - mu);
      l[i] = l[i] * f1[i] + ld_f32(mine + 512 * (130 + i)) * f0[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o[0][i] = o[0][i] * f1[(i / 2) % 2] +
                ld_f32(mine + 512 * i) * f0[(i / 2) % 2];
      o[1][i] = o[1][i] * f1[(i / 2) % 2] +
                ld_f32(mine + 512 * (64 + i)) * f0[(i / 2) % 2];
    }
  } else if (c == 0) {
    store_done();
    return;
  }
  store_unit<T>(o, l, base + Smem::Q + kTile, &to, pr.unit_b * kUnit, dv,
                pr.head, pr.batch);
  store_done();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int h, int hkv, int dv, int causal, float scale,
           float softcap, cudaStream_t stream) {
  constexpr CUtensorMapDataType kMap = Elem<T>::kMap;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, batch, sq, h, dv, kMap, 2, kBoxCols, kUnit) ||
      !tensor_map(&tk, k, batch, skv, hkv, dv, kMap, 2, kBoxCols, kBN) ||
      !tensor_map(&tv, v, batch, skv, hkv, dv, kMap, 2, kBoxCols, kBN) ||
      !tensor_map(&to, out, batch, sq, h, dv, kMap, 2, kBoxCols, kUnit))
    return -2;
  constexpr int smem = Smem::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool mirror = mirror_pairs(batch, sq, h);
  flash_kernel_wide<T><<<grid(batch, sq, h, mirror), kThreads, smem,
                         stream>>>(tq, tk, tv, to, sq, skv, h, hkv, dv,
                                   causal, scale, softcap, mirror);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores.
//
// Every fp32 operand x is split into two TF32 values, hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna: to nearest, ties away from zero), which
// together keep about 21 of its 24 mantissa bits, and each product a·b is
// taken as hi_a·lo_b + lo_a·hi_b + hi_a·hi_b, the two small terms first,
// on TF32 wgmma (m64nNk8) summed in fp32.  One TF32 product alone rounds
// each input to 10 bits and misses the reference's fp32 tolerance of 2e-5
// (tests/test_torch_flash_attention.py models both on the CPU).
//
// What bounds it: the products, 4·D flops per attended (q,k) pair, three
// TF32 products each, over 495 TFLOP/s (at causal S 1024, H 32, D 128:
// 3 x 8.6e9 flops, 0.052 ms), above the bytes' time (0.020 ms) and below
// the same flops as fp32 FMAs (0.128 ms at 67 TFLOP/s).
//
// The design (TMA and wgmma as in the bf16 kernel; no producer warps):
// - One block of two warpgroups (256 threads) per (128-row q tile, head,
//   batch), the longest rows first.  Thread 0 issues the TMA loads: Q
//   once, and K and V one raw tile of 32 keys at a time, through 4-D maps
//   over (D, H, S, B) in boxes of 32 fp32 columns (128 bytes) with the
//   128-byte swizzle; rows past S arrive as zeros.
// - TF32 wgmma reads A and B only K-major.  Q (A of S = Q·K^T) and K (B)
//   are K-major as stored.  V (B of O += P·V) is not, so each V tile is
//   written transposed: a row of Vᵀ, 32 keys of one column, is one
//   128-byte swizzle row.
// - Every thread splits its share of each landed raw tile into a 2-stage
//   ring: K into hi and lo in its own swizzled layout, V into Vᵀ hi and
//   lo.  Tile t + 1 is split while tile t's P·V runs on the tensor cores;
//   the block's barrier after it publishes the stage and frees the raw
//   tile for the load of t + 2, which lands while tile t + 1 computes.
// - Within each group of 8 keys Vᵀ holds the keys in the order 0 2 4 6 1
//   3 5 7: a thread's S accumulator holds keys 2t and 2t+1 of a group
//   where TF32's A fragment takes k = t and t + 4 (a0 (g, t), a1 (g+8,
//   t), a2 (g, t+4), a3 (g+8, t+4), as a probe on the card read it), so
//   in that order P feeds wgmma from the registers it was computed in,
//   with no shuffle and no round trip through shared memory.
// - Each warpgroup owns 64 q rows.  Q stays as it landed: the tensor core
//   reads its fp32 bits truncated to TF32 (the same probe), and those
//   serve as Q's hi; its lo, x - trunc(x) rounded to TF32, is taken into
//   registers once, as A of Q_lo·K_hi.  S is m64n32k8 products; the
//   online softmax runs in registers as in the bf16 kernel (exp2, log2 e
//   folded into the scale); P is split in registers and O += P·V is
//   m64n64k8 or m64n128k8, O in registers for the whole sweep.  Tiles
//   wholly above a warpgroup's diagonal are not computed, those above the
//   block's never loaded; the mask is applied only on tiles that cross
//   the diagonal or the Skv edge.
// - Shared memory at D 128: Q 64 KB, the ring of K hi/lo and Vᵀ hi/lo 128
//   KB, one raw K/V tile 32 KB: 224 KB, one block an SM.  Head dims up to
//   64 run P·V 64 columns wide, wider ones 128: the rows of Vᵀ past D are
//   never written, and the O columns they feed never stored.
// - Registers: O, Q's lo and P's fragments take 160 at D 128, which eight
//   warps leave room for (up to 255 a thread; ptxas: 223, no spills).
//   With a third, splitting warpgroup a thread has 168 (each of the SM's
//   four 16,384-register files then holds three warps): the kernel
//   spilled or had to reload Q's lo every tile, and moving registers to
//   the other warpgroups with setmaxnreg (96 / 208) failed its launch on
//   the card (PERF.md, PR 30).
// Left for later: the two warpgroups run in step (one barrier a tile), so
// the tensor cores idle while both take their softmax; the SS products of
// S read Q's 2 KB k-step from shared memory twice; Vᵀ's writes and the raw
// tile's reads conflict 2-way in the banks.
namespace f32 {

constexpr int kBM = 128;          // q rows per block, 64 per warpgroup
constexpr int kBN = 32;           // keys per tile: one 128-byte row of Vᵀ
constexpr int kStages = 2;        // depth of the split K/Vᵀ ring
constexpr int kThreads = 256;     // two warpgroups
constexpr int kBoxCols = 32;      // fp32 columns of a TMA box: 128 bytes

// Dynamic shared memory, byte offsets from a 1024-byte aligned base.
template <int D>
struct Smem {
  static constexpr int BOXES = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int PV = D <= 64 ? 64 : 128;   // columns of O and rows of Vᵀ
  static constexpr int QBOX = kBM * 128;          // one box of the q tile
  static constexpr int KBOX = kBN * 128;          // one box of a K or V tile
  static constexpr int KT = BOXES * KBOX;         // a K tile (or a raw V tile)
  static constexpr int VT = PV * 128;             // a Vᵀ tile
  static constexpr int Q = 0;                     // the q tile, as landed
  static constexpr int RING = Q + BOXES * QBOX;   // K hi, K lo, Vᵀ hi, Vᵀ lo
  static constexpr int STAGE = 2 * KT + 2 * VT;
  static constexpr int RAW = RING + kStages * STAGE;   // raw K, raw V
  static constexpr int BAR = RAW + 2 * KT;        // q, raw
  static constexpr int BYTES = BAR + 16 + 1024;
};

// x as hi + lo, two TF32 values in fp32 bit patterns (cvt.rna leaves the
// 13 low bits zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Shared-memory loads and stores at shared addresses.
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// x, in a way the compiler cannot see through: shared addresses derived
// from it inside a loop are computed there, not kept in registers across
// the loop (the tile loops would otherwise hold dozens of them).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Component i of v (i a constant once unrolled).
__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// S (64 x 32) (+)= A (64 x 8, smem) * B (32 x 8, smem)^T in TF32, both
// K-major with the 128-byte swizzle; scale_d 0 overwrites S.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// S (64 x 32) += A (64 x 8, TF32 registers) * B (32 x 8, smem)^T.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// S (64 x 16) (+)= A (64 x 8, TF32 registers) * B (16 x 8, smem)^T;
// scale_d 0 overwrites S.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// O (64 x 64) += A (64 x 8, TF32 registers) * B (64 x 8, smem)^T.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// O (64 x 128) += A (64 x 8, TF32 registers) * B (128 x 8, smem)^T.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// O += P·V for one 8-key step of the tile: a P fragment, one Vᵀ k-step.
template <int PV>
__device__ __forceinline__ void pv_tf32(float (&o)[PV / 2],
                                        const uint32_t (&p)[4], uint32_t vt) {
  if constexpr (PV == 128)
    wgmma_tf32_rs_n128(o, p, sw128_desc(vt, 16, 1024));
  else
    wgmma_tf32_rs_n64(o, p, sw128_desc(vt, 16, 1024));
}

// Key tiles that a q row up to qlast attends: all of Skv, or causally up
// to its diagonal.
__device__ __forceinline__ int key_tiles(int qlast, int skv, int causal) {
  int n = (skv + kBN - 1) / kBN;
  if (causal) n = min(n, qlast / kBN + 1);
  return n;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ out, int sq, int skv, int h, int hkv,
                  int causal, float scale, float softcap) {
  using L = Smem<D>;
  constexpr int PV = L::PV;
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  const uint32_t base = (smem_addr(smem_f32) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t raw_full = q_full + 8;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // longest rows first
  const int kvh = head / (h / hkv);
  const int n_tiles = key_tiles(q0 + kBM - 1, skv, causal);
  const auto load_raw = [&](int t) {
    mbar_expect_tx(raw_full, 2 * L::KT);
    for (int x = 0; x < L::BOXES; ++x) {
      tma_load(base + L::RAW + x * L::KBOX, &tk, raw_full, x * kBoxCols, kvh,
               t * kBN, b);
      tma_load(base + L::RAW + L::KT + x * L::KBOX, &tv, raw_full,
               x * kBoxCols, kvh, t * kBN, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(raw_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, L::BOXES * L::QBOX);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load(base + L::Q + x * L::QBOX, &tq, q_full, x * kBoxCols, head, q0,
               b);
    load_raw(0);
  }
  __syncthreads();

  // Splits raw tile t (landed) into its stage of the ring, this thread's
  // share of it; the block's barrier after it makes the stage whole.
  const auto split_tile = [&](int t) {
    const uint32_t tb = opaque(base);
    const uint32_t ring = tb + L::RING + (t % kStages) * L::STAGE;
    const uint32_t raw = tb + L::RAW;
    mbar_wait(raw_full, t & 1);
    // K: hi and lo at the offsets the raw tile has, 16 bytes a step.
    constexpr int kSteps = L::KT / 16 / kThreads;
    float4 x[kSteps];
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
      x[n] = lds4(raw + 16 * (threadIdx.x + kThreads * n));
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      const uint32_t c = 16 * (threadIdx.x + kThreads * n);
      uint4 hi, lo;
      split(x[n].x, hi.x, lo.x);
      split(x[n].y, hi.y, lo.y);
      split(x[n].z, hi.z, lo.z);
      split(x[n].w, hi.w, lo.w);
      sts4(ring + c, hi);
      sts4(ring + L::KT + c, lo);
    }
    // Vᵀ: item (dq, grp, half) reads keys 8 grp + half + 2m (m < 4) of
    // columns 4 dq .. 4 dq + 3 and writes them as positions 4 half ..
    // 4 half + 3 of key group grp in those four rows of Vᵀ.
#pragma unroll
    for (int n = 0; n < (2 * D + kThreads - 1) / kThreads; ++n) {
      const int it = threadIdx.x + kThreads * n;
      if (it >= 2 * D) break;
      const int half = it & 1;
      const int grp = (it >> 1) & 3;
      const int dq = it >> 3;
      float4 v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int key = 8 * grp + half + 2 * m;
        v[m] = lds4(raw + L::KT + (dq / 8) * L::KBOX + key * 128 +
                    (((dq % 8) ^ (key % 8)) << 4));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * dq + i;
        const uint32_t off =
            ring + 2 * L::KT + d * 128 + (((2 * grp + half) ^ (d % 8)) << 4);
        uint4 hi, lo;
        split(component(v[0], i), hi.x, lo.x);
        split(component(v[1], i), hi.y, lo.y);
        split(component(v[2], i), hi.z, lo.z);
        split(component(v[3], i), hi.w, lo.w);
        sts4(off, hi);
        sts4(off + L::VT, lo);
      }
    }
  };
  // The split stage made visible to wgmma, and the raw tile read by
  // every thread: the load of raw tile `next` goes out.
  const auto tiles_split = [&](int next) {
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0 && next < n_tiles) load_raw(next);
  };

  // Warpgroup wg owns rows [r_wg, r_wg + 64) of the q tile; a thread holds
  // rows row0 and row0 + 8, and in each 8-column block of a product the
  // columns cq and cq + 1.
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int r_wg = wg * 64;
  const int row0 = r_wg + warp * 16 + lane / 4;
  const int quad = lane % 4;
  const int cq = 2 * quad;
  const float sl = (softcap > 0.f ? 1.f : scale) * kLog2e;
  const int n_own = key_tiles(q0 + r_wg + 63, skv, causal);

  split_tile(0);
  tiles_split(1);

  // Q stays as TMA landed it: its hi is its fp32 bits, which the tensor
  // core reads truncated to TF32; its lo, x - trunc(x) rounded to TF32,
  // goes into the A fragments of Q_lo·K_hi (k-step kk: rows row0 / row0 +
  // 8, columns 8 kk + quad and 8 kk + quad + 4) once for the sweep.
  mbar_wait(q_full, 0);
  uint32_t q_lo[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1);
      const int chunk = 2 * (kk % 4) + (r >> 1);
      const float x = lds(base + L::Q + (kk / 4) * L::QBOX + row * 128 +
                          ((chunk ^ (row % 8)) << 4) + 4 * quad);
      asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(q_lo[kk][r])
          : "f"(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)));
    }
  }

  float o[PV / 2];
#pragma unroll
  for (int i = 0; i < PV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t >= n_own) {                 // wholly above this warpgroup's rows
      if (t + 1 < n_tiles) split_tile(t + 1);
      tiles_split(t + 2);
      continue;
    }
    const int stage = t % kStages;
    const int kv0 = t * kBN;
    const uint32_t tb = opaque(base);
    const uint32_t q_tile = tb + L::Q + r_wg * 128;   // 128 bytes a row
    const uint32_t k_hi = tb + L::RING + stage * L::STAGE;
    const uint32_t k_lo = k_hi + L::KT;
    const uint32_t vt_hi = tb + L::RING + stage * L::STAGE + 2 * L::KT;
    const uint32_t vt_lo = vt_hi + L::VT;

    // S = Q K^T, the small products (Q_hi·K_lo, Q_lo·K_hi) first, then
    // the big ones (Q_hi·K_hi); a k-step of 8 columns moves 32 bytes
    // inside a box, every fourth step to the next box.
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qa = q_tile + (kk / 4) * L::QBOX + (kk % 4) * 32;
      const uint32_t kb = (kk / 4) * L::KBOX + (kk % 4) * 32;
      wgmma_tf32_ss_n32(s, sw128_desc(qa, 16, 1024),
                        sw128_desc(k_lo + kb, 16, 1024), kk > 0);
      wgmma_tf32_rs_n32(s, q_lo[kk], sw128_desc(k_hi + kb, 16, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qa = q_tile + (kk / 4) * L::QBOX + (kk % 4) * 32;
      const uint32_t kb = (kk / 4) * L::KBOX + (kk % 4) * 32;
      wgmma_tf32_ss_n32(s, sw128_desc(qa, 16, 1024),
                        sw128_desc(k_hi + kb, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    keep(s);

    // Online softmax in registers: s[4j + e] is row row0 + 8 (e / 2),
    // key kv0 + 8 j + cq + e % 2.
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        s[i] = tanhf(s[i] * scale / softcap) * softcap;
    }
    const bool edge = (causal && kv0 + kBN - 1 > q0 + r_wg) || kv0 + kBN > skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl;
        if (edge) {
          const int qpos = q0 + row0 + 8 * (e / 2);
          const int kpos = kv0 + 8 * j + cq + e % 2;
          if (kpos >= skv || (causal && kpos > qpos)) x = -INFINITY;
        }
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      const float alpha = exp2_approx(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < PV / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }
    // P split into the A fragments of the 8-key steps: register r holds
    // row row0 + 8 (r & 1) at k = quad + 4 (r >> 1), which is key 2 quad +
    // (r >> 1) of the step in Vᵀ's key order, s[4 kk + e] with
    // e = 2 (r & 1) + (r >> 1).
    uint32_t p_hi[kBN / 8][4], p_lo[kBN / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 2 * (r & 1) + (r >> 1);
        const float p = exp2_approx(s[4 * kk + e] - mu[e / 2]);
        l[e / 2] += p;
        split(p, p_hi[kk][r], p_lo[kk][r]);
      }
    }

    // O += P V, the small products first: an 8-key step moves 32 bytes
    // along Vᵀ's rows.  The next tile is split while it runs.
    keep(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      pv_tf32<PV>(o, p_hi[kk], vt_lo + 32 * kk);
      pv_tf32<PV>(o, p_lo[kk], vt_hi + 32 * kk);
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk)
      pv_tf32<PV>(o, p_hi[kk], vt_hi + 32 * kk);
    wgmma_commit();
    if (t + 1 < n_tiles) split_tile(t + 1);
    wgmma_wait0();
    keep(o);
    tiles_split(t + 2);
  }

  // Epilogue: O / l, rows past Sq and columns past D not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row0 + 8 * i;
    if (qpos >= sq) continue;
    const float inv = 1.f / l[i];
    float* dst = out + (((size_t)b * sq + qpos) * h + head) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int h, int hkv, int causal, float scale,
           float softcap, cudaStream_t stream) {
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, batch, sq, h, D, kF32, 4, kBoxCols, kBM) ||
      !tensor_map(&tk, k, batch, skv, hkv, D, kF32, 4, kBoxCols, kBN) ||
      !tensor_map(&tv, v, batch, skv, hkv, D, kF32, 4, kBoxCols, kBN))
    return -2;
  constexpr int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, batch, (sq + kBM - 1) / kBM);
  flash_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), sq, skv, h, hkv, causal, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 at head_dims 144 to 256: flash_fp32_kernel_wide, 3xTF32 with a
// producer warpgroup, the two consumer warpgroups splitting D.
//
// The D-128 shape does not widen: at D 256 its q tile alone takes 128 KB
// and every thread would hold 128 registers of O and 128 of Q's lo.  So
// a block takes 64 q rows, and consumer warpgroup c owns the columns
// [128 c, 128 c + 128) of Q, K, V and O for all of them.  What bounds it
// on this card: the 3xTF32 products (the bound of PERF.md), and, per
// 16-key tile, the shared memory that the products, the split and the
// exchanges move (about 270 KB a tile at 128 bytes a clock, against
// about 1540 clocks of TF32 products).  The design:
// - Three warpgroups (384 threads).  Warpgroup 0 is the producer
//   (setmaxnreg 72; the consumers take 216, the 168 a thread that 384
//   threads launch with, moved; consumers spilled at 208, the splitters
//   at 56).  Its lane 0 issues every TMA load: Q once, then each 16-key
//   tile's K into its stage of a 3-stage K ring and its V into its stage
//   of a 2-stage ring, each as soon as the consumers have freed the
//   stage, polling both rings so that neither waits behind the other.
//   Its three other warps split each K tile as it lands: K's lo beside K
//   in its stage, published through an mbarrier of their 96 arrivals,
//   each after the thread's proxy fence.
// - No transpose: TF32 wgmma reads B only K-major, and V as stored is
//   not (its keys are rows), so the consumers take Oᵀ = Vᵀ·Pᵀ, whose B is
//   Pᵀ, K-major as P is computed (a q row's keys).  Vᵀ is the A operand:
//   each thread reads its fragments of the tile straight from the TMA
//   tile (16 words) and splits them in registers.  P, split, goes to a
//   buffer of the consumer's own, 128-byte rows of 32 keys (tile t at
//   bytes 64 (t % 2)), with the rows' rescale factors beside it.
// - Boxes of 32 fp32 columns (128 bytes, the 128-byte swizzle); only
//   those that hold a column below the head_dim dv, a runtime value, are
//   loaded (one kernel serves every multiple of 16 from 144 to 256).  The
//   block zeroes Q's, K's and V's boxes past dv once, so every product
//   runs its full width with no branch around a wgmma.
// - K's hi is K as it landed, read by the tensor core truncated to TF32,
//   as Q's is.  A K stage holds each box's 16 rows of K followed by its
//   16 rows of K's lo, so that one m64n32k8 product per k-step takes
//   Q_hi·K_hi and Q_hi·K_lo together: Q's 2 KB k-step is read from shared
//   memory once a tile instead of twice.  Q's lo (x - trunc(x), rounded)
//   sits in registers, the A of an m64n16k8 Q_lo·K_hi (Q's hi there too
//   would take the consumers past their registers).  Each consumer sums
//   its half of the k-depth as hi·hi + (hi·lo + lo·hi); the two partial S
//   (64 x 16, 4 KB each) are traded through the first box of each
//   consumer's half of the K stage, which only its own product reads, one
//   named barrier of the two consumers a tile; each adds the other's to
//   its own in the same order, so both hold the same S and take the same
//   online softmax.  Oᵀ += Vᵀ·Pᵀ is two m64n64k8 products a k-step.
// - A consumer's round issues S of tile t and the P·V of the tile before
//   it as two groups, takes the exchange, the softmax and P's store once
//   S has retired (wait_group 1) while P·V still runs, then rescales Oᵀ
//   and reads V's fragments of tile t.  One S site and one P·V site: the
//   first round multiplies zeros, and the last takes S of the last tile
//   again, discarded.
// - O leaves through the consumer's half of the Q tile (idle by then),
//   Oᵀ written into it as O's rows, then stored 16 bytes a thread.
// - Shared memory: Q 64 KB, the K ring 3 x 32 KB, the V ring 2 x 16 KB,
//   P 2 x 16 KB: 224 KB.  Registers of a consumer: Oᵀ 64, Q's lo 64, S 24
//   (n32 and n16 sums), V's fragments 32.  One block a (64-row q tile,
//   head, batch), the longest rows first.
// Left for later (PERF.md): the splitters' shared-memory reads and the
// consumers' stores of P wait behind the products' reads, and a round's
// softmax, P store and fragment loads leave the tensor cores idle; two S
// accumulators, S of tile t + 1 under the softmax of t, would overlap
// them.
constexpr int kWideBM = 64;       // q rows per block, all of them in each consumer
constexpr int kWideBN = 16;       // keys per tile
constexpr int kWideKStages = 3;   // depth of the K ring
constexpr int kWideVStages = 2;   // depth of the raw V ring
constexpr int kWideThreads = 384; // producer warpgroup + two consumers
constexpr int kWideConsumerWarps = 8;
constexpr int kWideSplitters = 96;   // the producer's three splitting warps
constexpr int kBatch = 4;            // a splitting thread's loads in flight

// Dynamic shared memory, byte offsets from a 1024-byte aligned base.
struct WideSmem {
  static constexpr int D = 256;                   // columns of the tiles
  static constexpr int BOXES = D / kBoxCols;
  static constexpr int QBOX = kWideBM * 128;      // one box of the q tile
  static constexpr int KROWS = kWideBN * 128;     // one box's 16 rows
  static constexpr int KBOX = 2 * KROWS;          // K's rows, then K's lo
  static constexpr int KSTAGE = BOXES * KBOX;
  static constexpr int RAW = BOXES * KROWS;       // a V tile, as landed
  static constexpr int PBUF = kWideBM * 128;      // P hi or lo: 32 keys a row
  static constexpr int Q = 0;                     // the q tile, as landed
  static constexpr int K = Q + BOXES * QBOX;      // the K ring
  static constexpr int V = K + kWideKStages * KSTAGE;   // the V ring
  static constexpr int P = V + kWideVStages * RAW;      // per consumer: hi, lo
  static constexpr int ROWS = P + 2 * 2 * PBUF;   // per consumer: 64 floats
  static constexpr int BAR = ROWS + 2 * kWideBM * 4;
  // q, K landed, K split and K free of each K stage, V landed and V
  // free of each V stage
  static constexpr int BARS = 1 + 3 * kWideKStages + 2 * kWideVStages;
  static constexpr int BYTES = BAR + 8 * BARS + 1024;
};
static_assert(WideSmem::BYTES <= 232448, "one block an SM");

// x - trunc(x) rounded to TF32: the lo of an operand whose hi is its own
// bits truncated, as the tensor core reads them.
__device__ __forceinline__ uint32_t lo_of_truncated(float x) {
  uint32_t lo;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo)
      : "f"(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)));
  return lo;
}

__device__ __forceinline__ int wide_key_tiles(int qlast, int skv, int causal) {
  int n = (skv + kWideBN - 1) / kWideBN;
  if (causal) n = min(n, qlast / kWideBN + 1);
  return n;
}

// The barriers, at fixed offsets from the shared base: tile t's K stage
// is t % kWideKStages and its V stage t % kWideVStages; a stage's
// barriers complete once a wrap.
struct WideBars {
  uint32_t bar;   // base + WideSmem::BAR

  __device__ __forceinline__ uint32_t q() const { return bar; }
  __device__ __forceinline__ uint32_t k_landed(int t) const {
    return bar + 8 * (1 + t % kWideKStages);
  }
  __device__ __forceinline__ uint32_t k_split(int t) const {
    return bar + 8 * (1 + kWideKStages + t % kWideKStages);
  }
  __device__ __forceinline__ uint32_t k_free(int t) const {
    return bar + 8 * (1 + 2 * kWideKStages + t % kWideKStages);
  }
  __device__ __forceinline__ uint32_t v_landed(int t) const {
    return bar + 8 * (1 + 3 * kWideKStages + t % kWideVStages);
  }
  __device__ __forceinline__ uint32_t v_free(int t) const {
    return bar + 8 * (1 + 3 * kWideKStages + kWideVStages + t % kWideVStages);
  }
  // the phase of tile t's use of its K or V stage
  static __device__ __forceinline__ int k_lap(int t) {
    return (t / kWideKStages) & 1;
  }
  static __device__ __forceinline__ int v_lap(int t) {
    return (t / kWideVStages) & 1;
  }
};

// Every consumer warp arrives once it is done with a stage.
__device__ __forceinline__ void warp_frees(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// Keeps an A operand in its registers: before the fence, so that the
// compiler computes it there, and after the product has retired.
__device__ __forceinline__ void hold4(const uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[j]) : "memory");
}

__device__ __forceinline__ void st2(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(x), "r"(y)
               : "memory");
}

__device__ __forceinline__ float2 ld2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

// The producer warpgroup's TMA thread: Q once, then the K and V tiles of
// the block's sweep into their rings, each as soon as its stage is free
// (the consumers done with the tile a ring's depth before), whichever
// comes first.  It waits apart from the splitting warps.
__device__ __forceinline__ void wide_load(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    uint32_t base, int n, int boxes, int head, int kvh, int b, int q0) {
  using L = WideSmem;
  const WideBars br{base + L::BAR};
  const auto load_k = [&](int t) {
    const uint32_t dst = base + L::K + (t % kWideKStages) * L::KSTAGE;
    mbar_expect_tx(br.k_landed(t), boxes * L::KROWS);
    for (int x = 0; x < boxes; ++x)
      tma_load(dst + x * L::KBOX, tk, br.k_landed(t), x * kBoxCols, kvh,
               t * kWideBN, b);
  };
  const auto load_v = [&](int t) {
    const uint32_t dst = base + L::V + (t % kWideVStages) * L::RAW;
    mbar_expect_tx(br.v_landed(t), boxes * L::KROWS);
    for (int x = 0; x < boxes; ++x)
      tma_load(dst + x * L::KROWS, tv, br.v_landed(t), x * kBoxCols, kvh,
               t * kWideBN, b);
  };
  mbar_expect_tx(br.q(), boxes * L::QBOX);
  for (int x = 0; x < boxes; ++x)
    tma_load(base + L::Q + x * L::QBOX, tq, br.q(), x * kBoxCols, head, q0,
             b);
  int tk_ = min(n, kWideKStages), tv_ = min(n, kWideVStages);
  for (int t = 0; t < tk_; ++t) load_k(t);
  for (int t = 0; t < tv_; ++t) load_v(t);
  uint64_t t0 = now_ns();
  while (tk_ < n || tv_ < n) {
    bool moved = false;
    if (tk_ < n &&
        mbar_try_wait(br.k_free(tk_), WideBars::k_lap(tk_ - kWideKStages))) {
      load_k(tk_++);
      moved = true;
    }
    if (tv_ < n &&
        mbar_try_wait(br.v_free(tv_), WideBars::v_lap(tv_ - kWideVStages))) {
      load_v(tv_++);
      moved = true;
    }
    if (moved)
      t0 = now_ns();
    else if (now_ns() - t0 > 1000000000ull)
      wait_failed();
  }
}

// The producer warpgroup's three splitting warps (thread w of their 96):
// each tile's K lo beside K in its stage, published to the consumers
// (96 arrivals, each after the thread's proxy fence).
__device__ __forceinline__ void wide_split(uint32_t base, int w, int n,
                                           int boxes) {
  using L = WideSmem;
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const uint32_t tb = opaque(base);
    const WideBars br{tb + L::BAR};
    const uint32_t kst = tb + L::K + (t % kWideKStages) * L::KSTAGE;
    mbar_wait(br.k_landed(t), WideBars::k_lap(t));
    // kBatch 16-byte loads in flight, then their stores
#pragma unroll 1
    for (int f0 = w; f0 < boxes * 128; f0 += kBatch * kWideSplitters) {
      float4 k4[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kWideSplitters;
        if (f < boxes * 128)
          k4[u] = lds4(kst + (f / 128) * L::KBOX + 16 * (f % 128));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kWideSplitters;
        if (f < boxes * 128)
          sts4(kst + (f / 128) * L::KBOX + 16 * (f % 128) + L::KROWS,
               make_uint4(lo_of_truncated(k4[u].x), lo_of_truncated(k4[u].y),
                          lo_of_truncated(k4[u].z),
                          lo_of_truncated(k4[u].w)));
      }
    }
    fence_async_shared();
    mbar_arrive(br.k_split(t));
  }
}

__global__ void __launch_bounds__(kWideThreads, 1)
flash_fp32_kernel_wide(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       float* __restrict__ out, int sq, int skv, int h,
                       int hkv, int dv, int causal, float scale,
                       float softcap) {
  using L = WideSmem;
  extern __shared__ __align__(1024) unsigned char smem_f32w[];
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWideBM;  // longest rows first
  const int n = wide_key_tiles(q0 + kWideBM - 1, skv, causal);
  const int boxes = (dv + kBoxCols - 1) / kBoxCols;   // boxes with live columns
  {
    const uint32_t base = (smem_addr(smem_f32w) + 1023u) & ~1023u;
    const WideBars br{base + L::BAR};
    if (threadIdx.x == 0) {
      mbar_init(br.q(), 1);
      for (int s = 0; s < kWideKStages; ++s) {
        mbar_init(br.k_landed(s), 1);
        mbar_init(br.k_split(s), kWideSplitters);
        mbar_init(br.k_free(s), kWideConsumerWarps);
      }
      for (int s = 0; s < kWideVStages; ++s) {
        mbar_init(br.v_landed(s), 1);
        mbar_init(br.v_free(s), kWideConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // Zeros where no load or split writes: Q's boxes past dv, both K
    // stages' (K and its lo), every V stage's, and both consumers' P
    // buffers (the first round multiplies a zero P).
    const int qpad = (L::BOXES - boxes) * L::QBOX / 16;
    const int kpad = (L::BOXES - boxes) * L::KBOX / 16;
    const int vpad = (L::BOXES - boxes) * L::KROWS / 16;
    const int ppad = 4 * L::PBUF / 16;
    for (int i = threadIdx.x;
         i < qpad + kWideKStages * kpad + kWideVStages * vpad + ppad;
         i += kWideThreads) {
      uint32_t a;
      int j = i;
      if (j < qpad) {
        a = base + L::Q + boxes * L::QBOX + 16 * j;
      } else if ((j -= qpad) < kWideKStages * kpad) {
        a = base + L::K + (j / kpad) * L::KSTAGE + boxes * L::KBOX +
            16 * (j % kpad);
      } else if ((j -= kWideKStages * kpad) < kWideVStages * vpad) {
        a = base + L::V + (j / vpad) * L::RAW + boxes * L::KROWS +
            16 * (j % vpad);
      } else {
        a = base + L::P + 16 * (j - kWideVStages * vpad);
      }
      sts4(a, make_uint4(0, 0, 0, 0));
    }
    fence_async_shared();
  }
  __syncthreads();

  const int wg = wide::warpgroup();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const uint32_t base = (smem_addr(smem_f32w) + 1023u) & ~1023u;
    if (threadIdx.x >= 32)
      wide_split(base, threadIdx.x - 32, n, boxes);
    else if (threadIdx.x == 0)
      wide_load(&tq, &tk, &tv, base, n, boxes, head, head / (h / hkv), b,
                q0);
    return;
  }

  // Consumer c.  S's layout: a thread holds q rows row0 and row0 + 8, and
  // in each 8-key block the keys cq and cq + 1.  Oᵀ's (this consumer's 128
  // columns of O as two m64n64 products, Vᵀ times Pᵀ): in m-tile mt the
  // columns d = 128 c + 64 mt + row0 and + 8, and in each 8-row block of
  // q the rows cq and cq + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int c = wg - 1;
  const int wt = threadIdx.x % 128;
  const int row0 = (wt / 32) * 16 + (wt % 32) / 4;
  const int quad = wt % 4;
  const int cq = 2 * quad;
  const float sl = (softcap > 0.f ? 1.f : scale) * kLog2e;
  // the last key each of the thread's two q rows attends
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    last[i] = causal ? min(q0 + row0 + 8 * i, skv - 1) : skv - 1;

  // The lo of this consumer's columns of Q, in the A fragments of
  // Q_lo·K_hi (its k-step kk is the block's 16 c + kk).
  const uint32_t base0 = (smem_addr(smem_f32w) + 1023u) & ~1023u;
  mbar_wait(base0 + L::BAR, 0);
  uint32_t q_lo[16][4];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int g = 16 * c + kk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1);
      const int chunk = 2 * (g % 4) + (r >> 1);
      q_lo[kk][r] =
          lo_of_truncated(lds(base0 + L::Q + (g / 4) * L::QBOX + row * 128 +
                              ((chunk ^ (row % 8)) << 4) + 4 * quad));
    }
    hold4(q_lo[kk]);
  }

  float o[2][32];   // Oᵀ, unnormalised
#pragma unroll
  for (int i = 0; i < 32; ++i) o[0][i] = o[1][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  // Vᵀ of the tile before, split: A fragments [m-tile][8-key step]
  uint32_t v_hi[2][2][4], v_lo[2][2][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) (&v_hi[0][0][0])[i] = (&v_lo[0][0][0])[i] = 0u;
  float s[kWideBN / 2];
  float hh[16], lh[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) hh[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) lh[i] = 0.f;
  // this consumer's P hi and lo (tile t at the 64 bytes 64 (t % 2) of
  // each 128-byte q row) and its rows' factors
  const uint32_t p_hi_buf = base0 + L::P + 2 * c * L::PBUF;
  const uint32_t rows_buf = base0 + L::ROWS + c * kWideBM * 4;

  int prev = -1;   // the first round's P·V multiplies zeros
#pragma unroll 1
  for (int t = 0;; ++t) {
    const bool past = t >= n;
    const int tk = past ? n - 1 : t;
    const uint32_t tb = opaque(base0);
    const WideBars br{tb + L::BAR};
    mbar_wait(br.k_split(tk), WideBars::k_lap(tk));
    const uint32_t qc = tb + L::Q + 4 * c * L::QBOX;
    const uint32_t kc = tb + L::K + (tk % kWideKStages) * L::KSTAGE +
                        4 * c * L::KBOX;
    const uint32_t pp = opaque(p_hi_buf) + 64 * (prev & 1);

    // S over this consumer's half of the k-depth: Q_hi·[K_hi; K_lo] in
    // one m64n32 sum (keys in columns 0-15, their lo products in 16-31),
    // Q_lo·K_hi in an m64n16 one; the k-steps past dv add zeros.  Every
    // register a product reads is pinned before the fence.
    keep(o[0]);
    keep(o[1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        hold4(v_hi[mt][ks]);
        hold4(v_lo[mt][ks]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t kb = kc + (kk / 4) * L::KBOX + (kk % 4) * 32;
      wgmma_tf32_ss_n32(
          hh, sw128_desc(qc + (kk / 4) * L::QBOX + (kk % 4) * 32, 16, 1024),
          sw128_desc(kb, 16, 1024), kk > 0);
      wgmma_tf32_rs_n16(lh, q_lo[kk], sw128_desc(kb, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // Oᵀ += Vᵀ·Pᵀ of the tile before, the small products first: an 8-key
    // step moves 32 bytes along P's rows
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        wgmma_tf32_rs_n64(o[mt], v_hi[mt][ks],
                          sw128_desc(pp + L::PBUF + 32 * ks, 16, 1024));
        wgmma_tf32_rs_n64(o[mt], v_lo[mt][ks],
                          sw128_desc(pp + 32 * ks, 16, 1024));
      }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma_tf32_rs_n64(o[mt], v_hi[mt][ks],
                          sw128_desc(pp + 32 * ks, 16, 1024));
    wgmma_commit();
    wide::wgmma_wait1();
    keep(hh);
    keep(lh);
    if (past) warp_frees(br.k_free(tk));

    if (!past) {
      // S = this consumer's partial + the other's, traded through the
      // first box of each consumer's half of the K stage, which its own
      // product has done reading: partial j (keys 8 j .. 8 j + 7) of
      // thread wt at (j, wt), 16 bytes apart
      const uint32_t x = tb + L::K + (tk % kWideKStages) * L::KSTAGE;
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i)
        s[i] = hh[i] + (hh[i + 8] + lh[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sts4(x + 4 * c * L::KBOX + (j * 128 + wt) * 16,
             make_uint4(__float_as_uint(s[4 * j]),
                        __float_as_uint(s[4 * j + 1]),
                        __float_as_uint(s[4 * j + 2]),
                        __float_as_uint(s[4 * j + 3])));
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 y = lds4(x + 4 * (1 - c) * L::KBOX + (j * 128 + wt) * 16);
        s[4 * j] += y.x;
        s[4 * j + 1] += y.y;
        s[4 * j + 2] += y.z;
        s[4 * j + 3] += y.w;
      }
      // the stage free once both partials are read (the K of tile n - 1
      // is held for the last round); the writes ordered before TMA's
      if (t + 1 < n) {
        fence_async_shared();
        warp_frees(br.k_free(tk));
      }

      // Online softmax in registers: s[4j + e] is row row0 + 8 (e / 2),
      // key 16 t + 8 j + cq + e % 2; P in fp32 in place.
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < kWideBN / 2; ++i)
          s[i] = tanhf(s[i] * scale / softcap) * softcap;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i) {
        const int kpos = t * kWideBN + 8 * (i / 4) + cq + i % 2;
        s[i] = kpos > last[(i / 2) % 2] ? -INFINITY : s[i] * sl;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
      float mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
        alpha[i] = exp2_approx(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i) {
        s[i] = exp2_approx(s[i] - mu[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];
      }
      // P of tile t, split, into this consumer's buffer (Pᵀ's K-major
      // rows: q row, its 16 keys at bytes 64 (t % 2)), and the rows'
      // factors beside it
      const uint32_t pw = opaque(p_hi_buf);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = row0 + 8 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 8 * j + cq;
          const uint32_t a = pw + q * 128 +
                             (((4 * (t & 1) + k / 4) ^ (q % 8)) << 4) +
                             4 * (k % 4);
          uint32_t h0, l0, h1, l1;
          split(s[4 * j + 2 * i], h0, l0);
          split(s[4 * j + 2 * i + 1], h1, l1);
          st2(a, h0, h1);
          st2(a + L::PBUF, l0, l1);
        }
        if (quad == 0) wide::st_f32(rows_buf + 4 * q, alpha[i]);
      }
      fence_async_shared();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
    }
    wgmma_wait0();
    keep(o[0]);
    keep(o[1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        hold4(v_hi[mt][ks]);
        hold4(v_lo[mt][ks]);
      }
    if (past) break;
    // Oᵀ's columns q take their rows' factor; then Vᵀ of tile t into the
    // A fragments (register r: column d = row0 + 8 (r & 1), key quad + 4
    // (r >> 1) of the 8-key step), split, and its V stage free
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = ld2(opaque(rows_buf) + 4 * (8 * j + cq));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        o[mt][4 * j] *= f.x;
        o[mt][4 * j + 1] *= f.y;
        o[mt][4 * j + 2] *= f.x;
        o[mt][4 * j + 3] *= f.y;
      }
    }
    mbar_wait(br.v_landed(t), WideBars::v_lap(t));
    const uint32_t vr = tb + L::V + (t % kWideVStages) * L::RAW;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = 128 * c + 64 * mt + row0 + 8 * (r & 1);
          const int key = 8 * ks + quad + 4 * (r >> 1);
          split(lds(vr + (d / 32) * L::KROWS + key * 128 +
                    ((((d % 32) / 4) ^ (key % 8)) << 4) + 4 * (d % 4)),
                v_hi[mt][ks][r], v_lo[mt][ks][r]);
        }
    warp_frees(br.v_free(t));
    prev = t;
  }

  // Epilogue: l over the quad, into the rows' buffer; Oᵀ / l into this
  // consumer's half of the Q tile (which its products have done
  // reading) as O's rows of 128 columns; then the rows below Sq and the
  // columns below dv to out, 16 bytes a thread.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  if (quad == 0) {
    wide::st_f32(rows_buf + 4 * row0, 1.f / l[0]);
    wide::st_f32(rows_buf + 4 * (row0 + 8), 1.f / l[1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  const uint32_t stage = base0 + L::Q + 4 * c * L::QBOX;   // 64 rows of 512 B
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 f = ld2(rows_buf + 4 * (8 * j + cq));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * j + cq + e % 2;
        const int d = 64 * mt + row0 + 8 * (e / 2);
        wide::st_f32(stage + q * 512 + 4 * (d ^ (4 * (q % 8))),
               o[mt][4 * j + e] * (e % 2 ? f.y : f.x));
      }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
#pragma unroll 4
  for (int i = wt; i < kWideBM * 32; i += 128) {
    const int q = i / 32;
    const int d = 4 * (i % 32);
    if (q0 + q < sq && 128 * c + d < dv) {
      *reinterpret_cast<float4*>(
          out + (((size_t)b * sq + q0 + q) * h + head) * dv + 128 * c + d) =
          lds4(stage + q * 512 + 4 * (d ^ (4 * (q % 8))));
    }
  }
}

inline int launch_wide(const void* q, const void* k, const void* v, void* out,
                       int batch, int sq, int skv, int h, int hkv, int dv,
                       int causal, float scale, float softcap,
                       cudaStream_t stream) {
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, batch, sq, h, dv, kF32, 4, kBoxCols, kWideBM) ||
      !tensor_map(&tk, k, batch, skv, hkv, dv, kF32, 4, kBoxCols, kWideBN) ||
      !tensor_map(&tv, v, batch, skv, hkv, dv, kF32, 4, kBoxCols, kWideBN))
    return -2;
  constexpr int smem = WideSmem::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, batch, (sq + kWideBM - 1) / kWideBM);
  flash_fp32_kernel_wide<<<grid, kWideThreads, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), sq, skv, h, hkv, dv, causal,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// Calls f with std::integral_constant<int, D> for a head_dim the kernels
// take (a multiple of 16 from 16 to 128); -1 for any other.
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return -1;
  }
}

// The 2-byte kernel's tile width for a head_dim: 64 up to 64, 128 up to
// 128, else 256 (flash_kernel_wide).
constexpr int tile_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// A head_dim of the wide kernels: a multiple of 16 from 144 to 256.
constexpr bool wide_head_dim(int d) {
  return d > 128 && d <= wide::kD && d % 16 == 0;
}

}  // namespace

// Dynamic shared memory of one block for a dtype (0 = float32,
// 1 = bfloat16, 2 = float16) and head_dim, in bytes; -1 for a pair the
// kernels do not take.
extern "C" int flash_attention_smem_bytes(int dtype, int head_dim) {
  if (wide_head_dim(head_dim))
    return dtype == 0                 ? f32::WideSmem::BYTES
           : dtype == 1 || dtype == 2 ? wide::Smem::BYTES
                                      : -1;
  return with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return dtype == 0                 ? f32::Smem<D>::BYTES
           : dtype == 1 || dtype == 2 ? Smem<tile_width(D)>::BYTES
                                      : -1;
  });
}

// The grid (x, y, z) of one launch for a dtype, head_dim and shape, in
// grid[0..2]; 0, or -1 for a pair the kernels do not take.
extern "C" int flash_attention_grid(int dtype, int head_dim, int batch,
                                    int sq, int h, int* grid) {
  const bool is_wide = wide_head_dim(head_dim);
  if (dtype < 0 || dtype > 2 || (!is_wide && with_head_dim(head_dim, [](auto) {
                                   return 0;
                                 }) != 0))
    return -1;
  dim3 g;
  if (dtype != 0 && is_wide)
    g = wide::grid(batch, sq, h, wide::mirror_pairs(batch, sq, h));
  else
    g = dim3(h, batch,
             (sq + (dtype != 0 ? kBM : is_wide ? f32::kWideBM : f32::kBM) - 1) /
                 (dtype != 0 ? kBM : is_wide ? f32::kWideBM : f32::kBM));
  grid[0] = g.x;
  grid[1] = g.y;
  grid[2] = g.z;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns
// cudaGetLastError() after the launch, -1 for a configuration the kernels
// do not take, or -2 when a TMA map cannot be encoded.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int skv, int h, int hkv,
                                      int head_dim, int causal, float scale,
                                      float softcap, void* stream) {
  const bool is_wide = wide_head_dim(head_dim);
  const int tile_q = dtype != 0 ? kBM : is_wide ? f32::kWideBM : f32::kBM;
  if (dtype < 0 || dtype > 2 || batch <= 0 || hkv <= 0 || h % hkv != 0 ||
      sq <= 0 || skv <= 0 || batch > 65535 ||
      (sq + tile_q - 1) / tile_q > 65535 ||
      (is_wide && dtype != 0 && h > 65535))   // the wide grid's y or x
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_wide) {
    if (dtype == 0)
      return f32::launch_wide(q, k, v, out, batch, sq, skv, h, hkv, head_dim,
                              causal, scale, softcap, s);
    if (dtype == 1)
      return wide::launch<__nv_bfloat16>(q, k, v, out, batch, sq, skv, h, hkv,
                                         head_dim, causal, scale, softcap, s);
    return wide::launch<__half>(q, k, v, out, batch, sq, skv, h, hkv, head_dim,
                                causal, scale, softcap, s);
  }
  return with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return f32::launch<D>(q, k, v, out, batch, sq, skv, h, hkv, causal,
                            scale, softcap, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, tile_width(D), D>(
          q, k, v, out, batch, sq, skv, h, hkv, causal, scale, softcap, s);
    return launch<__half, tile_width(D), D>(q, k, v, out, batch, sq, skv, h,
                                            hkv, causal, scale, softcap, s);
  });
}
