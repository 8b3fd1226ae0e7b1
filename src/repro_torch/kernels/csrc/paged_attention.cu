// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:79,
//   paged_attention_fwd / _paged_attn_kernel (the Pallas TPU kernel),
//   reached through ops.paged_attention.
//
// What it computes: one decode token per sequence attends over that
// sequence's KV, which lies in fixed-size pages named by a block table.
// For sequence b and kv head h, the q heads h*G .. h*G+G-1 (G = Hq/Hkv)
// attend to positions [0, lens[b]) (lens clamped to max_pages*page);
// scores are scaled by D^-1/2, optionally soft-capped (tanh(s/c)*c), and
// softmaxed in fp32 with an online (running max / running sum) update.
// A row of length <= 0 gives zeros.
//
// Layout: q (B,Hq,D); k/v pages (NP,P,Hkv,D) token-major, read in place
// (a row of one kv head is D contiguous elements, rows Hkv*D apart);
// tables (B,MP) int32; lens (B,) int32; out (B,Hq,D).  fp32, bf16 or
// fp16, D any multiple of 16 from 16 to 256, any G, any page size; bf16
// and fp16, both 2 bytes, share every shape below, each widened to fp32
// exactly as it is read and only the output rounded to its type.  A
// block takes C q heads of one kv head together, C the largest divisor
// of G up to 8 (C = G up to 8; 8 for multi-query groups such as 16/1 and
// 32/1, whose G/C chunks each read their kv head's pages), so the
// grid's y runs over the Hq/C chunks.  Scratch from the wrapper: ws,
// fp32, one record of C*(D+2) floats per (sequence, chunk, split);
// tickets, B*Hq/C zeroed counters that the kernel leaves zeroed.
//
// What bounds it on this card: device-memory bytes.  Each K/V element
// is read once and used for G multiply-adds (about 1 flop per byte at
// G 1, against the ~295 the H100 needs before its arithmetic units
// become the limit), so the floor is Σ_b ceil(len_b/P)·P·Hkv·D·2·bytes
// over 3.35 TB/s.  Reaching it takes enough bytes in flight: about
// 3.35 TB/s × 0.8 µs of memory latency ≈ 2.7 MB on the card, ≈ 20 KB
// per SM, spread over every SM whatever the lengths.
//
// The design (split-KV over the sequence):
// - Grid (splits, Hq/C, B), splits = ceil(max_pages*page / SPLIT), from
//   the shapes alone, so the host reads no device value and the launch
//   can be captured in a CUDA graph.  SPLIT is 4 steps of 2 rows a row
//   group: 64 positions at D 80 to 128, 128 at D 48 and 64, 256 at D 32
//   and 512 at D 16 (32 KB of bf16 K and V at D 16, 32, 64 and 128), so
//   a long sequence spreads over many SMs; a block whose split starts at
//   or past len returns at once.  D 144 to 256 take 32 positions a split
//   (32 KB of bf16 K and V at D 256).
// - 128 threads.  A thread owns 8 elements of a row, and a row takes
//   the power of two of lanes at or above its D/8 (2 at D 16, 4 at D 32,
//   8 at D 48 and 64, 16 at D 80 to 128, a whole warp of 32 at D 144 to
//   256), so the shuffles stay inside a row; the block's 128/lanes row
//   groups each take 2 rows of every step.  Lanes past a row's end (at
//   D 48, 80, 96 and 112, and 144 to 240) copy nothing (a zero-size
//   cp.async fills their slots with zeros) and add zeros.
// - D 144 to 256 share one kernel a (dtype, q heads a block, chunked):
//   the 32-lane shape of D 256 (the template's D, which sizes shared
//   memory), the head_dim a runtime value (`head_dim`) for the live
//   lanes, the strides in device memory and the merge's loops.  Up to
//   D 128 every head_dim is its own instance, as before, where the same
//   expressions fold to constants: 48 kernels for the eight wide
//   head_dims, not 384.
// - The ring: every thread copies, with 16-byte cp.async, exactly the K
//   and V pieces it will read, STAGES steps ahead, into its own slots of
//   a 32 KB ring in shared memory (4 steps in bf16 and fp16, the whole
//   split; 2 in fp32).  So K and V of later steps are in flight while a
//   step computes, V no longer waits for the softmax, and steps need no
//   barrier: a thread waits on its own commit groups only.  Rows at or
//   past len are zero-filled without a read.  The split's block-table
//   entries are read into shared memory once.  An SM holds up to 6
//   blocks (shared memory), up to 192 KB in flight.  A thread keeps G
//   rows of q and of the accumulator in registers, so registers grow
//   with G (ptxas, bf16 D 128: 74 at G 1, 128 at G 5, 168 at G 7, 178
//   at G 8; the D-256 shape 67 at G 1, 139 at G 5, 255 and 16 bytes of
//   spills at G 8), and from G 5 on they, not shared memory, cap the
//   blocks an SM holds (4 at G 5, 3 at G 7).
// - Scores: 8 products per thread, summed over a row's lanes (log2 of
//   its lanes xor shuffles).  Each row group keeps its own online
//   softmax (log2 domain) in registers, rescaled at most once a step
//   and only when its max grows.
// - Merge: the groups' states merge through shared memory at the end of
//   the block (at D 16 the 64 groups' accumulators fill the whole
//   ring); a sequence of one split writes its output there.
//   Otherwise the block writes its (m, l, acc) record to ws, and the
//   last block of its (sequence, chunk) to arrive, found by an
//   atomicInc ticket that wraps to 0 on the last arrival (so the
//   counters are zero again for the next call), merges the records in
//   split order and writes the output.  Chosen over a second merge
//   kernel: one launch a call, no gap between two launches, and the
//   merge overlaps other blocks' loads; the fixed order keeps the
//   result independent of which block comes last.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged_attention_cu {

constexpr int kThreads = 128;
constexpr int kVec = 8;             // elements of a row one thread owns
constexpr int kRows = 2;            // rows a group takes from each step
constexpr int kStepsPerSplit = 4;
constexpr int kRingBytesPerThread = 256;
constexpr int kWideD = 256;         // the one shape of head_dims 144 to 256
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Shape {
  static constexpr int LIVE = D / kVec;              // lanes holding a row
  static constexpr int LANES =                       // threads per row
      LIVE <= 2 ? 2 : LIVE <= 4 ? 4 : LIVE <= 8 ? 8 : LIVE <= 16 ? 16 : 32;
  static constexpr int GROUPS = kThreads / LANES;    // row groups
  static constexpr int STEP = GROUPS * kRows;        // positions a step
  static constexpr int SPLIT = STEP * kStepsPerSplit;
  static constexpr int COPIES = kVec * sizeof(T) / 16;   // per row, thread
  static constexpr int STAGES =
      kRingBytesPerThread / (16 * 2 * kRows * COPIES);
  static constexpr int RING = STAGES * 2 * kRows * COPIES * kThreads;
  static_assert(STAGES >= 2, "the ring needs two steps");
  static_assert(D % kVec == 0 && LIVE <= LANES && LANES <= 32,
                "a row's lanes: a power of two, at most one warp");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kVec elements as fp32, from 16-byte pieces `stride` uint4 apart.
template <typename T>
__device__ __forceinline__ void unpack(const uint4* p, int stride,
                                       float (&x)[kVec]);

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4* p, int,
                                                      float (&x)[kVec]) {
  // bf16 -> fp32 is a shift: element 2i is the low half of word i
  const uint4 u = p[0];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<__half>(const uint4* p, int,
                                               float (&x)[kVec]) {
  const uint4 u = p[0];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void unpack<float>(const uint4* p, int stride,
                                              float (&x)[kVec]) {
  const uint4 a = p[0];
  const uint4 b = p[stride];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = __uint_as_float(w[i]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

// The C interface's code of an element type: 0 = float32, 1 = bfloat16,
// 2 = float16.
template <typename T>
constexpr int kDtype = std::is_same<T, float>::value           ? 0
                       : std::is_same<T, __nv_bfloat16>::value ? 1
                                                               : 2;
static_assert(kDtype<__half> == 2, "fp16 is code 2");

template <typename T, int D, int G, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ ws, unsigned* __restrict__ tickets,
                  int hkv, int page, int max_pages, float scale, float softcap,
                  int chunks, int head_dim) {
  // G: the q heads of this block.  CHUNKED (groups above 8): block y
  // takes the chunk y of G heads, `chunks` of them a kv head; otherwise
  // y is the kv head and the code is the one kernel of groups up to 8
  // (a division and a grid-size read here made those 0.3-0.7% slower).
  // dh: the head_dim, D itself up to 128 (so every expression of it
  // below is a constant there), `head_dim` in the D-256 shape.
  using S = Shape<T, D>;
  const int dh = D == kWideD ? head_dim : D;
  const int REC = G * (dh + 2);             // o[G][dh], m[G], l[G]
  const int split = blockIdx.x;
  const int y = blockIdx.y;
  const int kvh = CHUNKED ? y / chunks : y;
  const int b = blockIdx.z;
  const int len = min(lens[b], max_pages * page);
  const int n_splits = len > S::SPLIT ? (len + S::SPLIT - 1) / S::SPLIT : 1;
  if (split >= n_splits) return;
  const int s0 = split * S::SPLIT;
  const int s1 = min(len, s0 + S::SPLIT);   // this block: [s0, s1)
  const int tid = threadIdx.x;
  const int lane = tid % S::LANES;          // which kVec elements of a row
  const int grp = tid / S::LANES;
  // false: lanes past a row's end
  const bool live_lane = D == kWideD ? lane * kVec < dh : lane < S::LIVE;
  const int ny = CHUNKED ? gridDim.y : hkv;  // blocks along y: Hq / G
  const int hq = ny * G;

  __shared__ __align__(16) uint4 ring[S::RING];
  __shared__ int pages[S::SPLIT + 1];
  __shared__ float grp_m[S::GROUPS][G];
  __shared__ float grp_l[S::GROUPS][G];
  __shared__ int last;
  static_assert(S::GROUPS * G * D * sizeof(float) <= sizeof(ring),
                "the groups' accumulators reuse the ring");

  const int p0 = s0 / page;
  const int n_pages = s1 > s0 ? (s1 - 1) / page - p0 + 1 : 0;
  for (int i = tid; i < n_pages; i += kThreads)
    pages[i] = tables[(size_t)b * max_pages + p0 + i];

  float qr[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (live_lane) {
      unpack<T>(reinterpret_cast<const uint4*>(
                    q + ((size_t)b * hq + y * G + g) * dh + lane * kVec),
                1, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
    }
  }
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();

  // this thread's 16-byte slot for (ring stage, K or V, row, copy)
  auto slot = [&](int stage, int kv, int r, int c) {
    return ring + (((stage * 2 + kv) * kRows + r) * S::COPIES + c) *
                      kThreads + tid;
  };
  auto issue = [&](int st) {
    const int stage = st % S::STAGES;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = s0 + st * S::STEP + grp * kRows + r;
      const bool live = pos < s1 && live_lane;
      size_t off = 0;
      if (live)
        off = (((size_t)pages[pos / page - p0] * page + pos % page) * hkv +
               kvh) * dh + lane * kVec;
#pragma unroll
      for (int c = 0; c < S::COPIES; ++c) {
        const size_t e = off + c * (16 / sizeof(T));
        cp_async16(slot(stage, 0, r, c), k_pages + e, live);
        cp_async16(slot(stage, 1, r, c), v_pages + e, live);
      }
    }
  };

  const int n_steps = s1 > s0 ? (s1 - s0 + S::STEP - 1) / S::STEP : 0;
#pragma unroll
  for (int st = 0; st < S::STAGES; ++st) {
    if (st < n_steps) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<S::STAGES - 1>();          // step st has landed
    const int stage = st % S::STAGES;
    const int pos0 = s0 + st * S::STEP + grp * kRows;
    float s[kRows][G];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kr[kVec];
      unpack<T>(slot(stage, 0, r, 0), kThreads, kr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) part += qr[g][i] * kr[i];
        s[r][g] = part;
      }
    }
#pragma unroll
    for (int o = S::LANES / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], o);
    float p[kRows][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = s[r][g] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[r][g] = pos0 + r < s1 ? x * kLog2e : kNegInf;
        mx = fmaxf(mx, s[r][g]);
      }
      if (mx > m[g]) {
        const float alpha = exp2f(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] *= alpha;
        m[g] = mx;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r][g] = pos0 + r < s1 ? exp2f(s[r][g] - m[g]) : 0.f;
        l[g] += p[r][g];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float vr[kVec];
      unpack<T>(slot(stage, 1, r, 0), kThreads, vr);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] += p[r][g] * vr[i];
    }
    if (st + S::STAGES < n_steps) issue(st + S::STAGES);
    cp_async_commit();
  }

  // Merge the row groups' states; their accumulators reuse the ring.
  __syncthreads();
  float* grp_acc = reinterpret_cast<float*>(ring);     // [GROUPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      grp_m[grp][g] = m[g];
      grp_l[grp][g] = l[g];
    }
    if (live_lane) {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        grp_acc[(grp * G + g) * D + lane * kVec + i] = acc[g][i];
    }
  }
  __syncthreads();
  float* rec = n_splits == 1 ? nullptr
      : ws + (((size_t)b * ny + y) * gridDim.x + split) * REC;
  for (int idx = tid; idx < G * dh; idx += kThreads) {
    const int g = idx / dh;
    const int d = idx % dh;
    float mx = kNegInf;
#pragma unroll
    for (int h = 0; h < S::GROUPS; ++h) mx = fmaxf(mx, grp_m[h][g]);
    float sum_l = 0.f, sum_o = 0.f;
#pragma unroll
    for (int h = 0; h < S::GROUPS; ++h) {
      const float f = exp2f(grp_m[h][g] - mx);
      sum_l += grp_l[h][g] * f;
      sum_o += grp_acc[(h * G + g) * D + d] * f;
    }
    if (n_splits == 1) {
      store(out + ((size_t)b * hq + y * G + g) * dh + d,
            sum_l > 0.f ? sum_o / sum_l : 0.f);
    } else {
      rec[idx] = sum_o;
      if (d == 0) {
        rec[G * dh + g] = mx;
        rec[G * dh + G + g] = sum_l;
      }
    }
  }
  if (n_splits == 1) return;

  // The last block of this (sequence, chunk) merges every split.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(tickets + (size_t)b * ny + y, n_splits - 1) ==
           static_cast<unsigned>(n_splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // A thread takes the outputs tid + k*kThreads; the loads of several
  // splits are in flight together.  (OUTS from D: at the D-256 shape the
  // outputs past G * dh are clamped, then not stored.)
  constexpr int OUTS = (G * D + kThreads - 1) / kThreads;
  const float* recs = ws + ((size_t)b * ny + y) * gridDim.x * REC;
  float mx[OUTS], sum_l[OUTS], sum_o[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    mx[k] = kNegInf;
    sum_l[k] = sum_o[k] = 0.f;
  }
#pragma unroll 4
  for (int sp = 0; sp < n_splits; ++sp)
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      const int idx = min(tid + k * kThreads, G * dh - 1);
      mx[k] = fmaxf(mx[k], __ldcg(recs + sp * REC + G * dh + idx / dh));
    }
#pragma unroll 4
  for (int sp = 0; sp < n_splits; ++sp) {
    const float* r = recs + sp * REC;
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      const int idx = min(tid + k * kThreads, G * dh - 1);
      const float ms = __ldcg(r + G * dh + idx / dh);
      const float f = exp2f(ms - mx[k]);
      sum_l[k] += __ldcg(r + G * dh + G + idx / dh) * f;
      sum_o[k] += __ldcg(r + idx) * f;
    }
  }
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < G * dh)
      store(out + ((size_t)b * hq + y * G) * dh + idx, sum_o[k] / sum_l[k]);
  }
}

// A launch's arguments, from the C interface.
struct Args {
  const void *q, *k, *v, *tables, *lens;
  void *out, *ws, *tickets;
  int batch, hq, hkv, page, max_pages, head_dim;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T, int D, int G>
int launch(const Args& a) {
  const int splits =
      (a.max_pages * a.page + Shape<T, D>::SPLIT - 1) / Shape<T, D>::SPLIT;
  const bool chunked = a.hq / a.hkv != G;
  auto kernel = chunked ? paged_attn_kernel<T, D, G, true>
                        : paged_attn_kernel<T, D, G, false>;
  kernel<<<dim3(splits, a.hq / G, a.batch), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lens), static_cast<T*>(a.out),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.hkv,
      a.page, a.max_pages, a.scale, a.softcap, a.hq / a.hkv / G, a.head_dim);
  return static_cast<int>(cudaGetLastError());
}

// The q heads a block takes: the largest divisor of the group up to 8.
inline int heads_per_block(int group) {
  for (int c = 8; c > 1; --c)
    if (group % c == 0) return c;
  return 1;
}

// Calls f with std::integral_constant<int, D> for a head_dim the kernel
// takes: D = d for a multiple of 16 from 16 to 128, D = kWideD for one
// from 144 to 256 (the head_dim then a runtime value); -1 for any other.
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
    case 144: case 160: case 176: case 192: case 208: case 224: case 240:
    case 256: return f(std::integral_constant<int, kWideD>{});
    default: return -1;
  }
}

// Calls f with std::integral_constant<int, C> for C = 1 .. 8.
template <typename F>
int with_heads(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return -1;
  }
}

// Calls f with a value-initialised T of a dtype (kDtype<T>); -1 for any
// other.
template <typename F>
int with_dtype(int dtype, F&& f) {
  if (dtype == kDtype<float>) return f(float{});
  if (dtype == kDtype<__nv_bfloat16>) return f(__nv_bfloat16{});
  if (dtype == kDtype<__half>) return f(__half{});
  return -1;
}

// The 432 kernels (3 dtypes x 9 shapes: head_dims 16 to 128 and the
// D-256 one of 144 to 256, x 1-8 q heads a block x chunked or not) take
// minutes to build in one object, so kernels/build.py reads kParts below
// and builds that many objects of this source in parallel, object P
// (-DREPRO_PART=P) holding the (dtype, shape) pairs with part_of(...) ==
// P, and links them; built without REPRO_PART, one object holds them
// all.  Seven parts of at most four pairs each, as the six parts of four
// took before the D-256 shape (four parts of six pairs each took 75-79 s
// on an 8-core host and set the build's wall; PERF.md).
constexpr int kParts = 7;

// The pairs in order: (dtype, head_dim / 16 - 1) up to 128, then the
// D-256 shape of each dtype.
constexpr int part_of(int dtype, int head_dim) {
  return (head_dim <= 128 ? dtype * 8 + head_dim / 16 - 1 : 24 + dtype) %
         kParts;
}

// Launches the kernel of (dtype, head_dim, c q heads a block), which
// part P holds; other pairs are not instantiated here.
template <int P>
int launch_in_part(int dtype, int head_dim, int c, const Args& a) {
  return with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return with_head_dim(head_dim, [&](auto d) {
      constexpr int D = decltype(d)::value;
      if constexpr (part_of(kDtype<T>, D) != P)
        return -1;
      else
        return with_heads(c, [&](auto g) {
          return launch<T, D, decltype(g)::value>(a);
        });
    });
  });
}

// Defined in the object of part P.
template <int P>
int launch_part(int dtype, int head_dim, int c, const Args& a);
template <> int launch_part<0>(int, int, int, const Args&);
template <> int launch_part<1>(int, int, int, const Args&);
template <> int launch_part<2>(int, int, int, const Args&);
template <> int launch_part<3>(int, int, int, const Args&);
template <> int launch_part<4>(int, int, int, const Args&);
template <> int launch_part<5>(int, int, int, const Args&);
template <> int launch_part<6>(int, int, int, const Args&);
static_assert(kParts == 7, "one launch_part specialisation a part");

#if !defined(REPRO_PART) || REPRO_PART == 0
template <>
int launch_part<0>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<0>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 1
template <>
int launch_part<1>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<1>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 2
template <>
int launch_part<2>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<2>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 3
template <>
int launch_part<3>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<3>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 4
template <>
int launch_part<4>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<4>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 5
template <>
int launch_part<5>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<5>(dtype, head_dim, c, a);
}
#endif
#if !defined(REPRO_PART) || REPRO_PART == 6
template <>
int launch_part<6>(int dtype, int head_dim, int c, const Args& a) {
  return launch_in_part<6>(dtype, head_dim, c, a);
}
#endif

}  // namespace paged_attention_cu

#if !defined(REPRO_PART) || REPRO_PART == 0
using namespace paged_attention_cu;

// Positions per split for a dtype (0 = float32, 1 = bfloat16,
// 2 = float16) and head dim, or -1 for one the kernel does not take.  The
// grid's x is ceil(max_pages * page / split_len).
extern "C" int paged_attention_split_len(int dtype, int head_dim) {
  return with_dtype(dtype, [&](auto t) {
    return with_head_dim(head_dim, [&](auto d) {
      return Shape<decltype(t), decltype(d)::value>::SPLIT;
    });
  });
}

// The q heads a block takes for hq q heads over hkv kv heads (the grid's
// y is hq over it; ws holds B*Hq*x*(D+2) floats, tickets B*y counters),
// or -1 when hkv does not divide hq.
extern "C" int paged_attention_heads_per_block(int hq, int hkv) {
  if (hkv <= 0 || hq <= 0 || hq % hkv != 0) return -1;
  return heads_per_block(hq / hkv);
}

// Returns cudaGetLastError() after the launch, or -1 for a configuration
// the kernel does not take.
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lens, void* out, void* ws,
                                      void* tickets, int batch, int hq,
                                      int hkv, int head_dim, int page,
                                      int max_pages, float scale,
                                      float softcap, void* stream) {
  const int c = paged_attention_heads_per_block(hq, hkv);
  if (c <= 0 || page <= 0 || max_pages <= 0 || batch <= 0 ||
      batch > 65535 || hq / c > 65535 || dtype < 0 || dtype > 2 ||
      head_dim < 16 || head_dim > 256 || head_dim % 16 != 0)
    return -1;
  const Args a{q, k, v, tables, lens, out, ws, tickets, batch, hq, hkv,
               page, max_pages, head_dim, scale, softcap,
               static_cast<cudaStream_t>(stream)};
  switch (part_of(dtype, head_dim)) {
    case 0: return launch_part<0>(dtype, head_dim, c, a);
    case 1: return launch_part<1>(dtype, head_dim, c, a);
    case 2: return launch_part<2>(dtype, head_dim, c, a);
    case 3: return launch_part<3>(dtype, head_dim, c, a);
    case 4: return launch_part<4>(dtype, head_dim, c, a);
    case 5: return launch_part<5>(dtype, head_dim, c, a);
    case 6: return launch_part<6>(dtype, head_dim, c, a);
    default: return -1;
  }
}
#endif
