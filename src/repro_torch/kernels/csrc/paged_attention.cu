// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:79,
//   paged_attention_fwd / _paged_attn_kernel (the Pallas TPU kernel),
//   reached through ops.paged_attention.
//
// What it computes: one decode token per sequence attends over that
// sequence's KV, which lies in fixed-size pages named by a block table.
// For sequence b and kv head h, the q heads h*G .. h*G+G-1 (G = Hq/Hkv)
// attend together to positions [0, lens[b]) (lens clamped to
// max_pages*page); scores are scaled by D^-1/2, optionally soft-capped
// (tanh(s/c)*c), and softmaxed in fp32 with an online (running max /
// running sum) update.  A row of length <= 0 gives zeros.
//
// Layout: q (B,Hq,D); k/v pages (NP,P,Hkv,D) token-major, read in place
// (a row of one kv head is D contiguous elements, rows Hkv*D apart);
// tables (B,MP) int32; lens (B,) int32; out (B,Hq,D).  bf16 or fp32,
// D in {64,80,128}, G in {1,2,3,4,5,7,8} (3: granite-moe-3b's 24/8, 5:
// qwen3-14b's 40/8, 7: qwen2-0.5b's 14/2), any page size.  Scratch from the
// wrapper: ws, fp32, one record of G*(D+2) floats per (sequence, kv
// head, split); tickets, B*Hkv zeroed counters that the kernel leaves
// zeroed.
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
// - Grid (splits, Hkv, B), splits = ceil(max_pages*page / SPLIT), from
//   the shapes alone, so the host reads no device value and the launch
//   can be captured in a CUDA graph.  SPLIT is 64 positions at D 128 and
//   128 at D 64 (32 KB of bf16 K and V), so a long sequence spreads over
//   many SMs; a block whose split starts at or past len returns at once.
// - 128 threads.  A thread owns 8 elements of a row, D/8 threads cover a
//   row, and the block's 1024/D row groups each take 2 rows of every
//   step of 1024/D*2 positions.  At D 80 a row takes 16 lanes, the power
//   of two above its 10, so the shuffles stay inside a row: lanes 10-15
//   copy nothing (a zero-size cp.async fills their slots with zeros) and
//   add zeros, and 8 row groups take a step of 16 positions, as at
//   D 128.
// - The ring: every thread copies, with 16-byte cp.async, exactly the K
//   and V pieces it will read, STAGES steps ahead, into its own slots of
//   a 32 KB ring in shared memory (4 steps in bf16, the whole split; 2
//   in fp32).  So K and V of later steps are in flight while a step
//   computes, V no longer waits for the softmax, and steps need no
//   barrier: a thread waits on its own commit groups only.  Rows at or
//   past len are zero-filled without a read.  The split's block-table
//   entries are read into shared memory once.  An SM holds up to 6
//   blocks (shared memory), up to 192 KB in flight.  A thread keeps G
//   rows of q and of the accumulator in registers, so registers grow
//   with G (ptxas, bf16 D 128: 74 at G 1, 128 at G 5, 168 at G 7, no
//   spills), and from G 5 on they, not shared memory, cap the blocks an
//   SM holds (4 at G 5, 3 at G 7).
// - Scores: 8 products per thread, summed over a row's lanes (4 xor
//   shuffles at D 128 and D 80, 3 at D 64).  Each row group keeps its own online
//   softmax (log2 domain) in registers, rescaled at most once a step
//   and only when its max grows.
// - Merge: the groups' states merge through shared memory at the end of
//   the block; a sequence of one split writes its output there.
//   Otherwise the block writes its (m, l, acc) record to ws, and the
//   last block of its (sequence, kv head) to arrive, found by an
//   atomicInc ticket that wraps to 0 on the last arrival (so the
//   counters are zero again for the next call), merges the records in
//   split order and writes the output.  Chosen over a second merge
//   kernel: one launch a call, no gap between two launches, and the
//   merge overlaps other blocks' loads; the fixed order keeps the
//   result independent of which block comes last.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;             // elements of a row one thread owns
constexpr int kRows = 2;            // rows a group takes from each step
constexpr int kStepsPerSplit = 4;
constexpr int kRingBytesPerThread = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Shape {
  static constexpr int LIVE = D / kVec;              // lanes holding a row
  static constexpr int LANES =                       // threads per row
      LIVE <= 8 ? 8 : LIVE <= 16 ? 16 : 32;
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

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ ws, unsigned* __restrict__ tickets,
                  int hkv, int page, int max_pages, float scale,
                  float softcap) {
  using S = Shape<T, D>;
  constexpr int REC = G * (D + 2);          // o[G][D], m[G], l[G]
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(lens[b], max_pages * page);
  const int n_splits = len > S::SPLIT ? (len + S::SPLIT - 1) / S::SPLIT : 1;
  if (split >= n_splits) return;
  const int s0 = split * S::SPLIT;
  const int s1 = min(len, s0 + S::SPLIT);   // this block: [s0, s1)
  const int tid = threadIdx.x;
  const int lane = tid % S::LANES;          // which kVec elements of a row
  const int grp = tid / S::LANES;
  const bool live_lane = lane < S::LIVE;    // false: lanes past a row's end
  const int hq = hkv * G;

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
                    q + ((size_t)b * hq + kvh * G + g) * D + lane * kVec),
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
               kvh) * D + lane * kVec;
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
      : ws + (((size_t)b * hkv + kvh) * gridDim.x + split) * REC;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
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
      store(out + ((size_t)b * hq + kvh * G + g) * D + d,
            sum_l > 0.f ? sum_o / sum_l : 0.f);
    } else {
      rec[idx] = sum_o;
      if (d == 0) {
        rec[G * D + g] = mx;
        rec[G * D + G + g] = sum_l;
      }
    }
  }
  if (n_splits == 1) return;

  // The last block of this (sequence, kv head) merges every split.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(tickets + (size_t)b * hkv + kvh, n_splits - 1) ==
           static_cast<unsigned>(n_splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // A thread takes the outputs tid + k*kThreads; the loads of several
  // splits are in flight together.
  constexpr int OUTS = (G * D + kThreads - 1) / kThreads;
  const float* recs = ws + ((size_t)b * hkv + kvh) * gridDim.x * REC;
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
      const int idx = min(tid + k * kThreads, G * D - 1);
      mx[k] = fmaxf(mx[k], __ldcg(recs + sp * REC + G * D + idx / D));
    }
#pragma unroll 4
  for (int sp = 0; sp < n_splits; ++sp) {
    const float* r = recs + sp * REC;
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      const int idx = min(tid + k * kThreads, G * D - 1);
      const float ms = __ldcg(r + G * D + idx / D);
      const float f = exp2f(ms - mx[k]);
      sum_l[k] += __ldcg(r + G * D + G + idx / D) * f;
      sum_o[k] += __ldcg(r + idx) * f;
    }
  }
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < G * D)
      store(out + ((size_t)b * hq + kvh * G) * D + idx, sum_o[k] / sum_l[k]);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lens, void* out, void* ws, void* tickets, int batch,
           int hkv, int page, int max_pages, int splits, float scale,
           float softcap, cudaStream_t stream) {
  paged_attn_kernel<T, D, G><<<dim3(splits, hkv, batch), kThreads, 0,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(tickets), hkv, page,
      max_pages, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const void* tables, const void* lens, void* out, void* ws,
                 void* tickets, int batch, int hkv, int page, int max_pages,
                 float scale, float softcap, cudaStream_t stream) {
  const int splits =
      (max_pages * page + Shape<T, D>::SPLIT - 1) / Shape<T, D>::SPLIT;
  switch (group) {
    case 1: return launch<T, D, 1>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 2: return launch<T, D, 2>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 3: return launch<T, D, 3>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 4: return launch<T, D, 4>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 5: return launch<T, D, 5>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 7: return launch<T, D, 7>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    case 8: return launch<T, D, 8>(q, k, v, tables, lens, out, ws, tickets,
                                   batch, hkv, page, max_pages, splits,
                                   scale, softcap, stream);
    default: return -1;
  }
}

}  // namespace

// Positions per split for a dtype (0 = float32, 1 = bfloat16) and head
// dim, or -1 for one the kernel does not take.  The grid's x is
// ceil(max_pages * page / split_len); ws holds B*Hkv*x*G*(D+2) floats.
extern "C" int paged_attention_split_len(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 64) return Shape<float, 64>::SPLIT;
  if (dtype == 0 && head_dim == 80) return Shape<float, 80>::SPLIT;
  if (dtype == 0 && head_dim == 128) return Shape<float, 128>::SPLIT;
  if (dtype == 1 && head_dim == 64) return Shape<__nv_bfloat16, 64>::SPLIT;
  if (dtype == 1 && head_dim == 80) return Shape<__nv_bfloat16, 80>::SPLIT;
  if (dtype == 1 && head_dim == 128) return Shape<__nv_bfloat16, 128>::SPLIT;
  return -1;
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
  if (hkv <= 0 || hq % hkv != 0 || page <= 0 || max_pages <= 0) return -1;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_group<float, 64>(group, q, k, v, tables, lens, out, ws,
                                   tickets, batch, hkv, page, max_pages,
                                   scale, softcap, s);
  if (dtype == 0 && head_dim == 80)
    return launch_group<float, 80>(group, q, k, v, tables, lens, out, ws,
                                   tickets, batch, hkv, page, max_pages,
                                   scale, softcap, s);
  if (dtype == 0 && head_dim == 128)
    return launch_group<float, 128>(group, q, k, v, tables, lens, out, ws,
                                    tickets, batch, hkv, page, max_pages,
                                    scale, softcap, s);
  if (dtype == 1 && head_dim == 64)
    return launch_group<__nv_bfloat16, 64>(group, q, k, v, tables, lens,
                                           out, ws, tickets, batch, hkv, page,
                                           max_pages, scale, softcap, s);
  if (dtype == 1 && head_dim == 80)
    return launch_group<__nv_bfloat16, 80>(group, q, k, v, tables, lens,
                                           out, ws, tickets, batch, hkv, page,
                                           max_pages, scale, softcap, s);
  if (dtype == 1 && head_dim == 128)
    return launch_group<__nv_bfloat16, 128>(group, q, k, v, tables, lens,
                                            out, ws, tickets, batch, hkv,
                                            page, max_pages, scale, softcap,
                                            s);
  return -1;
}
