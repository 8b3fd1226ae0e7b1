// Chunked Mamba2 SSD scan for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_fwd /
//   _ssd_kernel (the Pallas TPU kernel), reached through ops.ssd_scan.
//
// What it computes, per (batch b, head h), with g = h / (H/G):
//   for each chunk c of L positions, with seg the inclusive cumsum of
//   dA_log over the chunk, total its last entry and S_in[c] the state
//   before the chunk,
//     y_i        = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) x_j
//                  + exp(seg_i) C_i . S_in[c]
//     S_in[c+1]  = S_in[c] exp(total) + sum_j exp(total - seg_j) B_j (x) x_j
//   and the final state after the last chunk.  S_in[0] is `state0`
//   (B,H,N,P), or zeros when it is null.
//
// Layout: x (B,S,H,P) fp32 and dA_log (B,S,H) fp32, contiguous; B/C
// (B,S,G,N) fp32 or bf16 read through their strides (sb, ss, sg in
// elements, unit stride along N), so column slices of a wider tensor are
// read in place; y (B,S,H,P) fp32; final state (B,H,N,P) fp32.  N <= 128,
// P <= 64, L <= 1024.  A ragged last chunk is masked here: positions past
// S are identity steps (x = 0, dA_log = 0, B = C = 0), so its total is
// that of its valid rows.
//
// What bounds it on this card: fp32 operations.  The least work is the
// lower triangle of each chunk's L x L products, C.B^T once per group,
// 2 L N P per (chunk, head) for the chunk's state and 2 L N P per (chunk,
// head) for the state's share of y where that state can be non-zero
// (mamba2-130m at S 1024: 1.14 GFLOP against 14 MB of inputs and
// outputs), far above the ~20 flop/byte where the card's fp32 rate
// (67 TFLOP/s outside the tensor cores) and not its memory becomes the
// limit.  The products run as fp32 FMAs, not TF32: the checks hold the
// kernel to its plain version at 1e-4, which TF32's 10-bit mantissa would
// not meet.
//
// What the design does about it: only the (N,P) recurrence across chunks
// is sequential, so the scan is three kernels on one stream, ordered by
// the stream alone (no block waits on another), and every chunk of every
// head runs in parallel:
//   1. chunk state, grid (nc*ceil(N/64)*H + nc*T(T+1)/2*G, B) with
//      T = ceil(L/64): a block per (chunk, 64 rows of N, head) forms seg
//      (writes it to scratch) and the chunk's own state
//      sum_j exp(total - seg_j) B_j (x) x_j; a block per (chunk, 64x64
//      tile on or below the diagonal, group) forms C_i . B_j once for all
//      the heads of the group.
//   2. state passing, grid (ceil(N*P/256), H, B): a thread per state
//      element walks the chunks, writes every S_in[c] and the final
//      state.  Memory-bound and small.
//   3. chunk scan, grid (T*nc*H, B), the longest rows first: a block per
//      (64 rows of a chunk, chunk, head) sums exp(seg_i) C_i . S_in[c] and
//      the decayed C_i . B_j times x_j over the tiles of j up to its
//      diagonal.
// Every product is a sum of 64x64 fp32 tiles: 256 threads, a 4x4 block
// of outputs each, both operands in shared memory read as float4 (rows
// padded to 68 floats, so neither a K-major nor an M-major read conflicts
// beyond the two wavefronts 256 bytes need); the next step's operands
// are loaded into registers while this step's FMAs run.  The decay is
// formed on the lower triangle only (exp(seg_i - seg_j) above it can
// overflow) and never factored as exp(seg_i) exp(-seg_j).  seg is summed
// in double and rounded once, as the plain version's cumsum on the CPU
// sums it.  Scratch comes from the caller: seg (B,H,nc,L), the chunks'
// own states and the states before them (B,H,nc,N,P) each, C.B^T
// (B,G,nc,L,L), all fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                    // 16 x 16
constexpr int kTile = 64;                        // output tile, and K step
constexpr int kLd = kTile + 4;                   // 68 = 4 (mod 32)
constexpr int kVecs = kTile * kTile / 4 / kThreads;  // float4 a thread loads
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxL = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive values from p, of which the first `avail` are in
// bounds (the others read as 0), as raw bits: fp32 as they are, bf16
// packed two to a word in x and y.  unpack4 turns them into floats; the
// two are apart so that a load is issued a step before its value is used.
// kVec: one 16-byte (fp32) or 8-byte (bf16) load, which the caller allows
// only where p is aligned and `avail` is at most 0 or at least 4 (or,
// with 4 values in bounds, any count of them that matter).
template <bool kVec, typename T>
__device__ __forceinline__ float4 fetch4(const T* p, int avail) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (avail <= 0) return v;
  if constexpr (sizeof(T) == 4) {
    if constexpr (kVec) {
      v = *reinterpret_cast<const float4*>(p);
    } else {
      v.x = p[0];
      if (avail > 1) v.y = p[1];
      if (avail > 2) v.z = p[2];
      if (avail > 3) v.w = p[3];
    }
  } else {
    uint2 u;
    if constexpr (kVec) {
      u = *reinterpret_cast<const uint2*>(p);
    } else {
      unsigned short q[4] = {0, 0, 0, 0};
      for (int e = 0; e < 4 && e < avail; ++e) q[e] = __bfloat16_as_ushort(p[e]);
      u = make_uint2(q[0] | (unsigned)q[1] << 16, q[2] | (unsigned)q[3] << 16);
    }
    v.x = __uint_as_float(u.x);
    v.y = __uint_as_float(u.y);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float4 unpack4(float4 raw) {
  if constexpr (sizeof(T) == 4) {
    return raw;
  } else {  // a bf16's float is its bits shifted up by 16
    const unsigned a = __float_as_uint(raw.x), b = __float_as_uint(raw.y);
    return make_float4(__uint_as_float(a << 16),
                       __uint_as_float(a & 0xffff0000u),
                       __uint_as_float(b << 16),
                       __uint_as_float(b & 0xffff0000u));
  }
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

template <typename T>
struct Scan {
  const float* x;
  const float* dA;
  const T* Bm;
  const T* Cm;
  const float* state0;  // null: zeros
  float* y;
  float* fs;
  float* seg;           // (B,H,nc,L)
  float* cs;            // (B,H,nc,N,P): each chunk's own state
  float* st;            // (B,H,nc,N,P): the state before each chunk
  float* cb;            // (B,G,nc,L,L): C_i . B_j, tiles on or below the diagonal
  int B, S, H, P, G, N, L, nc;
  long long sb, ss, sg;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// acc[r][q] += sum_k A[row r][k] B[k][col q] over one 64-deep step.  The
// thread's rows are ty*4 + r.  A is stored K-major ([m][k]) or M-major
// ([k][m]); B N-major ([k][n], the thread's columns tx*4 + q) or K-major
// ([n][k], columns tx + 16 q).  Row stride kLd for all.
template <bool kAK, bool kBK>
__device__ __forceinline__ void tile_fma(const float* as, const float* bs,
                                         float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kTile; k += 4) {
    float a[4][4], bv[4][4];  // a[r][kk], bv[q][kk]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if constexpr (kAK) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + (ty * 4 + u) * kLd + k);
        a[u][0] = v.x; a[u][1] = v.y; a[u][2] = v.z; a[u][3] = v.w;
      } else {
        const float4 v =
            *reinterpret_cast<const float4*>(as + (k + u) * kLd + ty * 4);
        a[0][u] = v.x; a[1][u] = v.y; a[2][u] = v.z; a[3][u] = v.w;
      }
      if constexpr (kBK) {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * u) * kLd + k);
        bv[u][0] = v.x; bv[u][1] = v.y; bv[u][2] = v.z; bv[u][3] = v.w;
      } else {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (k + u) * kLd + tx * 4);
        bv[0][u] = v.x; bv[1][u] = v.y; bv[2][u] = v.z; bv[3][u] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(a[r][kk], bv[q][kk], acc[r][q]);
  }
}

// The operands of step s, as stored, columns c4..c4+3 of a row, c4 along
// the contiguous index (16 neighbouring threads read 256 neighbouring
// bytes of the source): fa(s, row, c4) loads A's raw values, ma(s, row,
// c4, raw) makes them the operand; fb, mb the same for B.
template <typename FA, typename FB>
__device__ __forceinline__ void fetch_step(FA& fa, FB& fb, int s,
                                           float4 (&ra)[kVecs],
                                           float4 (&rb)[kVecs]) {
  const int row0 = threadIdx.x / 16, c4 = threadIdx.x % 16 * 4;
#pragma unroll
  for (int it = 0; it < kVecs; ++it) {
    ra[it] = fa(s, row0 + 16 * it, c4);
    rb[it] = fb(s, row0 + 16 * it, c4);
  }
}

// acc += sum over steps s < steps of A_s B_s.  Step s+1's loads are
// issued before step s's FMAs, and their values first used after them.
template <bool kAK, bool kBK, typename FA, typename MA, typename FB,
          typename MB>
__device__ __forceinline__ void gemm_steps(float* as, float* bs, int steps,
                                           FA fa, MA ma, FB fb, MB mb,
                                           float (&acc)[4][4]) {
  const int row0 = threadIdx.x / 16, c4 = threadIdx.x % 16 * 4;
  float4 ra[kVecs], rb[kVecs];
  if (steps > 0) fetch_step(fa, fb, 0, ra, rb);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int row = row0 + 16 * it, o = row * kLd + c4;
      *reinterpret_cast<float4*>(as + o) = ma(s, row, c4, ra[it]);
      *reinterpret_cast<float4*>(bs + o) = mb(s, row, c4, rb[it]);
    }
    __syncthreads();
    if (s + 1 < steps) fetch_step(fa, fb, s + 1, ra, rb);
    tile_fma<kAK, kBK>(as, bs, acc);
    __syncthreads();  // every reader of this step's tiles is done
  }
}

// Rows ty*4 + r, columns tx*4 + q of a thread's outputs into a row-major
// (rows x cols) matrix with row stride ld.
template <bool kVec>
__device__ __forceinline__ void store_tile(float* out, size_t ld, int rows,
                                           int cols, const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, c = tx * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    if (i >= rows || c >= cols) continue;
    float* o = out + i * ld + c;
    if (kVec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < cols) o[q] = acc[r][q];
    }
  }
}

// seg[t] = sum_{u<=t} dA_log[u] over one chunk (dA_log read with stride
// `stride`), positions t >= valid as identity steps: summed in double by
// 32 threads and rounded once.
__device__ void chunk_cumsum(const float* dA, int stride, int valid, int L,
                             float* segs, double* part) {
  const int tid = threadIdx.x;
  const int per = ceil_div(L, 32);
  const int lo = min(tid * per, L), hi = min(lo + per, L);
  if (tid < 32) {
    double run = 0.0;
    for (int t = lo; t < min(hi, valid); ++t) run += (double)dA[t * stride];
    part[tid] = run;
  }
  __syncthreads();
  if (tid < 32) {
    double run = 0.0;
    for (int k = 0; k < tid; ++k) run += part[k];
    for (int t = lo; t < hi; ++t) {
      if (t < valid) run += (double)dA[t * stride];
      segs[t] = (float)run;
    }
  }
  __syncthreads();
}

// C_i . B_j for one 64x64 tile (ti, tj <= ti) of one chunk and group.
template <typename T, bool kVec>
__device__ void cb_tile(const Scan<T>& p, int r, float* as, float* bs) {
  const int b = blockIdx.y;
  const int nt = ceil_div(p.L, kTile), ntri = nt * (nt + 1) / 2;
  const int g = r % p.G;
  r /= p.G;
  int t = r % ntri;
  const int c = r / ntri;
  int ti = 0;
  while (t > ti) t -= ++ti;
  const int i0 = ti * kTile, j0 = t * kTile;
  const int c0 = c * p.L, valid = min(p.L, p.S - c0);
  if (i0 >= valid) return;
  const long long off = b * p.sb + (long long)c0 * p.ss + g * p.sg;
  const T* Cg = p.Cm + off;
  const T* Bg = p.Bm + off;
  float acc[4][4] = {};
  const auto make = [](int, int, int, float4 raw) { return unpack4<T>(raw); };
  gemm_steps<true, true>(
      as, bs, ceil_div(p.N, kTile),
      [&](int s, int row, int c4) {
        const int i = i0 + row, n = s * kTile + c4;
        return fetch4<kVec>(Cg + i * p.ss + n, i < valid ? p.N - n : 0);
      },
      make,
      [&](int s, int row, int c4) {
        const int j = j0 + row, n = s * kTile + c4;
        return fetch4<kVec>(Bg + j * p.ss + n, j < valid ? p.N - n : 0);
      },
      make, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = p.cb + (((size_t)b * p.G + g) * p.nc + c) * p.L * p.L;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = i0 + ty * 4 + rr;
    if (i >= p.L) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j < p.L) out[(size_t)i * p.L + j] = acc[rr][q];
    }
  }
}

// Phase 1: seg and each chunk's own state, then C.B^T per group.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) chunk_state_kernel(const Scan<T> p) {
  __shared__ __align__(16) float as[kTile * kLd];
  __shared__ __align__(16) float bs[kTile * kLd];
  __shared__ float segs[kMaxL];
  __shared__ double part[32];

  const int b = blockIdx.y;
  const int ntn = ceil_div(p.N, kTile);
  int r = blockIdx.x;
  if (r >= p.nc * ntn * p.H) {
    cb_tile<T, kVec>(p, r - p.nc * ntn * p.H, as, bs);
    return;
  }
  const int h = r % p.H;
  r /= p.H;
  const int tn = r % ntn, c = r / ntn;
  const int c0 = c * p.L, valid = min(p.L, p.S - c0), n0 = tn * kTile;
  const size_t bh = (size_t)b * p.H + h;

  chunk_cumsum(p.dA + ((size_t)b * p.S + c0) * p.H + h, p.H, valid, p.L,
               segs, part);
  if (tn == 0)
    for (int t = threadIdx.x; t < p.L; t += kThreads)
      p.seg[(bh * p.nc + c) * p.L + t] = segs[t];
  const float total = segs[p.L - 1];
  __syncthreads();  // seg is read before it becomes the weights
  for (int t = threadIdx.x; t < valid; t += kThreads)
    segs[t] = expf(total - segs[t]);
  __syncthreads();

  const int g = h / (p.H / p.G);
  const T* Bg = p.Bm + b * p.sb + (long long)c0 * p.ss + g * p.sg + n0;
  const float* xh = p.x + (((size_t)b * p.S + c0) * p.H + h) * p.P;
  const size_t xrow = (size_t)p.H * p.P;
  float acc[4][4] = {};
  // state[n][p] = sum_l (w_l B_l[n]) x_l[p]: A M-major (rows l of B)
  gemm_steps<false, false>(
      as, bs, ceil_div(valid, kTile),
      [&](int s, int row, int c4) {
        const int l = s * kTile + row;
        return fetch4<kVec>(Bg + l * p.ss + c4, l < valid ? p.N - n0 - c4 : 0);
      },
      [&](int s, int row, int, float4 raw) {
        const int l = s * kTile + row;
        return scale4(unpack4<T>(raw), l < valid ? segs[l] : 0.f);
      },
      [&](int s, int row, int c4) {
        const int l = s * kTile + row;
        return fetch4<kVec>(xh + l * xrow + c4, l < valid ? p.P - c4 : 0);
      },
      [](int, int, int, float4 raw) { return raw; }, acc);
  store_tile<kVec>(p.cs + ((bh * p.nc + c) * p.N + n0) * p.P, p.P,
                   p.N - n0, p.P, acc);
}

// Phase 2: S_in[c+1] = S_in[c] exp(total_c) + state_c, one thread per
// element of (N,P).
__global__ void __launch_bounds__(kThreads)
state_passing_kernel(const float* __restrict__ seg,
                     const float* __restrict__ cs,
                     const float* __restrict__ state0,
                     float* __restrict__ st, float* __restrict__ fs, int H,
                     int nc, int L, int np) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= np) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float s = state0 != nullptr ? state0[bh * np + e] : 0.f;
  const float* totals = seg + bh * nc * L + (L - 1);
  const size_t base = bh * nc * (size_t)np + e;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const size_t o = base + (size_t)c * np;
    const float v = cs[o];
    const float decay = expf(totals[(size_t)c * L]);
    st[o] = s;
    s = s * decay + v;
  }
  fs[bh * np + e] = s;
}

// Phase 3: y for 64 rows of one chunk of one head.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) chunk_scan_kernel(const Scan<T> p) {
  __shared__ __align__(16) float as[kTile * kLd];
  __shared__ __align__(16) float bs[kTile * kLd];
  __shared__ float segs[kMaxL];
  __shared__ float eseg[kTile];

  const int b = blockIdx.y;
  const int nt = ceil_div(p.L, kTile);
  int r = blockIdx.x;
  const int h = r % p.H;
  r /= p.H;
  const int c = r % p.nc;
  const int ti = nt - 1 - r / p.nc;  // the longest rows first
  const int c0 = c * p.L, valid = min(p.L, p.S - c0), i0 = ti * kTile;
  if (i0 >= valid) return;
  const int g = h / (p.H / p.G);
  const size_t bh = (size_t)b * p.H + h;

  for (int t = threadIdx.x; t < min(p.L, i0 + kTile); t += kThreads)
    segs[t] = p.seg[(bh * p.nc + c) * p.L + t];
  __syncthreads();
  if (threadIdx.x < kTile)
    eseg[threadIdx.x] =
        i0 + threadIdx.x < valid ? expf(segs[i0 + threadIdx.x]) : 0.f;
  __syncthreads();

  const T* Cg = p.Cm + b * p.sb + (long long)c0 * p.ss + g * p.sg;
  const float* xh = p.x + (((size_t)b * p.S + c0) * p.H + h) * p.P;
  const size_t xrow = (size_t)p.H * p.P;
  const float* sprev = p.st + (bh * p.nc + c) * p.N * p.P;
  const float* cbc = p.cb + (((size_t)b * p.G + g) * p.nc + c) * p.L * p.L;
  // the state before the first chunk is zero unless state0 is given
  const int nst = (c > 0 || p.state0 != nullptr) ? ceil_div(p.N, kTile) : 0;
  float acc[4][4] = {};
  gemm_steps<true, false>(
      as, bs, nst + ti + 1,
      [&](int s, int row, int c4) {
        const int i = i0 + row;
        if (s < nst) {  // C_i, K = N
          const int n = s * kTile + c4;
          return fetch4<kVec>(Cg + i * p.ss + n, i < valid ? p.N - n : 0);
        }
        const int j0 = (s - nst) * kTile + c4;  // C_i . B_j, K = j
        return fetch4<kVec>(cbc + (size_t)i * p.L + j0,
                            i < valid ? min(p.L - j0, i - j0 + 1) : 0);
      },
      [&](int s, int row, int c4, float4 raw) {
        if (s < nst) return scale4(unpack4<T>(raw), eseg[row]);
        // times exp(seg_i - seg_j): the decay on the lower triangle
        // only, masked before the exponential
        const int i = i0 + row, j0 = (s - nst) * kTile + c4;
        const float cbv[4] = {raw.x, raw.y, raw.z, raw.w};
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + e;
          const bool keep = j <= i && i < valid;
          d[e] = keep ? cbv[e] * expf(segs[i] - segs[j]) : 0.f;
        }
        return make_float4(d[0], d[1], d[2], d[3]);
      },
      [&](int s, int row, int c4) {
        if (s < nst) {  // S_in[c]
          const int n = s * kTile + row;
          return fetch4<kVec>(sprev + (size_t)n * p.P + c4,
                              n < p.N ? p.P - c4 : 0);
        }
        const int j = (s - nst) * kTile + row;
        return fetch4<kVec>(xh + j * xrow + c4, j < valid ? p.P - c4 : 0);
      },
      [](int, int, int, float4 raw) { return raw; }, acc);
  store_tile<kVec>(p.y + (((size_t)b * p.S + c0 + i0) * p.H + h) * p.P,
                   (size_t)p.H * p.P, valid - i0, p.P, acc);
}

template <typename T, bool kVec>
cudaError_t launch(const Scan<T>& p, cudaStream_t stream) {
  const int nt = ceil_div(p.L, kTile);
  const dim3 state_grid(
      p.nc * ceil_div(p.N, kTile) * p.H + p.nc * nt * (nt + 1) / 2 * p.G, p.B);
  chunk_state_kernel<T, kVec><<<state_grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_passing_kernel<<<dim3(ceil_div(p.N * p.P, kThreads), p.H, p.B),
                         kThreads, 0, stream>>>(
      p.seg, p.cs, p.state0, p.st, p.fs, p.H, p.nc, p.L, p.N * p.P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan_kernel<T, kVec><<<dim3(nt * p.nc * p.H, p.B), kThreads, 0,
                               stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
int run(const void* x, const void* dA, const void* Bm,
        const void* Cm, const void* state0, void* y, void* fs, void* seg,
        void* cs, void* st, void* cb, int B, int S, int H, int P, int G,
        int N, int L, long long sb, long long ss, long long sg,
        void* stream) {
  Scan<T> p{static_cast<const float*>(x), static_cast<const float*>(dA),
            static_cast<const T*>(Bm), static_cast<const T*>(Cm),
            static_cast<const float*>(state0), static_cast<float*>(y),
            static_cast<float*>(fs), static_cast<float*>(seg),
            static_cast<float*>(cs), static_cast<float*>(st),
            static_cast<float*>(cb), B, S, H, P, G, N, L, ceil_div(S, L),
            sb, ss, sg};
  // 4-wide loads and stores where every row they touch starts aligned
  const bool vec = P % 4 == 0 && N % 4 == 0 && L % 4 == 0 && sb % 4 == 0 &&
                   ss % 4 == 0 && sg % 4 == 0 && aligned(x, 16) &&
                   aligned(y, 16) && aligned(state0, 16) && aligned(cs, 16) &&
                   aligned(st, 16) && aligned(cb, 16) &&
                   aligned(Bm, 4 * sizeof(T)) && aligned(Cm, 4 * sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<T, true>(p, s) : launch<T, false>(p, s));
}

}  // namespace

// Enqueues the scan's three kernels on `stream`.  bc_dtype: 0 = fp32
// B/C, 1 = bf16 B/C.  state0 may be null (zeros).  seg, cs, st and cb
// are the caller's scratch (see the header).  Returns the CUDA error of
// the first launch that failed (0 on success).
extern "C" int ssd_scan_launch(int bc_dtype, const void* x,
                               const void* dA, const void* Bm, const void* Cm,
                               const void* state0, void* y, void* fs,
                               void* seg, void* cs, void* st, void* cb, int B,
                               int S, int H, int P, int G, int N, int L,
                               long long sb, long long ss, long long sg,
                               void* stream) {
  if (N < 1 || N > kMaxN || P < 1 || P > kMaxP || L < 1 || L > kMaxL ||
      G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bc_dtype == 0)
    return run<float>(x, dA, Bm, Cm, state0, y, fs, seg, cs, st, cb,
                      B, S, H, P, G, N, L, sb, ss, sg, stream);
  if (bc_dtype == 1)
    return run<__nv_bfloat16>(x, dA, Bm, Cm, state0, y, fs, seg, cs,
                              st, cb, B, S, H, P, G, N, L, sb, ss, sg,
                              stream);
  return (int)cudaErrorInvalidValue;
}

