// Chunked Mamba2 SSD scan for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_fwd /
//   _ssd_kernel (the Pallas TPU kernel), reached through ops.ssd_scan.
//
// What it computes, per (batch b, head h), with g = h / (H/G):
//   for each chunk of L positions, in order, with seg the inclusive
//   cumsum of dA_log over the chunk and S_in the state before it,
//     y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) x_j
//             + exp(seg_i) C_i . S_in
//     S_out = S_in exp(seg_L) + sum_j exp(seg_L - seg_j) B_j (x) x_j
//   and the final state after the last chunk.  The state starts from
//   `state0` (B,H,N,P), or from zeros when it is null.
//
// Layout: x (B,S,H,P) fp32 and dA_log (B,S,H) fp32, contiguous; B/C
// (B,S,G,N) fp32 or bf16 read through their strides (sb, ss, sg in
// elements, unit stride along N), so column slices of a wider tensor are
// read in place; y (B,S,H,P) fp32; final state (B,H,N,P) fp32.  N <= 128,
// P <= 64, L <= 1024.  A ragged last chunk is masked here: positions past
// S read as identity steps (x = 0, dA_log = 0, B = C = 0).
//
// What bounds it on this card: fp32 operations.  Per (chunk, head) the
// formula takes about 2 L^2 N + 2 L^2 P + 4 L N P flops (L 256, N 128,
// P 64: 33.6 MFLOP) against about 0.2 MB of inputs, far above the ~20
// flop/byte where the card's fp32 rate (67 TFLOP/s outside the tensor
// cores) and not its memory becomes the limit.  The products run as fp32
// FMAs, not TF32: the checks hold the kernel to its plain version at
// 1e-4, which TF32's 10-bit mantissa would not meet.
//
// What the design does about it (a simple first kernel): one block of
// 256 threads per (head, batch) sweeps the chunks in order, keeping the
// fp32 (N,P) state in shared memory for the whole sweep, so the state
// never goes through device memory.  A chunk does not fit in shared
// memory with its operands, so it is cut into 64-row tiles: for each
// tile of rows i, the tiles of rows j <= i are swept, C_i.B_j is formed
// in registers (a 4x4 block per thread), the decay is applied only on the
// lower triangle (exp(seg_i - seg_j) above the diagonal can overflow and
// is never formed), and the product with x_j accumulates in registers.
// seg for the chunk stays in shared memory.  Rows of tiles are padded to
// an odd length so the column reads hit distinct banks.  Only H*B blocks
// run (24 at B 1 for mamba2-130m): the chunks of one head do not run in
// parallel yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // rows of a tile, for i and for j
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxL = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ fs, int S, int H, int P, int G, int N,
                int L, long long sb, long long ss, long long sg) {
  extern __shared__ float smem[];
  const int ldt = N + 1;                       // odd row stride of cs/bs
  float* state = smem;                         // [N][kMaxP]
  float* seg = state + N * kMaxP;              // [L]
  float* cs = seg + L;                         // [kTile][ldt]
  float* bs = cs + kTile * ldt;                // [kTile][ldt]
  float* xs = bs + kTile * ldt;                // [kTile][kMaxP]
  float* ps = xs + kTile * kMaxP;              // [kTile][kTile + 1]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;

  const T* Bb = Bm + b * sb + grp * sg;
  const T* Cb = Cm + b * sb + grp * sg;

  for (int e = tid; e < N * kMaxP; e += kThreads) {
    const int n = e / kMaxP, p = e % kMaxP;
    state[e] = (state0 != nullptr && p < P)
                   ? state0[((size_t)(b * H + h) * N + n) * P + p]
                   : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += L) {
    const int valid = min(L, S - c0);
    __syncthreads();  // the previous chunk is done with seg and the tiles

    // seg: inclusive cumsum of dA_log over the chunk, by warp 0
    if (warp == 0) {
      const int per = (L + 31) / 32;
      const int lo = min(lane * per, L), hi = min(lo + per, L);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += (t < valid) ? dA[((size_t)b * S + c0 + t) * H + h] : 0.f;
        seg[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float excl = incl - run;
      for (int t = lo; t < hi; ++t) seg[t] += excl;
    }
    __syncthreads();
    const float total = seg[L - 1];

    // ---- y for every row tile, from the state before this chunk ----
    for (int i0 = 0; i0 < valid; i0 += kTile) {
      __syncthreads();  // earlier readers of cs are done
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, k = e % N, t = i0 + r;
        cs[r * ldt + k] = (t < valid) ? to_f32(Cb[(c0 + t) * ss + k]) : 0.f;
      }
      float acc[4][4] = {};
      const int jend = min(i0 + kTile, valid);
      for (int j0 = 0; j0 < jend; j0 += kTile) {
        __syncthreads();  // earlier readers of bs, xs, ps are done
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N, k = e % N, t = j0 + r;
          bs[r * ldt + k] = (t < valid) ? to_f32(Bb[(c0 + t) * ss + k]) : 0.f;
        }
        for (int e = tid; e < kTile * kMaxP; e += kThreads) {
          const int r = e / kMaxP, p = e % kMaxP, t = j0 + r;
          xs[e] = (t < valid && p < P)
                      ? x[(((size_t)b * S + c0 + t) * H + h) * P + p]
                      : 0.f;
        }
        __syncthreads();

        // scores C_i . B_j for rows ty+16r, columns tx+16q
        float sc[4][4] = {};
        for (int k = 0; k < N; ++k) {
          float a[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = cs[(ty + 16 * r) * ldt + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * ldt + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(a[r], bv[q], sc[r][q]);
        }
        // decay on the lower triangle only
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            const bool keep = j <= i && i < valid;
            ps[(ty + 16 * r) * (kTile + 1) + tx + 16 * q] =
                keep ? sc[r][q] * expf(seg[i] - seg[j]) : 0.f;
          }
        }
        __syncthreads();

        // acc += ps @ xs for rows ty+16r, columns p = tx+16q
        for (int jj = 0; jj < kTile; ++jj) {
          float pv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) pv[r] = ps[(ty + 16 * r) * (kTile + 1) + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xs[jj * kMaxP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(pv[r], xv[q], acc[r][q]);
        }
      }

      // inter-chunk term: exp(seg_i) C_i . S_in
      float inter[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float a[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = cs[(ty + 16 * r) * ldt + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = state[k * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[r][q] = fmaf(a[r], sv[q], inter[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= valid) continue;
        const float e = expf(seg[i]);
        float* yrow = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < P) yrow[p] = acc[r][q] + e * inter[r][q];
        }
      }
    }

    // ---- state update: S = S exp(total) + sum_j w_j B_j (x) x_j ----
    // each thread owns state rows n = ty+16r (r < 8), columns tx+16q
    float su[8][4] = {};
    for (int j0 = 0; j0 < valid; j0 += kTile) {
      __syncthreads();  // earlier readers of bs, xs (and cs, state) done
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, k = e % N, t = j0 + r;
        bs[r * ldt + k] = (t < valid)
                              ? expf(total - seg[t]) * to_f32(Bb[(c0 + t) * ss + k])
                              : 0.f;
      }
      for (int e = tid; e < kTile * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP, t = j0 + r;
        xs[e] = (t < valid && p < P)
                    ? x[(((size_t)b * S + c0 + t) * H + h) * P + p]
                    : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < kTile; ++jj) {
        float bv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = ty + 16 * r;
          bv[r] = n < N ? bs[jj * ldt + n] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xs[jj * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) su[r][q] = fmaf(bv[r], xv[q], su[r][q]);
      }
    }
    __syncthreads();  // every reader of the old state is done
    const float decay = expf(total);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* s = &state[n * kMaxP + tx + 16 * q];
        *s = *s * decay + su[r][q];
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e % P;
    fs[((size_t)(b * H + h) * N + n) * P + p] = state[n * kMaxP + p];
  }
}

template <typename T>
cudaError_t launch(const float* x, const float* dA, const T* Bm, const T* Cm,
                   const float* state0, float* y, float* fs, int B, int S,
                   int H, int P, int G, int N, int L, long long sb,
                   long long ss, long long sg, cudaStream_t stream) {
  const size_t floats = (size_t)N * kMaxP + L + 2 * kTile * (N + 1) +
                        kTile * kMaxP + kTile * (kTile + 1);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      x, dA, Bm, Cm, state0, y, fs, S, H, P, G, N, L, sb, ss, sg);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = fp32 B/C, 1 = bf16 B/C.  state0 may be null (zeros).
// Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_scan_launch(int bc_dtype, const void* x, const void* dA,
                               const void* Bm, const void* Cm,
                               const void* state0, void* y, void* fs, int B,
                               int S, int H, int P, int G, int N, int L,
                               long long sb, long long ss, long long sg,
                               void* stream) {
  if (N < 1 || N > kMaxN || P < 1 || P > kMaxP || L < 1 || L > kMaxL ||
      G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* da = static_cast<const float*>(dA);
  const float* s0 = static_cast<const float*>(state0);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(fs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bc_dtype == 0) {
    err = launch<float>(xf, da, static_cast<const float*>(Bm),
                        static_cast<const float*>(Cm), s0, yf, ff, B, S, H, P,
                        G, N, L, sb, ss, sg, st);
  } else if (bc_dtype == 1) {
    err = launch<__nv_bfloat16>(xf, da,
                                static_cast<const __nv_bfloat16*>(Bm),
                                static_cast<const __nv_bfloat16*>(Cm), s0, yf,
                                ff, B, S, H, P, G, N, L, sb, ss, sg, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
