// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_fwd / _flash_fwd_kernel (the Pallas TPU kernel),
//   reached through ops.flash_attention.
//
// What it computes: full-sequence attention with an fp32 online softmax.
// q (B,Sq,H,D), k/v (B,Skv,Hkv,D) in the model's layout, out (B,Sq,H,D);
// q head h reads kv head h / (H/Hkv).  Scores are scaled by D^-1/2 and
// optionally soft-capped (tanh(s/c)*c).  Causal masking is top-left
// aligned, qpos >= kpos, as in the Pallas kernel; positions kpos >= Skv
// are always masked, so ragged lengths need no padding by the caller.
// bf16 or fp32, D in {64,128}.
//
// What bounds it on this card: at the prefill lengths of the serving
// path (hundreds to thousands of tokens) the arithmetic, 4·D flops per
// attended (q,k) pair, about Sq·Skv/2 pairs when causal, over 989 TFLOP/s
// of bf16 tensor cores; the bytes (q, k, v, out once each) are far less.
//
// What the design does about it: one block of 4 warps per (64-row q tile,
// head, batch).  K/V tiles of 64 rows are staged in shared memory and
// each is used by all 64 q rows.  Each warp owns 16 q rows, so between
// the block-wide tile loads a warp only synchronises with itself.  KV
// tiles wholly above the diagonal are never visited.  The running output
// is kept in shared memory in fp32 so it can be rescaled row by row.
// Both element types run one kernel body -- the tile loop, the masking
// and the online softmax are shared -- and differ only in the two
// products: tensor cores (WMMA 16x16x16, fp32 accumulation) for bf16,
// FMAs for fp32, so the fp32 comparisons check the served kernel's
// logic.  Loads are synchronous 16-byte copies; TMA, wgmma and a
// pipelined ring of tiles are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;      // q rows per block
constexpr int kBN = 64;      // kv rows per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int kv_tiles(int q0, int skv, bool causal) {
  int n = (skv + kBN - 1) / kBN;
  if (causal) n = min(n, (q0 + kBM - 1) / kBN + 1);
  return n;
}

// Scaled, capped and masked score.
__device__ __forceinline__ float score(float s, float scale, float softcap,
                                       int qpos, int kpos, int skv,
                                       bool causal) {
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  const bool ok = kpos < skv && (!causal || qpos >= kpos);
  return ok ? s : kNegInf;
}

// Shared-memory layout (byte offsets).  Row pitches are padded by 16
// bytes against bank conflicts and keep every WMMA tile 32-byte aligned.
template <typename T, int D>
struct Smem {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDQ = D + PAD;      // T row pitch of Q, K, V
  static constexpr int LDS = kBN + 4;      // fp32 row pitch of scores
  static constexpr int LDP = kBN + PAD;    // T row pitch of P
  static constexpr int LDO = D + 4;        // fp32 row pitch of O
  static constexpr int Q = 0;
  static constexpr int K = Q + kBM * LDQ * sizeof(T);
  static constexpr int V = K + kBN * LDQ * sizeof(T);
  static constexpr int S = V + kBN * LDQ * sizeof(T);
  static constexpr int P = S + kBM * LDS * 4;
  static constexpr int O = P + kBM * LDP * sizeof(T);
  static constexpr int M = O + kBM * LDO * 4;
  static constexpr int L = M + kBM * 4;
  static constexpr int A = L + kBM * 4;
  static constexpr int BYTES = A + kBM * 4;
};

// Copy rows [row0, row0+64) of one head into a (64, D) tile with pitch
// ld, zero-filling rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int n_rows,
                                          int row_stride) {
  constexpr int kElems = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int kChunks = D / kElems;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * row_stride + c * kElems);
    *reinterpret_cast<uint4*>(dst + r * ld + c * kElems) = val;
  }
}

// S = Q K^T for the warp's 16 rows starting at r0.
template <typename L, int D>
__device__ __forceinline__ void qk(const __nv_bfloat16* Qs,
                                   const __nv_bfloat16* Ks, float* Ss,
                                   int r0, int lane) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[kBN / 16];
#pragma unroll
  for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    wmma::load_matrix_sync(a, Qs + r0 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bk;
      wmma::load_matrix_sync(bk, Ks + j * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(sacc[j], a, bk, sacc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBN / 16; ++j)
    wmma::store_matrix_sync(Ss + r0 * L::LDS + j * 16, sacc[j], L::LDS,
                            wmma::mem_row_major);
}

template <typename L, int D>
__device__ __forceinline__ void qk(const float* Qs, const float* Ks,
                                   float* Ss, int r0, int lane) {
  for (int idx = lane; idx < 16 * kBN; idx += 32) {
    const int r = r0 + idx / kBN;
    const int c = idx % kBN;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += Qs[r * L::LDQ + d] * Ks[c * L::LDQ + d];
    Ss[r * L::LDS + c] = acc;
  }
}

// O += P V for the warp's 16 rows starting at r0.
template <typename L, int D>
__device__ __forceinline__ void pv(const __nv_bfloat16* Ps,
                                   const __nv_bfloat16* Vs, float* Os,
                                   int r0, int lane) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                 wmma::row_major> pa[kBN / 16];
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wmma::load_matrix_sync(pa[kk], Ps + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, Os + r0 * L::LDO + n * 16, L::LDO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bv;
      wmma::load_matrix_sync(bv, Vs + kk * 16 * L::LDQ + n * 16, L::LDQ);
      wmma::mma_sync(o, pa[kk], bv, o);
    }
    wmma::store_matrix_sync(Os + r0 * L::LDO + n * 16, o, L::LDO,
                            wmma::mem_row_major);
  }
}

template <typename L, int D>
__device__ __forceinline__ void pv(const float* Ps, const float* Vs,
                                   float* Os, int r0, int lane) {
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int r = r0 + idx / D;
    const int c = idx % D;
    float acc = Os[r * L::LDO + c];
    for (int j = 0; j < kBN; ++j)
      acc += Ps[r * L::LDP + j] * Vs[j * L::LDQ + c];
    Os[r * L::LDO + c] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int h, int hkv, int causal, float scale, float softcap) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* row_m = reinterpret_cast<float*>(smem + L::M);
  float* row_l = reinterpret_cast<float*>(smem + L::L);
  float* row_a = reinterpret_cast<float*>(smem + L::A);

  const int q0 = blockIdx.x * kBM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;                // this warp's rows of the tile

  load_tile<T, D>(Qs, L::LDQ, q + ((size_t)b * sq * h + head) * D, q0, sq,
                  h * D);
  for (int idx = threadIdx.x; idx < kBM * D; idx += kThreads)
    Os[(idx / D) * L::LDO + idx % D] = 0.f;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }

  const T* kb = k + ((size_t)b * skv * hkv + kvh) * D;
  const T* vb = v + ((size_t)b * skv * hkv + kvh) * D;
  const int n_tiles = kv_tiles(q0, skv, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBN;
    __syncthreads();                       // previous tile fully consumed
    load_tile<T, D>(Ks, L::LDQ, kb, kv0, skv, hkv * D);
    load_tile<T, D>(Vs, L::LDQ, vb, kv0, skv, hkv * D);
    __syncthreads();

    qk<L, D>(Qs, Ks, Ss, r0, lane);
    __syncwarp();

    // Online softmax over the tile, one row at a time, 2 columns a lane.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r;
      const float x0 = score(Ss[r * L::LDS + lane], scale, softcap, qpos,
                             kv0 + lane, skv, causal);
      const float x1 = score(Ss[r * L::LDS + lane + 32], scale, softcap,
                             qpos, kv0 + lane + 32, skv, causal);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      put(Ps + r * L::LDP + lane, p0);
      put(Ps + r * L::LDP + lane + 32, p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = r0 + idx / D;
      Os[r * L::LDO + idx % D] *= row_a[r];
    }
    __syncwarp();

    pv<L, D>(Ps, Vs, Os, r0, lane);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int r = r0 + idx / D;
    const int c = idx % D;
    if (q0 + r < sq)
      put(out + (((size_t)b * sq + q0 + r) * h + head) * D + c,
          Os[r * L::LDO + c] / fmaxf(row_l[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int h, int hkv, int causal, float scale,
           float softcap, cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBM - 1) / kBM, h, batch);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, hkv,
      causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or -1 for a configuration the kernel does not take.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int skv, int h, int hkv,
                                      int head_dim, int causal, float scale,
                                      float softcap, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || sq <= 0 || skv <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, batch, sq, skv, h, hkv,
                                     causal, scale, softcap, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, batch, sq, skv, h, hkv,
                                      causal, scale, softcap, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, batch, sq, skv, h, hkv, causal,
                             scale, softcap, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, batch, sq, skv, h, hkv, causal,
                              scale, softcap, s);
  return -1;
}
