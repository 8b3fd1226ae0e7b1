// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
//   paged_attention_fwd / _paged_attn_kernel (the Pallas TPU kernel),
//   reached through ops.paged_attention.
//
// What it computes: one decode token per sequence attends over that
// sequence's KV, which lies in fixed-size pages named by a block table.
// For sequence b and kv head h, the q heads h*G .. h*G+G-1 (G = Hq/Hkv)
// attend together to positions [0, lens[b]); scores are scaled by
// D^-1/2, optionally soft-capped (tanh(s/c)*c), and softmaxed in fp32
// with an online (running max / running sum) update.
//
// Layout: q (B,Hq,D); k/v pages (NP,P,Hkv,D) token-major, read in place
// through their dimensions (the TPU wrapper copied the whole store into
// head-major order on every call; this kernel does not); tables (B,MP)
// int32; lens (B,) int32; out (B,Hq,D).  bf16 or fp32, D in {64,128},
// G in {1,2,4,8}.
//
// What bounds it on this card: device-memory bytes.  Each K/V element
// is read once and used for G multiply-adds, far below the ~295 flop/byte
// the H100 needs before its arithmetic units become the limit, so the
// floor is Σ_b ceil(len_b/P)·P·Hkv·D·2·bytes over 3.35 TB/s.
//
// What the design does about it: one block per (kv head, sequence), so
// K/V of one kv head is read once for all G q heads of its group.  Each
// of the 4 warps takes chunks of CH positions in turn; a lane holds D/32
// contiguous elements of a row, so a warp reads a whole row in one
// coalesced access, and the CH rows of a chunk are loaded before any is
// used, keeping CH loads in flight per warp.  Only positions < len are
// read (pages past ceil(len/P) are never touched).  Each warp keeps its
// own softmax state in registers; the warps merge once at the end
// through shared memory.  No split over the sequence yet: at small batch
// few blocks run (a later change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load VEC contiguous elements as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&dst)[VEC]);

template <>
__device__ __forceinline__ void load_row<float, 2>(const float* p,
                                                   float (&dst)[2]) {
  float2 v = *reinterpret_cast<const float2*>(p);
  dst[0] = v.x; dst[1] = v.y;
}
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p,
                                                   float (&dst)[4]) {
  float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, float (&dst)[2]) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  float2 f = __bfloat1622float2(v);
  dst[0] = f.x; dst[1] = f.y;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float (&dst)[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, T* __restrict__ out,
                  int hkv, int page, int max_pages, float scale,
                  float softcap) {
  constexpr int VEC = D / 32;
  constexpr int CH = G <= 2 ? 16 : (G <= 4 ? 8 : 4);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * G;
  const int len = min(lens[b], max_pages * page);
  const int* table = tables + (size_t)b * max_pages;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<T, VEC>(q + ((size_t)b * hq + kvh * G + g) * D + lane * VEC,
                     qr[g]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const int n_chunks = (len + CH - 1) / CH;
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int pos0 = c * CH;
    size_t row_off[CH];
    float kr[CH][VEC];
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const int pos = pos0 + t;
      if (pos < len) {
        const int pg = table[pos / page];
        row_off[t] = (((size_t)pg * page + pos % page) * hkv + kvh) * D +
                     lane * VEC;
        load_row<T, VEC>(k_pages + row_off[t], kr[t]);
      } else {
        row_off[t] = 0;
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[t][i] = 0.f;
      }
    }
    float p[CH][G];
#pragma unroll
    for (int t = 0; t < CH; ++t) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part += qr[g][i] * kr[t][i];
        float s = warp_sum(part) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        p[t][g] = (pos0 + t < len) ? s : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int t = 0; t < CH; ++t) mx = fmaxf(mx, p[t][g]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        p[t][g] = expf(p[t][g] - mx);
        l[g] += p[t][g];
      }
      m[g] = mx;
    }
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      if (pos0 + t < len) {
        float vr[VEC];
        load_row<T, VEC>(v_pages + row_off[t], vr);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] += p[t][g] * vr[i];
      }
    }
  }

  // Merge the warps' partial softmax states.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][g][lane * VEC + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float tot_l = 0.f, tot_o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      tot_l += sm_l[w][g] * f;
      tot_o += sm_acc[w][g][d] * f;
    }
    store(out + ((size_t)b * hq + kvh * G + g) * D + d,
          tot_o / fmaxf(tot_l, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lens, void* out, int batch, int hkv, int page,
           int max_pages, float scale, float softcap, cudaStream_t stream) {
  paged_attn_kernel<T, D, G><<<dim3(hkv, batch), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), hkv, page,
      max_pages, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const void* tables, const void* lens, void* out, int batch,
                 int hkv, int page, int max_pages, float scale, float softcap,
                 cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, D, 1>(q, k, v, tables, lens, out, batch, hkv,
                                   page, max_pages, scale, softcap, stream);
    case 2: return launch<T, D, 2>(q, k, v, tables, lens, out, batch, hkv,
                                   page, max_pages, scale, softcap, stream);
    case 4: return launch<T, D, 4>(q, k, v, tables, lens, out, batch, hkv,
                                   page, max_pages, scale, softcap, stream);
    case 8: return launch<T, D, 8>(q, k, v, tables, lens, out, batch, hkv,
                                   page, max_pages, scale, softcap, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or -1 for a configuration the kernel does not take.
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lens, void* out, int batch,
                                      int hq, int hkv, int head_dim, int page,
                                      int max_pages, float scale,
                                      float softcap, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return -1;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_group<float, 64>(group, q, k, v, tables, lens, out, batch,
                                   hkv, page, max_pages, scale, softcap, s);
  if (dtype == 0 && head_dim == 128)
    return launch_group<float, 128>(group, q, k, v, tables, lens, out, batch,
                                    hkv, page, max_pages, scale, softcap, s);
  if (dtype == 1 && head_dim == 64)
    return launch_group<__nv_bfloat16, 64>(group, q, k, v, tables, lens, out,
                                           batch, hkv, page, max_pages, scale,
                                           softcap, s);
  if (dtype == 1 && head_dim == 128)
    return launch_group<__nv_bfloat16, 128>(group, q, k, v, tables, lens, out,
                                            batch, hkv, page, max_pages,
                                            scale, softcap, s);
  return -1;
}
