// Probe of TF32 wgmma (run by scripts/tf32_wgmma_probe.py): the A register
// fragment layout, and what the tensor core does with the 13 low bits of
// an fp32 operand.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t sw(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

// mode 0: A from registers holding ids; mode 1: A from smem holding x[i]
__global__ void probe(float* out, const float* x, int mode) {
  __shared__ __align__(1024) unsigned char sm[16384];
  const int t = threadIdx.x;
  float* f = reinterpret_cast<float*>(sm);
  // B (8 x 8, K-major): identity at rows 0..7, 128 bytes a row, swizzled
  for (int i = t; i < 8 * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    f[sw(n * 128 + k * 4) / 4] = (n == k) ? 1.f : 0.f;
  }
  // A (64 x 8) in smem at 1024: row r holds x[8r + k]
  for (int i = t; i < 64 * 8; i += 128) {
    const int r = i / 8, k = i % 8;
    f[(1024 + sw(r * 128 + k * 4)) / 4] = x[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[4] = {0, 0, 0, 0};
  uint32_t a[4];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint((float)(t * 4 + r));
  const uint64_t db = desc(saddr(sm));
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (mode == 0) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0)
        : "memory");
  } else {
    const uint64_t da = desc(saddr(sm + 1024));
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(0)
        : "memory");
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // accumulator: d[e] at row 16 w + g + 8 (e / 2), column 2 q + e % 2
  const int w = t / 32, g = (t % 32) / 4, q = t % 4;
  for (int e = 0; e < 4; ++e)
    out[(16 * w + g + 8 * (e / 2)) * 8 + 2 * q + e % 2] = d[e];
}

extern "C" int run_probe(float* out, const float* x, int mode) {
  probe<<<1, 128>>>(out, x, mode);
  cudaError_t e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}
