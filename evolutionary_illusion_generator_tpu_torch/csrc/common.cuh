// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace eigen {

// The gate nonlinearities in float32 with the accurate libm functions, as
// the plain PyTorch versions compute them (torch.sigmoid / torch.tanh).
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The recurrent state is float32 or bfloat16; these load / store it as float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// ---- the tensor-core building blocks of the conv kernels (sm_80 and up)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// d += a * b for one 16 x 8 tile: a is 16 x 16 (row major), b 16 x 8 (column
// major), bfloat16 pairs packed in 32-bit registers, d float32.
__device__ __forceinline__ void mma16816(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bfloat16 matrices from shared memory: lane 8 j + i gives the
// 16-byte row i of matrix j; r[j] gets the lane's pair (row lane / 4,
// columns 2 (lane % 4) and + 1) of matrix j — the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

}  // namespace eigen
