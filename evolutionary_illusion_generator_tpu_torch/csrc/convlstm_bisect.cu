// Rung A of the kernel-bisection ladder, the C entry eigen_bisect_a: the
// counterpart of evolutionary_illusion_generator_tpu's
// scripts/pallas_bisect.py::variant_A (:65), float32(c_prev) * 2,
// elementwise.  The ladder's six conv rungs (C, D, H, E, I and J) are one
// wgmma kernel in bisect_wgmma.cu.  The wrappers, their plain versions and
// the host glue are in ops/convlstm_bisect.py.
//
// Bound on the H100: bytes (2 or 4 read and 4 written per element, no
// arithmetic to speak of; at the ladder's --big shape 553 MB, far past the
// 50 MB L2).  So it streams: 16-byte loads, several in flight a thread,
// 16-byte evict-first stores (__stcs) that a warp writes as 512 neighbouring
// bytes (a bfloat16 vector's two float32 stores go through warp shuffles:
// without them each store instruction wrote half of every 32-byte sector
// and the kernel took 1.5x as long), one tile of contiguous vectors a block;
// a scalar head and tail take a view that starts off a 16-byte boundary
// and a count that is not a multiple of the vector.

#include <cstdint>

#include "common.cuh"

namespace {

// Rung A, one pass over 16-byte vectors of the input: 8 bfloat16 values
// (two 16-byte float32 stores) or 4 float32 (one).  A block takes a tile of
// kUnroll x kAThreads contiguous vectors (one tile a block: measured 4%
// faster at --big than a grid of the blocks the card holds at once walking
// the tiles, scripts/rung_a_breakdown.py), and each thread issues its
// kUnroll loads before its first store.  Elements [0, head) bring `in` to a
// 16-byte boundary and the last (n - head) % V follow the vectors: both
// scalar, by the first threads of the grid.  The host has checked that
// out + head is 16-byte aligned too.
constexpr int kAThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTile = kAThreads * kUnroll;
constexpr long long kMaxBlocks = 0x7fffffff;  // beyond it the blocks walk the tiles

// The two bfloat16 values of a 32-bit word (the lower address in the low
// half) as float32, exactly.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// The output is never read again here: evict-first stores keep it from
// pushing the input out of L2.
__device__ __forceinline__ void store4(float4* p, float4 v) { __stcs(p, v); }

// A warp's 32 lanes hold 32 neighbouring vectors; `wdst` is the first
// float4 of their output, of which `nout` exist.  bfloat16: lane l's vector
// is the warp's float4s 2l and 2l + 1, so that each store instruction
// writes 512 neighbouring bytes, lane l stores float4 j = l and then
// j = 32 + l, taking its half of the vector of lane j / 2 by shuffles.
__device__ __forceinline__ void store_doubled(float4* wdst, uint4 v, long long nout,
                                              __nv_bfloat16) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = 16 * r + lane / 2;
    const unsigned x = __shfl_sync(0xffffffffu, v.x, s), y = __shfl_sync(0xffffffffu, v.y, s);
    const unsigned z = __shfl_sync(0xffffffffu, v.z, s), w = __shfl_sync(0xffffffffu, v.w, s);
    const unsigned a = lane & 1 ? z : x, b = lane & 1 ? w : y;
    const int j = 32 * r + lane;
    if (j < nout)
      store4(wdst + j, make_float4(bf16_lo(a) * 2.0f, bf16_hi(a) * 2.0f, bf16_lo(b) * 2.0f,
                                   bf16_hi(b) * 2.0f));
  }
}
__device__ __forceinline__ void store_doubled(float4* wdst, uint4 v, long long nout, float) {
  const int lane = threadIdx.x & 31;
  if (lane < nout)
    store4(wdst + lane, make_float4(__uint_as_float(v.x) * 2.0f, __uint_as_float(v.y) * 2.0f,
                                    __uint_as_float(v.z) * 2.0f, __uint_as_float(v.w) * 2.0f));
}

// vector u of this thread in tile `tile`
__device__ __forceinline__ long long vec_index(long long tile, int u) {
  return tile * kTile + u * kAThreads + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(kAThreads)
    double_kernel(const T* __restrict__ in, float* __restrict__ out, long long n, long long head) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = (n - head) / V;
  const long long tail = head + nvec * V;
  if (tid < head) out[tid] = eigen::to_float(in[tid]) * 2.0f;
  if (tid < n - tail) out[tail + tid] = eigen::to_float(in[tail + tid]) * 2.0f;
  const uint4* src = reinterpret_cast<const uint4*>(in + head);
  float4* dst = reinterpret_cast<float4*>(out + head);
  const long long ntiles = (nvec + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = vec_index(tile, u);
      v[u] = k < nvec ? __ldcs(src + k) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k0 = vec_index(tile, u) - lane;  // the warp's first vector
      if (k0 < nvec) store_doubled(dst + k0 * (V / 4), v[u], (nvec - k0) * (V / 4), T());
    }
  }
}

template <typename T>
int launch_double(const void* in, void* out, long long n, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  const uintptr_t a = (uintptr_t)in;
  if (a % sizeof(T) || (uintptr_t)out % sizeof(float)) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((16 - a % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long nvec = (n - head) / V;
  if (nvec > 0 && ((uintptr_t)out + 4 * head) % 16) return (int)cudaErrorMisalignedAddress;
  auto kernel = double_kernel<T>;
  long long blocks = (nvec + kTile - 1) / kTile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;  // the scalar head and tail
  kernel<<<(unsigned)blocks, kAThreads, 0, st>>>((const T*)in, (float*)out, n, head);
  return (int)cudaGetLastError();
}

}  // namespace

// variant_A: out = float32(c_prev) * 2, n elements; c_prev float32 or
// bfloat16 (c_prev_bf16 != 0).  out must sit as many float32 elements
// (mod 4) past a 16-byte boundary as c_prev sits elements of its type, so
// that both reach one after the same scalar head; otherwise it returns
// cudaErrorMisalignedAddress and launches nothing.
extern "C" int eigen_bisect_a(const void* c_prev, int c_prev_bf16, void* out, long long n,
                              void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (c_prev_bf16) return launch_double<__nv_bfloat16>(c_prev, out, n, st);
  return launch_double<float>(c_prev, out, n, st);
}
