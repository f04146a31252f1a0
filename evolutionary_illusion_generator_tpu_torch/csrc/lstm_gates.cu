// ConvLSTM cell update after the gate convolution: three bodies, one result.
//
// Replaces evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py
// ::fused_lstm_gates (Pallas body _gates_kernel).  Gate order [i, f, o, g]:
//   c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),  h = sigmoid(o) * tanh(c)
//
// Gates are (npix, 4C) and the state, h and c (npix, C), all row-major, so
// P consecutive pixels' operands are one contiguous byte range per tensor.
// Per (pixel, channel) the kernel reads 4 gates and one state value and
// writes h and c: 14 bytes in bfloat16, far below the ~295 operations per
// byte where the tensor cores would matter; but the math (three sigmoids of
// expf and an IEEE division, two tanhf) takes about 118 instructions, so the
// card's instruction issue bounds it about as closely as its memory does
// (scripts/gates_breakdown.py counts both bounds, the issue bound from this
// file's SASS).
//
// The bodies, picked per launch on the host (ops/convlstm_gates.py
// ::gates_plan):
// - scalar: the first body, as it was.  One thread per (pixel,
//   channel) in a grid-stride loop; each element pays a 64-bit division by
//   C and issues five 2-byte loads and two 2-byte stores: 177 instructions
//   an element.  It is the reference the others are held against on the
//   card, bit for bit, and the plan's body for calls of up to the main
//   path's 6.45 MB, where a persistent grid's ramp costs more than it saves.
// - vector: C a multiple of V (8 channels where gates, state and outputs are
//   all bfloat16, else 4) and every pointer aligned to its vector: the True
//   route's layers 1-3.  A thread takes V channels of one pixel: the four
//   gate vectors and the state vector go straight into registers (16-byte
//   loads; neighbouring threads on neighbouring addresses within a pixel's
//   gate slice), h and c leave as one vector each; 122 instructions an
//   element.  A persistent grid walks the vectors.
// - slab: any C and any alignment: the narrow widths 1, 3 and 12 (the pixel
//   layers and the s2d pixel layer).  Each warp walks its own slabs of P
//   pixels, whose gates and state it stages in shared memory through its own
//   ring of two or three stages: the 16-byte-aligned interior of each byte
//   range by cp.async, so the next slab's loads are in flight under this
//   slab's math, and the head and tail (under 16 bytes each, present only
//   where a view is off its alignment or a slab ends inside a 16-byte
//   granule) element by element.  The math reads each gate per (pixel,
//   channel) from shared memory and writes h and c there; they leave as
//   16-byte stores, with the same element-wise head and tail.  A warp waits
//   only on its own lanes, so one warp's loads and stores run under the
//   others' math (a block-wide ring with two block barriers a slab measured
//   the same).
// The streaming bodies index with 32-bit numbers and divide by a multiplier
// and a shift fixed once per launch (Divisor), never by a division.
//
// The math is bit-equal across the bodies: float32 with expf and tanhf (no
// fast-math, no approximate intrinsics), bfloat16 widened exactly, h and c
// rounded to nearest even only at the store, and the one product of the
// cell update that the compiler fuses into an FMA chosen as the scalar
// body's build chose it (`cell`).  So every body equals the first body's
// bits, and torch's plain float32 math followed by .to(bfloat16) up to the
// last float32 ulp.
//
// Types are template parameters: gates float32 or bfloat16, c_prev float32
// or bfloat16, h and c float32 (the JAX function's contract) or bfloat16 (a
// bfloat16 state: the kernel reads the bfloat16 conv output as it is and
// writes the state, which saves the float32 copy of the gates and the two
// state casts that would surround it).

#include "common.cuh"

namespace {

constexpr int STREAM_THREADS = 256;  // threads a block of the streaming bodies
enum Body { SCALAR = 0, VECTOR = 1, SLAB = 2 };

// One (pixel, channel) of the streaming bodies, bit-equal to the scalar
// body: its expressions in its order, and its cell update with the one
// product that its build fuses into an FMA named, since that choice is the
// compiler's and follows the code around it.  The scalar body's SASS fuses
// i * g and rounds f * c_prev where the state is bfloat16, and the reverse
// where it is float32.
template <typename ST>
__device__ __forceinline__ void cell(float gi, float gf, float go, float gg, float cp, float& h,
                                     float& c) {
  const float i = eigen::sigmoid(gi);
  const float f = eigen::sigmoid(gf);
  const float o = eigen::sigmoid(go);
  const float g = tanhf(gg);
  c = sizeof(ST) == 2 ? __fmaf_rn(i, g, __fmul_rn(f, cp)) : __fmaf_rn(f, cp, __fmul_rn(i, g));
  h = o * tanhf(c);
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply and a shift:
// s = 31 + ceil(log2 d), m = ceil(2^s / d) < 2^32, n / d = (n m) >> s
// (exact: m d - 2^s < d <= 2^(s - 31), so n (m d - 2^s) < 2^s).
struct Divisor {
  unsigned d, m, s;
};

Divisor make_divisor(unsigned d) {
  unsigned k = 0;
  while ((1ull << k) < d) ++k;
  const unsigned s = 31 + k;
  return {d, (unsigned)(((1ull << s) + d - 1) / d), s};
}

__device__ __forceinline__ unsigned quotient(unsigned n, const Divisor& v) {
  return (unsigned)(((unsigned long long)n * v.m) >> v.s);
}

// ---- scalar: the first body

template <typename GT, typename ST, typename OT>
__global__ void lstm_gates_kernel(const GT* __restrict__ gates, const ST* __restrict__ c_prev,
                                  OT* __restrict__ h_out, OT* __restrict__ c_out, long long n,
                                  int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const long long p = idx / C;
    const int ch = (int)(idx - p * C);
    const GT* g = gates + p * 4 * C + ch;
    const float i = eigen::sigmoid(eigen::to_float(g[0]));
    const float f = eigen::sigmoid(eigen::to_float(g[C]));
    const float o = eigen::sigmoid(eigen::to_float(g[2 * C]));
    const float gg = tanhf(eigen::to_float(g[3 * C]));
    const float c = f * eigen::to_float(c_prev[idx]) + i * gg;
    c_out[idx] = eigen::from_float<OT>(c);
    h_out[idx] = eigen::from_float<OT>(o * tanhf(c));
  }
}

// ---- vector: V channels of one pixel a thread, in registers

template <typename GT, typename ST, typename OT>
__host__ __device__ constexpr int vector_width() {
  return sizeof(GT) == 2 && sizeof(ST) == 2 && sizeof(OT) == 2 ? 8 : 4;
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {  // V values of T as one 8- or 16-byte access
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename GT, typename ST, typename OT>
__global__ void __launch_bounds__(STREAM_THREADS)
    lstm_gates_vector_kernel(const GT* __restrict__ gates, const ST* __restrict__ c_prev,
                             OT* __restrict__ h_out, OT* __restrict__ c_out, unsigned nvec,
                             int C, Divisor per_pixel) {
  constexpr int V = vector_width<GT, ST, OT>();
  const unsigned stride = gridDim.x * STREAM_THREADS;
  for (unsigned j = blockIdx.x * STREAM_THREADS + threadIdx.x; j < nvec; j += stride) {
    const unsigned p = quotient(j, per_pixel);
    const GT* g = gates + (size_t)p * 4 * C + (j - p * per_pixel.d) * V;
    const Pack<GT, V> gi = load_pack<GT, V>(g), gf = load_pack<GT, V>(g + C),
                      go = load_pack<GT, V>(g + 2 * C), gg = load_pack<GT, V>(g + 3 * C);
    const Pack<ST, V> cp = load_pack<ST, V>(c_prev + (size_t)j * V);
    Pack<OT, V> h, c;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float hk, ck;
      cell<ST>(eigen::to_float(gi.v[k]), eigen::to_float(gf.v[k]), eigen::to_float(go.v[k]),
           eigen::to_float(gg.v[k]), eigen::to_float(cp.v[k]), hk, ck);
      h.v[k] = eigen::from_float<OT>(hk);
      c.v[k] = eigen::from_float<OT>(ck);
    }
    *reinterpret_cast<Pack<OT, V>*>(h_out + (size_t)j * V) = h;
    *reinterpret_cast<Pack<OT, V>*>(c_out + (size_t)j * V) = c;
  }
}

// ---- slab: P pixels a warp at a time, staged in shared memory

constexpr int SLAB_WARPS = STREAM_THREADS / 32;

// The shared bytes a stage of `bytes` bytes takes: its data lands at the
// global address's offset in its 16-byte granule.
__host__ __device__ constexpr unsigned stage_bytes(unsigned long long bytes) {
  return (unsigned)((bytes + 15) / 16 * 16 + 16);
}

// A warp's shared memory: `ring` stages of a slab's gates and state, then
// its h and c.
__host__ __device__ constexpr unsigned long long warp_bytes(unsigned long long pc, int gs,
                                                            int ss, int os, int ring) {
  return ring * (unsigned long long)(stage_bytes(4 * pc * gs) + stage_bytes(pc * ss)) +
         2ull * stage_bytes(pc * os);
}

// The warp's lanes copy `count` elements at `src` into shared memory at
// `dst` (16-byte aligned) + (src & 15): the 16-byte-aligned interior by
// cp.async (the caller commits the group), the head and tail element by
// element.
template <typename T>
__device__ __forceinline__ void stage_in(char* dst, const T* src, unsigned count, unsigned lane) {
  const size_t a = (size_t)src, e = a + (size_t)count * sizeof(T), base = a & ~(size_t)15;
  const size_t up = (a + 15) & ~(size_t)15, down = e & ~(size_t)15;
  const size_t a0 = up < e ? up : e, a1 = down > a0 ? down : a0;
  for (size_t x = a0 + 16 * lane; x < a1; x += 16 * 32)
    eigen::cp_async16(dst + (x - base), reinterpret_cast<const void*>(x), true);
  const unsigned head = (unsigned)((a0 - a) / sizeof(T));
  const unsigned edges = head + (unsigned)((e - a1) / sizeof(T));
  for (unsigned t = lane; t < edges; t += 32) {
    const size_t x = t < head ? a + t * sizeof(T) : a1 + (t - head) * sizeof(T);
    *reinterpret_cast<T*>(dst + (x - base)) = *reinterpret_cast<const T*>(x);
  }
}

// The reverse: `count` elements laid out in shared memory at `src` as
// stage_in lays out dst's bytes go to `dst`, as 16-byte stores with the
// head and tail element by element.
template <typename T>
__device__ __forceinline__ void stage_out(T* dst, const char* src, unsigned count, unsigned lane) {
  const size_t a = (size_t)dst, e = a + (size_t)count * sizeof(T), base = a & ~(size_t)15;
  const size_t up = (a + 15) & ~(size_t)15, down = e & ~(size_t)15;
  const size_t a0 = up < e ? up : e, a1 = down > a0 ? down : a0;
  for (size_t x = a0 + 16 * lane; x < a1; x += 16 * 32)
    *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(src + (x - base));
  const unsigned head = (unsigned)((a0 - a) / sizeof(T));
  const unsigned edges = head + (unsigned)((e - a1) / sizeof(T));
  for (unsigned t = lane; t < edges; t += 32) {
    const size_t x = t < head ? a + t * sizeof(T) : a1 + (t - head) * sizeof(T);
    *reinterpret_cast<T*>(x) = *reinterpret_cast<const T*>(src + (x - base));
  }
}

template <typename T>
__device__ __forceinline__ unsigned granule_offset(const T* p) {
  return (unsigned)((size_t)p & 15);
}

// Each warp walks its own slabs (warp w of block b from b SLAB_WARPS + w,
// striding by the grid's warps) through its own ring: no barrier but the
// warp's, so one warp's loads and stores run under the others' math.
template <typename GT, typename ST, typename OT>
__global__ void __launch_bounds__(STREAM_THREADS)
    lstm_gates_slab_kernel(const GT* __restrict__ gates, const ST* __restrict__ c_prev,
                           OT* __restrict__ h_out, OT* __restrict__ c_out, long long npix, int C,
                           Divisor per_pixel, int P, int ring, int nslabs) {
  extern __shared__ __align__(16) char smem[];
  const unsigned long long pc = (unsigned long long)P * C;
  const unsigned gate_bytes = stage_bytes(4 * pc * sizeof(GT));
  const unsigned stage = gate_bytes + stage_bytes(pc * sizeof(ST));
  const unsigned out_bytes = stage_bytes(pc * sizeof(OT));
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  char* const ring_buf =
      smem + warp * warp_bytes(pc, sizeof(GT), sizeof(ST), sizeof(OT), ring);
  char* const h_buf = ring_buf + ring * stage;  // h and c after the ring
  char* const c_buf = h_buf + out_bytes;
  const long long first = (long long)blockIdx.x * SLAB_WARPS + warp;
  const long long step = (long long)gridDim.x * SLAB_WARPS;

  // slab s's loads into stage k, committed as one group (an empty group past
  // the last slab, so that every lane counts the same groups)
  auto issue = [&](long long s, int k) {
    if (s < nslabs) {
      const long long p0 = s * P;
      const unsigned n = (unsigned)min((long long)P, npix - p0);
      stage_in(ring_buf + k * stage, gates + p0 * 4 * C, n * 4 * C, lane);
      stage_in(ring_buf + k * stage + gate_bytes, c_prev + p0 * C, n * C, lane);
    }
    eigen::cp_async_commit();
  };
  for (int k = 0; k + 1 < ring; ++k) issue(first + k * step, k);
  int k = 0;
  for (long long s = first; s < nslabs; s += step) {
    issue(s + (ring - 1) * step, k == 0 ? ring - 1 : k - 1);
    if (ring == 3)
      eigen::cp_async_wait<2>();
    else
      eigen::cp_async_wait<1>();
    __syncwarp();  // slab s in stage k, its elements from every lane
    const long long p0 = s * P;
    const GT* const gs = gates + p0 * 4 * C;
    const ST* const cs = c_prev + p0 * C;
    OT* const hd = h_out + p0 * C;
    OT* const cd = c_out + p0 * C;
    const GT* const g = reinterpret_cast<const GT*>(ring_buf + k * stage + granule_offset(gs));
    const ST* const cp =
        reinterpret_cast<const ST*>(ring_buf + k * stage + gate_bytes + granule_offset(cs));
    OT* const h = reinterpret_cast<OT*>(h_buf + granule_offset(hd));
    OT* const c = reinterpret_cast<OT*>(c_buf + granule_offset(cd));
    const unsigned ne = (unsigned)min((long long)P, npix - p0) * C;
    for (unsigned e = lane; e < ne; e += 32) {
      // pixel lp, channel e - lp C: gate i at lp 4C + e - lp C
      const GT* const ge = g + quotient(e, per_pixel) * 3 * C + e;
      float hv, cv;
      cell<ST>(eigen::to_float(ge[0]), eigen::to_float(ge[C]), eigen::to_float(ge[2 * C]),
               eigen::to_float(ge[3 * C]), eigen::to_float(cp[e]), hv, cv);
      h[e] = eigen::from_float<OT>(hv);
      c[e] = eigen::from_float<OT>(cv);
    }
    __syncwarp();  // h and c of the slab in shared memory; stage k free
    stage_out(hd, h_buf, ne, lane);
    stage_out(cd, c_buf, ne, lane);
    __syncwarp();  // h and c read out before the next slab's math writes them
    k = k + 1 == ring ? 0 : k + 1;
  }
  eigen::cp_async_wait<0>();  // the empty groups past the end: nothing outlives the warp
}

template <typename GT, typename ST, typename OT>
int launch(const void* gates, const void* c_prev, void* h_out, void* c_out, long long npix,
           int C, int body, int slab_pixels, int ring, int grid, cudaStream_t st) {
  const GT* g = (const GT*)gates;
  const ST* s = (const ST*)c_prev;
  OT *h = (OT*)h_out, *c = (OT*)c_out;
  const long long n = npix * C;
  if (body == SCALAR) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    lstm_gates_kernel<GT, ST, OT><<<(unsigned)blocks, threads, 0, st>>>(g, s, h, c, n, C);
    return (int)cudaGetLastError();
  }
  if (grid < 1) return (int)cudaErrorInvalidValue;
  if (body == VECTOR) {
    constexpr int V = vector_width<GT, ST, OT>();
    auto off = [](const void* p, int bytes) { return (size_t)p % bytes != 0; };
    if (C % V || n / V >= (1LL << 31) || off(g, V * sizeof(GT)) || off(s, V * sizeof(ST)) ||
        off(h, V * sizeof(OT)) || off(c, V * sizeof(OT)))
      return (int)cudaErrorInvalidValue;
    lstm_gates_vector_kernel<GT, ST, OT><<<grid, STREAM_THREADS, 0, st>>>(
        g, s, h, c, (unsigned)(n / V), C, make_divisor((unsigned)(C / V)));
    return (int)cudaGetLastError();
  }
  if (body != SLAB || (ring != 2 && ring != 3) || slab_pixels < 1 ||
      (long long)slab_pixels * 4 * C >= (1LL << 31) ||
      (npix + slab_pixels - 1) / slab_pixels >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned long long smem =
      SLAB_WARPS * warp_bytes((unsigned long long)slab_pixels * C, sizeof(GT), sizeof(ST),
                              sizeof(OT), ring);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_gates_slab_kernel<GT, ST, OT>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int nslabs = (int)((npix + slab_pixels - 1) / slab_pixels);
  kernel<<<grid, STREAM_THREADS, smem, st>>>(g, s, h, c, npix, C, make_divisor((unsigned)C),
                                             slab_pixels, ring, nslabs);
  return (int)cudaGetLastError();
}

template <typename GT, typename ST>
int launch_out(const void* gates, const void* c_prev, int out_bf16, void* h_out, void* c_out,
               long long npix, int C, int body, int slab_pixels, int ring, int grid,
               cudaStream_t st) {
  if (out_bf16)
    return launch<GT, ST, __nv_bfloat16>(gates, c_prev, h_out, c_out, npix, C, body,
                                         slab_pixels, ring, grid, st);
  return launch<GT, ST, float>(gates, c_prev, h_out, c_out, npix, C, body, slab_pixels, ring,
                               grid, st);
}

template <typename GT>
int launch_state(const void* gates, const void* c_prev, int c_prev_bf16, int out_bf16,
                 void* h_out, void* c_out, long long npix, int C, int body, int slab_pixels,
                 int ring, int grid, cudaStream_t st) {
  if (c_prev_bf16)
    return launch_out<GT, __nv_bfloat16>(gates, c_prev, out_bf16, h_out, c_out, npix, C, body,
                                         slab_pixels, ring, grid, st);
  return launch_out<GT, float>(gates, c_prev, out_bf16, h_out, c_out, npix, C, body,
                               slab_pixels, ring, grid, st);
}

}  // namespace

// gates: (npix, 4C) float32 or bfloat16 (gates_bf16 != 0); c_prev: (npix, C)
// float32 or bfloat16 (c_prev_bf16 != 0); h_out, c_out: (npix, C) float32 or
// bfloat16 (out_bf16 != 0).  All contiguous.  body 0 is the scalar body
// (slab_pixels, ring and grid unused), 1 the vector body (C a multiple of its
// width, every pointer aligned to its vector; `grid` blocks), 2 the slab body
// (slabs of `slab_pixels` pixels a warp through a ring of `ring` (2 or 3)
// stages; `grid` blocks).  Launches on `stream` and returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for arguments the body does not take.
extern "C" int eigen_lstm_gates(const void* gates, int gates_bf16, const void* c_prev,
                                int c_prev_bf16, void* h_out, void* c_out, int out_bf16,
                                long long npix, int C, int body, int slab_pixels, int ring,
                                int grid, void* stream) {
  if (npix * (long long)C == 0) return (int)cudaSuccess;
  if (C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (gates_bf16)
    return launch_state<__nv_bfloat16>(gates, c_prev, c_prev_bf16, out_bf16, h_out, c_out, npix,
                                       C, body, slab_pixels, ring, grid, st);
  return launch_state<float>(gates, c_prev, c_prev_bf16, out_bf16, h_out, c_out, npix, C, body,
                             slab_pixels, ring, grid, st);
}
