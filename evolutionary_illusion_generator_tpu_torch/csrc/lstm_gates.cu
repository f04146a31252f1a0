// ConvLSTM cell update after the gate convolution.
//
// Replaces evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py
// ::fused_lstm_gates (Pallas body _gates_kernel).  Gate order [i, f, o, g]:
//   c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),  h = sigmoid(o) * tanh(c)
//
// Bound on the H100: bytes.  Per pixel and channel it reads 4 gates and one
// state value and writes h and c (~26 bytes in float32) for a few dozen
// operations, far below the ~295 operations per byte where compute would
// start to matter.  Design: one thread per (pixel, channel) in a grid-stride
// loop, reading each operand once and writing h and c once — no intermediate
// touches device memory.  The four gate loads of a thread are C values apart;
// neighbouring threads take neighbouring channels, so each of the five loads
// and two stores is coalesced across the warp.  At the pixel layer's shape
// (8 x 120 x 160, C = 3) the float32 contract takes 4.6 us on the device
// against a 3.6 us bound (PERF.md), so the body is kept as it was.  The main
// path's narrow layers run csrc/convlstm_narrow.cu instead, which does this
// math after their gate convolutions in the same kernel; this one serves
// the routes whose gates arrive precomputed (s2d, subpixel_up,
// use_pallas=True).
//
// Types are template parameters: gates float32 or bfloat16, c_prev float32
// or bfloat16, h and c float32 (the JAX function's contract) or bfloat16 (a
// bfloat16 state: the kernel then reads the bfloat16 conv output as it is
// and writes the state, which saves the float32 copy of the gates and the two
// state casts that would surround it).  The math is float32 with expf and
// tanhf, as the plain version; bfloat16 values are widened exactly, and h and
// c are rounded to nearest even only at the store, so the result is the
// float32 kernel's followed by torch's .to(bfloat16).

#include "common.cuh"

namespace {

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

template <typename GT, typename ST, typename OT>
int launch(const void* gates, const void* c_prev, void* h_out, void* c_out, long long n, int C,
           cudaStream_t st) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  lstm_gates_kernel<GT, ST, OT><<<(unsigned)blocks, threads, 0, st>>>(
      (const GT*)gates, (const ST*)c_prev, (OT*)h_out, (OT*)c_out, n, C);
  return (int)cudaGetLastError();
}

template <typename GT, typename ST>
int launch_out(const void* gates, const void* c_prev, int out_bf16, void* h_out, void* c_out,
               long long n, int C, cudaStream_t st) {
  if (out_bf16) return launch<GT, ST, __nv_bfloat16>(gates, c_prev, h_out, c_out, n, C, st);
  return launch<GT, ST, float>(gates, c_prev, h_out, c_out, n, C, st);
}

template <typename GT>
int launch_state(const void* gates, const void* c_prev, int c_prev_bf16, int out_bf16,
                 void* h_out, void* c_out, long long n, int C, cudaStream_t st) {
  if (c_prev_bf16)
    return launch_out<GT, __nv_bfloat16>(gates, c_prev, out_bf16, h_out, c_out, n, C, st);
  return launch_out<GT, float>(gates, c_prev, out_bf16, h_out, c_out, n, C, st);
}

}  // namespace

// gates: (npix, 4C) float32 or bfloat16 (gates_bf16 != 0); c_prev: (npix, C)
// float32 or bfloat16 (c_prev_bf16 != 0); h_out, c_out: (npix, C) float32 or
// bfloat16 (out_bf16 != 0).  All contiguous.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int eigen_lstm_gates(const void* gates, int gates_bf16, const void* c_prev,
                                int c_prev_bf16, void* h_out, void* c_out, int out_bf16,
                                long long npix, int C, void* stream) {
  const long long n = npix * (long long)C;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (gates_bf16)
    return launch_state<__nv_bfloat16>(gates, c_prev, c_prev_bf16, out_bf16, h_out, c_out, n, C,
                                       st);
  return launch_state<float>(gates, c_prev, c_prev_bf16, out_bf16, h_out, c_out, n, C, st);
}
