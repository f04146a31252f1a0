// ConvLSTM cell update after the gate convolution.
//
// Replaces evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py
// ::fused_lstm_gates (Pallas body _gates_kernel).  Gate order [i, f, o, g]:
//   c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),  h = sigmoid(o) * tanh(c)
//
// Bound on the H100: bytes.  Per pixel and channel it reads 4 float32 gates
// and one state value and writes two float32 values (~26 bytes) for a few
// dozen operations, far below the ~295 operations per byte where compute
// would start to matter.  Design: one thread per (pixel, channel) in a
// grid-stride loop, reading each operand once and writing h and c once — no
// intermediate touches device memory.  The four gate loads of a thread are
// C floats apart; neighbouring threads take neighbouring channels, so each
// of the five loads and two stores is coalesced across the warp.

#include "common.cuh"

namespace {

template <typename CT>
__global__ void lstm_gates_kernel(const float* __restrict__ gates,
                                  const CT* __restrict__ c_prev,
                                  float* __restrict__ h_out,
                                  float* __restrict__ c_out,
                                  long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const long long p = idx / C;
    const int ch = (int)(idx - p * C);
    const float* g = gates + p * 4 * C + ch;
    const float i = eigen::sigmoid(g[0]);
    const float f = eigen::sigmoid(g[C]);
    const float o = eigen::sigmoid(g[2 * C]);
    const float gg = tanhf(g[3 * C]);
    const float c = f * eigen::to_float(c_prev[idx]) + i * gg;
    c_out[idx] = c;
    h_out[idx] = o * tanhf(c);
  }
}

}  // namespace

// gates: (npix, 4C) float32; c_prev: (npix, C) float32 or bfloat16
// (c_prev_bf16 != 0); h_out, c_out: (npix, C) float32.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int eigen_lstm_gates(const void* gates, const void* c_prev, int c_prev_bf16,
                                void* h_out, void* c_out, long long npix, int C,
                                void* stream) {
  const long long n = npix * (long long)C;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  cudaStream_t st = (cudaStream_t)stream;
  if (c_prev_bf16) {
    lstm_gates_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)gates, (const __nv_bfloat16*)c_prev, (float*)h_out,
        (float*)c_out, n, C);
  } else {
    lstm_gates_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)gates, (const float*)c_prev, (float*)h_out, (float*)c_out, n,
        C);
  }
  return (int)cudaGetLastError();
}
