// One ConvLSTM layer update in one pass: the 3x3 SAME gate convolution over
// up to three sources, the bias, the gate nonlinearities and the cell update.
//
// Replaces evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py
// ::fused_convlstm_layer (one concatenated source, Pallas body _kernel) and
// ::fused_convlstm_layer_multi (separate E / R / upsampled-R_above sources,
// Pallas body _kernel_multi).  Both wrappers in ops/convlstm_fused.py launch
// this one kernel.
//
// Math: sources and weights are bfloat16, products accumulate in float32,
// the gates and the cell state are float32; h is written in the state's type
// and c in float32 (the Pallas kernels' contract).  Gate order [i, f, o, g].
//
// Bound on the H100: operations.  At the main path's layer-1 shape
// (Cin 240, 4C 192) a pixel needs 9 * 240 * 192 * 2 = 829k operations for
// about 1 KB moved, far above the ~295 operations per byte where the
// bfloat16 tensor cores stop waiting on memory.  This first version does the
// products as float32 FMAs on the CUDA cores, so it sits well above that
// bound; tensor cores (mma.sync / wgmma), TMA and reading R_above at
// (y/2, x/2) instead of an upsampled copy are later work.
//
// Design: a block owns an 8 x 16 tile of output pixels of one image and a
// group of 16 channels, and accumulates all four gates of each of them, so
// the epilogue needs nothing from another block and h and c are written
// once.  Per source and per round of 8 input channels it stages the halo'd
// (10 x 18) input tile and the matching 9 x 8 x 64 weight slice in shared
// memory as float32.  Each thread then holds 4 pixels x 2 channels x 4 gates
// in registers; a warp shares one weight row (a broadcast read) and its
// lanes read neighbouring pixels.  The concatenated input of the Pallas
// single-source kernel and its halo window stack are never built: every
// source is read in place.

#include "common.cuh"

namespace {

constexpr int TH = 8;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int CG = 16;   // channels per block (4 * CG gate outputs)
constexpr int KC = 8;    // input channels staged per round
constexpr int NT = 256;  // threads per block
constexpr int PPT = 4;   // pixels per thread
constexpr int CPT = 2;   // channels per thread, each with its four gates
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int NOUT = 4 * CG;

static_assert(TH * TW == 32 * PPT, "the lanes of a warp cover the tile's pixels");
static_assert((NT / 32) * CPT == CG, "the warps cover the channel group");

struct Source {
  const __nv_bfloat16* x;  // (B, H, W, cin)
  const __nv_bfloat16* w;  // (cin, 9, C, 4): [input channel][tap][channel][gate]
  int cin;
};

struct Sources {
  Source s[3];
  int n;
};

template <typename ST>
__global__ void __launch_bounds__(NT)
    convlstm_fused_kernel(Sources srcs, const float* __restrict__ bias,
                          const ST* __restrict__ c_prev, ST* __restrict__ h_out,
                          float* __restrict__ c_out, int H, int W, int C,
                          int tiles_x) {
  __shared__ float xs[KC][HALO_H][HALO_W];
  __shared__ __align__(16) float ws[9][KC][NOUT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cpair = tid >> 5;  // the thread's channels: c0 + CPT * cpair + q
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CG;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;

  // the thread's pixels: tile index lane + 32 j
  int py[PPT], px[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    py[j] = (lane + 32 * j) / TW;
    px[j] = (lane + 32 * j) % TW;
  }

  float acc[PPT][4 * CPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int n = 0; n < 4 * CPT; ++n) acc[j][n] = 0.0f;

  const long long img = (long long)b * H * W;  // first pixel of image b
  for (int s = 0; s < srcs.n; ++s) {
    const Source src = srcs.s[s];
    for (int k0 = 0; k0 < src.cin; k0 += KC) {
      __syncthreads();  // the previous round's reads of xs / ws are done
      for (int i = tid; i < KC * HALO_H * HALO_W; i += NT) {
        const int k = i % KC;
        const int r = i / KC;
        const int hx = r % HALO_W;
        const int hy = r / HALO_W;
        const int gy = y0 + hy - 1, gx = x0 + hx - 1, ci = k0 + k;
        float v = 0.0f;  // SAME padding and the ragged channel edge read zeros
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < src.cin)
          v = __bfloat162float(src.x[(img + (long long)gy * W + gx) * src.cin + ci]);
        xs[k][hy][hx] = v;
      }
      for (int i = tid; i < 9 * KC * NOUT; i += NT) {
        const int n = i % NOUT;  // (channel in group) * 4 + gate
        const int r = i / NOUT;
        const int tap = r % 9;
        const int k = r / 9;
        const int ci = k0 + k, c = c0 + (n >> 2);
        float v = 0.0f;
        if (ci < src.cin && c < C)
          v = __bfloat162float(src.w[(((long long)ci * 9 + tap) * C + c) * 4 + (n & 3)]);
        ws[tap][k][n] = v;
      }
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float4 wa = *reinterpret_cast<const float4*>(&ws[tap][k][cpair * 4 * CPT]);
          const float4 wb = *reinterpret_cast<const float4*>(&ws[tap][k][cpair * 4 * CPT + 4]);
          const float wv[4 * CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const float a = xs[k][py[j] + ky][px[j] + kx];
#pragma unroll
            for (int n = 0; n < 4 * CPT; ++n) acc[j][n] = fmaf(a, wv[n], acc[j][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = y0 + py[j], x = x0 + px[j];
    if (y >= H || x >= W) continue;
    const long long pix = img + (long long)y * W + x;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = c0 + cpair * CPT + q;
      if (c >= C) continue;
      const float gi = acc[j][4 * q + 0] + bias[c];
      const float gf = acc[j][4 * q + 1] + bias[C + c];
      const float go = acc[j][4 * q + 2] + bias[2 * C + c];
      const float gg = acc[j][4 * q + 3] + bias[3 * C + c];
      const long long o = pix * C + c;
      const float cn = eigen::sigmoid(gf) * eigen::to_float(c_prev[o]) +
                       eigen::sigmoid(gi) * tanhf(gg);
      c_out[o] = cn;
      h_out[o] = eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn));
    }
  }
}

}  // namespace

// x_s: (B, H, W, cin_s) bfloat16; w_s: (cin_s, 9, C, 4) bfloat16, for
// s < n_src (1..3); bias: (4C,) float32; c_prev and h_out: (B, H, W, C) in
// float32 or bfloat16 (state_bf16 != 0); c_out: (B, H, W, C) float32.  All
// contiguous.  Launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int eigen_convlstm_fused(const void* x0, const void* w0, int cin0,
                                    const void* x1, const void* w1, int cin1,
                                    const void* x2, const void* w2, int cin2,
                                    int n_src, const void* bias, const void* c_prev,
                                    int state_bf16, void* h_out, void* c_out, int B,
                                    int H, int W, int C, void* stream) {
  if (n_src < 1 || n_src > 3) return (int)cudaErrorInvalidValue;
  Sources srcs;
  srcs.s[0] = Source{(const __nv_bfloat16*)x0, (const __nv_bfloat16*)w0, cin0};
  srcs.s[1] = Source{(const __nv_bfloat16*)x1, (const __nv_bfloat16*)w1, cin1};
  srcs.s[2] = Source{(const __nv_bfloat16*)x2, (const __nv_bfloat16*)w2, cin2};
  srcs.n = n_src;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)((C + CG - 1) / CG),
                  (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (state_bf16) {
    convlstm_fused_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        srcs, (const float*)bias, (const __nv_bfloat16*)c_prev,
        (__nv_bfloat16*)h_out, (float*)c_out, H, W, C, tiles_x);
  } else {
    convlstm_fused_kernel<float><<<grid, NT, 0, st>>>(
        srcs, (const float*)bias, (const float*)c_prev, (float*)h_out,
        (float*)c_out, H, W, C, tiles_x);
  }
  return (int)cudaGetLastError();
}
