// The PredNet A and Ahat units of one layer, each in one pass:
//   ahat_error_unit_kernel: Ahat = SatLU (layer 0) or ReLU of conv(R) + b;
//     E = [ReLU(Ahat - A); ReLU(A - Ahat)], and at layer 0 the float32
//     prediction Ahat;
//   a_unit_kernel: A_next = maxpool2(ReLU(conv(E) + b)), only the pooled
//     values leaving the block.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses each chain (evolutionary_illusion_generator_tpu/models/prednet/
// model.py, prednet_step after the ConvLSTM updates).  The port ran each as
// a cuDNN bfloat16 conv and five to seven eager kernels (bias, activation,
// two subtractions and their ReLUs, the concatenation; ReLU and max-pool).
// cuDNN picks its algorithm by shape, so the same row was summed in another
// order at batch 8 than at batch 16: these kernels sum every output pixel
// in one order whatever the batch, the tile or the launch, which makes the
// sharded evaluator's rows the unsharded pass's bit for bit.
//
// Math: exactly the plain route's (ops/prednet_units.py).  The 3x3 SAME conv
// of bfloat16 inputs and weights sums the products in float32 and is rounded
// to the compute type (CT: float32 or bfloat16); then + b rounded to CT, the
// activation, and for Ahat the two differences rounded to CT, each through
// ReLU, written in the state type (ST).  ReLU, the clamp and the max keep a
// NaN, as torch's do.
//
// Bound on the H100: bytes at every layer of the main path and the north
// star but the north star's layer-1 and layer-2 A convs, which are about
// even.  At the north star (25 x 480x640, 3,48,96,192) a step's seven units
// do 0.97 TFLOP of products (0.98 ms at 989 TFLOP/s) and move about 1.3 GB
// (0.39 ms at 3.35 TB/s); chip_smoke.py computes each launch's bound from
// its own shapes.
//
// Bodies: this file holds the units' mma.sync body and the pixel layer's
// direct body; csrc/prednet_units_wgmma.cu their wgmma and im2col bodies,
// which take bfloat16 compute wherever the TMA can address the input.
// ops/prednet_units.py::ahat_plan / a_plan pick one per launch from the
// layer's shape and types alone.  Here the float32 compute type (Kahan sums
// per tap take 1.5 N registers a thread, too many for wgmma's N), channel
// counts that are not a multiple of 8, and the pixel layer's Ahat unit.
//
// Design: the implicit GEMM of csrc/convlstm_narrow.cu and the mma.sync body
// of csrc/convlstm_fused.cu, eigen::igemm::conv3x3 in common.cuh (mma.sync
// m16n8k16 from ldmatrix fragments, bfloat16 in, float32 sums; a block owns
// TM = 128 pixels of one strip of the tile mapping; per chunk of 16 input
// channels the 9 taps' weight slice and the halo slab are staged with
// cp.async two chunks deep, zero-filled for the SAME padding and the ragged
// channel edge, element by element where the channels are not a multiple of
// 8, as at the pixel layer).  The weights are read as that loop reads gate
// weights, (9, Cp / 4, 4, Cin) with output n = 4 (n / 4) + n % 4: the
// (9, Cp, Cin) layout, Cout padded to Cp, a multiple of 4, with zeros.  A
// block owns NOUT = 16 outputs (Cout <= 16) or 64 (grid.y = ceil(Cout / 64)
// groups).  Every shape takes the tensor cores but the pixel layer's Ahat
// unit (C <= DIRECT_MAX_C: 3 colour or 1 grey channel, 9 C^2 products a
// pixel, bound by bytes), which runs on the CUDA cores, one thread a pixel:
// each output's sum is one float32 chain in (ky, kx, ci) order, the order
// PyTorch's CPU conv sums in, so the float32 prediction is the CPU
// reference's bit for bit wherever that reference's own sums are (the
// tensor cores' dots round their 16-product sums otherwise, and moved the
// prediction's last bit on 5% of its entries).
//   - Sums (as the narrow kernel's): in bfloat16 compute a chunk's 9 taps
//     are chained in one accumulator and added to the float32 total; in
//     float32 compute each tap's 16-product sums go into fresh registers
//     and are added to the total by compensated (Kahan) summation.  Either
//     way the order is chunk, tap, then the mma's 16 products: fixed per
//     pixel.
//   - The Ahat unit tiles the batch's rows as one (the narrow kernel's
//     tiling); its epilogue reads A and writes E, and at layer 0 the
//     prediction, one thread per (pixel, output).
//   - The A unit tiles each image on its own (grid.z = the image) with an
//     even strip width tw that divides TM into an even number of rows
//     (4, 8, 16, 32 or 64): every tile starts on an even row and column of
//     its image, so each 2x2 pooling quad lies inside one tile, and odd H
//     or W only leave the last row or column unpooled, as F.max_pool2d
//     floors.  Its epilogue takes the max of each quad's four values.

#include <type_traits>

#include "common.cuh"

namespace {

using eigen::igemm::MAX_SOURCES;
using eigen::igemm::MT;
using eigen::igemm::TM;
using eigen::igemm::WARPS_M;

// NOUT outputs per block, split over WARPS_N warps of NTW n8 tiles
template <int NOUT>
struct Shape {
  static constexpr int WARPS_N = NOUT <= 32 ? 1 : NOUT / 32;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int NTW = NOUT / 8 / WARPS_N;
  static constexpr int EP = NOUT + 4;  // epilogue row of floats
};

struct Conv {
  eigen::igemm::Source src[MAX_SOURCES];  // the one source
  int n_chunks;
  eigen::igemm::Tiling t;  // t.C = Cp / 4: groups of four outputs
  int cout;
  const void* bias;  // (cout,) float32 or bfloat16
  int bias_bf16;
};

struct AhatParams {
  Conv conv;
  const void* a;   // (B, H, W, cout), compute type
  void* e_out;     // (B, H, W, 2 cout), state type
  float* pred_out; // (B, H, W, cout) or null
  int layer0;
};

struct AParams {
  Conv conv;       // t tiles one image: t.rows = H
  void* out;       // (B, H / 2, W / 2, cout), compute type
};

template <typename CT>
__device__ __forceinline__ float round_to(float v) {
  return eigen::to_float(eigen::from_float<CT>(v));
}
// torch.relu, clamp(0, 1) and max-pool keep a NaN
__device__ __forceinline__ float relu(float v) { return v > 0.0f || v != v ? v : 0.0f; }
__device__ __forceinline__ float satlu(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
__device__ __forceinline__ float max_nan(float a, float b) { return a != a || a > b ? a : b; }

// The block's conv for outputs n0 .. n0 + NOUT: the sums rounded to CT, + the
// bias rounded to CT, into the epilogue rows ep[m][n] (the shared memory of
// the stages, reused), synced for every thread.
template <int NOUT, typename CT>
__device__ __forceinline__ void unit_conv(unsigned char* smem, const Conv& p,
                                          const eigen::igemm::Source (&src)[MAX_SOURCES],
                                          const eigen::igemm::Block& blk, int n0) {
  using S = Shape<NOUT>;
  constexpr int NT = S::NT, NTW = S::NTW, EP = S::EP;
  constexpr bool kKahan = std::is_same<CT, float>::value;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // the bias of the thread's D fragment columns, cast to the compute type
  float bias[NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + (wn * NTW + nt) * 8 + 2 * tig + j;
      bias[nt][j] = 0.0f;
      if (n < p.cout)
        bias[nt][j] = round_to<CT>(
            p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[n])
                        : static_cast<const float*>(p.bias)[n]);
    }

  // acc: the tap's (or chunk's) sums; tot, comp: the totals and the
  // low-order part tot has lost (Kahan)
  float acc[MT][NTW][4], tot[MT][NTW][4], comp[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = tot[mt][nt][i] = comp[mt][nt][i] = 0.0f;

  auto tap_done = [&] {
    if (kKahan) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float y = acc[mt][nt][i] - comp[mt][nt][i];
            const float s = tot[mt][nt][i] + y;
            comp[mt][nt][i] = (s - tot[mt][nt][i]) - y;
            tot[mt][nt][i] = s;
            acc[mt][nt][i] = 0.0f;
          }
    }
  };
  auto chunk_done = [&](int) {
    if (!kKahan) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[mt][nt][i] += acc[mt][nt][i], acc[mt][nt][i] = 0.0f;
    }
  };
  eigen::igemm::conv3x3<NOUT, NT, NTW, false>(smem, src, p.n_chunks, p.t, blk, n0 / 4, acc,
                                              tap_done, chunk_done);
  __syncthreads();  // the epilogue reuses the stages

  // D fragment: rows = pixels gid, gid + 8; columns = outputs 2 tig (+1)
  float* ep = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wm * MT + mt) * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = (wn * NTW + nt) * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m + 8 * (i >> 1), col = n + (i & 1);
        ep[row * EP + col] =
            round_to<CT>(round_to<CT>(tot[mt][nt][i] - comp[mt][nt][i]) + bias[nt][i & 1]);
      }
    }
  }
  __syncthreads();
}

// The Ahat unit's outputs of pixel px, channel c from v = round(round(sum)
// + b): the activation, E's two halves and the prediction.
template <typename CT, typename ST>
__device__ __forceinline__ void ahat_epilogue(const AhatParams& p, long long px, int c, int C,
                                              float v) {
  const float ahat = p.layer0 ? satlu(v) : relu(v);
  const float av = eigen::to_float(static_cast<const CT*>(p.a)[px * C + c]);
  ST* e = static_cast<ST*>(p.e_out);
  e[px * 2 * C + c] = eigen::from_float<ST>(relu(round_to<CT>(ahat - av)));
  e[px * 2 * C + C + c] = eigen::from_float<ST>(relu(round_to<CT>(av - ahat)));
  if (p.pred_out != nullptr) p.pred_out[px * C + c] = ahat;
}

template <int NOUT, typename CT, typename ST>
__global__ void __launch_bounds__(Shape<NOUT>::NT) ahat_error_unit_kernel(AhatParams p) {
  using S = Shape<NOUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const eigen::igemm::Tiling& t = p.conv.t;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);
  const int n0 = blockIdx.y * NOUT;
  unit_conv<NOUT, CT>(smem, p.conv, p.conv.src, blk, n0);

  const float* ep = reinterpret_cast<const float*>(smem);
  const int C = p.conv.cout;
  for (int i = threadIdx.x; i < TM * NOUT; i += S::NT) {
    const int n = i % NOUT, m = i / NOUT, c = n0 + n;
    const int q = blk.q0 + m;
    const int row = q / t.tw, x = blk.x0 + q % t.tw;
    if (row >= t.rows || x >= t.W || c >= C) continue;
    ahat_epilogue<CT, ST>(p, (long long)row * t.W + x, c, C, ep[m * S::EP + n]);
  }
}

// The pixel layer's Ahat unit on the CUDA cores (C = cin = cout <=
// DIRECT_MAX_C): one thread a pixel of the batch, its C sums each a float32
// chain of fused multiply-adds in (ky, kx, ci) order (each bfloat16 product
// exact in float32), taps outside the image skipped (they add zeros).
constexpr int DIRECT_MAX_C = 4;
constexpr int DIRECT_THREADS = 256;

template <int C, typename CT, typename ST>
__global__ void __launch_bounds__(DIRECT_THREADS) ahat_error_unit_kernel_direct(AhatParams p) {
  __shared__ float w[9][C][C];  // [tap][out][in]
  __shared__ float bias[C];
  const __nv_bfloat16* wk = p.conv.src[0].w;
  const int cp = 4 * p.conv.t.C;
  for (int i = threadIdx.x; i < 9 * C * C; i += DIRECT_THREADS)
    w[i / (C * C)][i / C % C][i % C] = __bfloat162float(wk[(i / (C * C) * cp + i / C % C) * C +
                                                          i % C]);
  if (threadIdx.x < C)
    bias[threadIdx.x] = round_to<CT>(
        p.conv.bias_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.conv.bias)[threadIdx.x])
            : static_cast<const float*>(p.conv.bias)[threadIdx.x]);
  __syncthreads();

  const __nv_bfloat16* x = p.conv.src[0].x;
  const int H = p.conv.t.H, W = p.conv.t.W;
  const long long px = (long long)blockIdx.x * DIRECT_THREADS + threadIdx.x;
  if (px >= (long long)p.conv.t.rows * W) return;
  const int col = (int)(px % W), y = (int)(px / W % H);
  float acc[C];
#pragma unroll
  for (int n = 0; n < C; ++n) acc[n] = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    if (y + ky - 1 < 0 || y + ky - 1 >= H) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      if (col + kx - 1 < 0 || col + kx - 1 >= W) continue;
      const __nv_bfloat16* xp = x + (px + (long long)(ky - 1) * W + (kx - 1)) * C;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float xv = __bfloat162float(xp[ci]);
#pragma unroll
        for (int n = 0; n < C; ++n) acc[n] = __fmaf_rn(xv, w[ky * 3 + kx][n][ci], acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < C; ++n)
    ahat_epilogue<CT, ST>(p, px, n, C, round_to<CT>(round_to<CT>(acc[n]) + bias[n]));
}

template <int NOUT, typename CT>
__global__ void __launch_bounds__(Shape<NOUT>::NT) a_unit_kernel(AParams p) {
  using S = Shape<NOUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const eigen::igemm::Tiling& t = p.conv.t;
  // the image of blockIdx.z: its rows are the tiling's
  eigen::igemm::Source src[MAX_SOURCES] = {p.conv.src[0], p.conv.src[1], p.conv.src[2]};
  src[0].x += (long long)blockIdx.z * t.rows * t.W * src[0].cin;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);
  const int n0 = blockIdx.y * NOUT;
  unit_conv<NOUT, CT>(smem, p.conv, src, blk, n0);

  // the tile is TM / tw whole rows (an even count) from row r0 (even), tw
  // columns from x0 (even): quad (pr, pc) is tile pixels m, m + 1, m + tw,
  // m + tw + 1 with m = 2 pr tw + 2 pc
  const float* ep = reinterpret_cast<const float*>(smem);
  const int C = p.conv.cout, half = t.tw / 2;
  const int H2 = t.rows / 2, W2 = t.W / 2;
  CT* out = static_cast<CT*>(p.out) + (long long)blockIdx.z * H2 * W2 * C;
  for (int i = threadIdx.x; i < (TM / 4) * NOUT; i += S::NT) {
    const int n = i % NOUT, quad = i / NOUT, c = n0 + n;
    const int pr = quad / half, pc = quad % half;
    const int y2 = blk.r0 / 2 + pr, x2 = blk.x0 / 2 + pc;
    if (y2 >= H2 || x2 >= W2 || c >= C) continue;
    const int m = 2 * pr * t.tw + 2 * pc;
    const float v = max_nan(max_nan(ep[m * S::EP + n], ep[(m + 1) * S::EP + n]),
                            max_nan(ep[(m + t.tw) * S::EP + n], ep[(m + t.tw + 1) * S::EP + n]));
    out[((long long)y2 * W2 + x2) * C + c] = eigen::from_float<CT>(relu(v));
  }
}

template <int NOUT, typename CT, typename ST>
int launch_ahat(const AhatParams& p, cudaStream_t st) {
  using S = Shape<NOUT>;
  const int bytes = eigen::igemm::smem_bytes(p.conv.t, NOUT, S::EP);
  const cudaError_t rc = cudaFuncSetAttribute(ahat_error_unit_kernel<NOUT, CT, ST>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)eigen::igemm::pixel_blocks(p.conv.t),
                  (unsigned)((p.conv.cout + NOUT - 1) / NOUT));
  ahat_error_unit_kernel<NOUT, CT, ST><<<grid, S::NT, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int C, typename CT, typename ST>
int launch_ahat_direct(const AhatParams& p, cudaStream_t st) {
  const long long n = (long long)p.conv.t.rows * p.conv.t.W;
  const dim3 grid((unsigned)((n + DIRECT_THREADS - 1) / DIRECT_THREADS));
  ahat_error_unit_kernel_direct<C, CT, ST><<<grid, DIRECT_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename CT, typename ST>
int launch_ahat_direct_c(const AhatParams& p, cudaStream_t st) {
  switch (p.conv.cout) {
    case 1: return launch_ahat_direct<1, CT, ST>(p, st);
    case 2: return launch_ahat_direct<2, CT, ST>(p, st);
    case 3: return launch_ahat_direct<3, CT, ST>(p, st);
    default: return launch_ahat_direct<4, CT, ST>(p, st);
  }
}

int launch_ahat_direct_types(const AhatParams& p, int compute_bf16, int state_bf16,
                             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (compute_bf16)
    return state_bf16 ? launch_ahat_direct_c<bf16, bf16>(p, st)
                      : launch_ahat_direct_c<bf16, float>(p, st);
  return state_bf16 ? launch_ahat_direct_c<float, bf16>(p, st)
                    : launch_ahat_direct_c<float, float>(p, st);
}

template <int NOUT>
int launch_ahat_types(const AhatParams& p, int compute_bf16, int state_bf16, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (compute_bf16)
    return state_bf16 ? launch_ahat<NOUT, bf16, bf16>(p, st)
                      : launch_ahat<NOUT, bf16, float>(p, st);
  return state_bf16 ? launch_ahat<NOUT, float, bf16>(p, st)
                    : launch_ahat<NOUT, float, float>(p, st);
}

template <int NOUT, typename CT>
int launch_a(const AParams& p, int B, cudaStream_t st) {
  using S = Shape<NOUT>;
  const int bytes = eigen::igemm::smem_bytes(p.conv.t, NOUT, S::EP);
  const cudaError_t rc = cudaFuncSetAttribute(a_unit_kernel<NOUT, CT>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)eigen::igemm::pixel_blocks(p.conv.t),
                  (unsigned)((p.conv.cout + NOUT - 1) / NOUT), (unsigned)B);
  a_unit_kernel<NOUT, CT><<<grid, S::NT, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int NOUT>
int launch_a_types(const AParams& p, int compute_bf16, int B, cudaStream_t st) {
  return compute_bf16 ? launch_a<NOUT, __nv_bfloat16>(p, B, st) : launch_a<NOUT, float>(p, B, st);
}

// The conv's source and tiling: x (rows, W, cin) bfloat16, w (9, Cp, cin)
// bfloat16 with Cp = cout rounded up to a multiple of 4.
bool make_conv(Conv& c, const void* x, const void* w, int cin, int cout, const void* bias,
               int bias_bf16, int B, int H, int W, int tw) {
  const void* xs[MAX_SOURCES] = {x, nullptr, nullptr};
  const void* ws[MAX_SOURCES] = {w, nullptr, nullptr};
  const int cins[MAX_SOURCES] = {cin, 0, 0};
  c.n_chunks = 0;
  if (cout < 1 || !eigen::igemm::make_sources(c.src, c.n_chunks, xs, ws, cins, 1, MAX_SOURCES))
    return false;
  c.t = eigen::igemm::make_tiling(B, H, W, (cout + 3) / 4, tw);
  c.cout = cout;
  c.bias = bias;
  c.bias_bf16 = bias_bf16;
  return true;
}

}  // namespace

// The Ahat and error units of one layer.  x (R): (B, H, W, cin) bfloat16,
// cin = cout; w (9, Cp, cin) bfloat16; bias (cout,) float32 or bfloat16
// (bias_bf16 != 0); a (A): (B, H, W, cout) in the compute type (bfloat16
// when compute_bf16 != 0, else float32); e_out (E): (B, H, W, 2 cout) in the
// state type (bfloat16 when state_bf16 != 0, else float32); pred_out:
// (B, H, W, cout) float32 or null.  layer0 != 0: SatLU, else ReLU.  All
// contiguous.  tw: the strip width of the tile mapping, 1..W (unused where
// cout <= DIRECT_MAX_C: one thread a pixel).  Launches on `stream` and
// returns the CUDA error of the launch.
extern "C" int eigen_ahat_error_unit(const void* x, const void* w, int cin, int cout,
                                     const void* bias, int bias_bf16, const void* a, void* e_out,
                                     void* pred_out, int layer0, int compute_bf16,
                                     int state_bf16, int B, int H, int W, int tw, void* stream) {
  if (B < 0 || H < 0 || W < 0 || cin != cout) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  if (tw < 1 || tw > W) return (int)cudaErrorInvalidValue;
  AhatParams p{};
  if (!make_conv(p.conv, x, w, cin, cout, bias, bias_bf16, B, H, W, tw))
    return (int)cudaErrorInvalidValue;
  p.a = a;
  p.e_out = e_out;
  p.pred_out = static_cast<float*>(pred_out);
  p.layer0 = layer0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cout <= DIRECT_MAX_C)
    return launch_ahat_direct_types(p, compute_bf16, state_bf16, st);
  if (cout <= 16) return launch_ahat_types<16>(p, compute_bf16, state_bf16, st);
  return launch_ahat_types<64>(p, compute_bf16, state_bf16, st);
}

// The A unit of one layer.  x (E): (B, H, W, cin) bfloat16; w (9, Cp, cin)
// bfloat16; bias (cout,) float32 or bfloat16; out: (B, H / 2, W / 2, cout)
// in the compute type.  tw: an even strip width with TM / tw even (4, 8, 16,
// 32 or 64; it may exceed W).  Launches on `stream` and returns the CUDA
// error of the launch.
extern "C" int eigen_a_unit(const void* x, const void* w, int cin, int cout, const void* bias,
                            int bias_bf16, void* out, int compute_bf16, int B, int H, int W,
                            int tw, void* stream) {
  if (B < 0 || H < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (tw < 2 || tw % 2 || TM % (2 * tw)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H < 2 || W < 2) return (int)cudaSuccess;
  AParams p{};
  if (!make_conv(p.conv, x, w, cin, cout, bias, bias_bf16, 1, H, W, tw))
    return (int)cudaErrorInvalidValue;
  p.out = out;
  cudaStream_t st = (cudaStream_t)stream;
  if (cout <= 16) return launch_a_types<16>(p, compute_bf16, B, st);
  return launch_a_types<64>(p, compute_bf16, B, st);
}
