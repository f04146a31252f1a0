// One narrow ConvLSTM layer update (C < 32: the pixel layer, C = 3 or 1,
// and layer 1 of 1,16,32,64) in one pass: the gate convolution of E, R and
// the upsampled R_above, the bias, the gate nonlinearities and the cell
// update.  This is the narrow layer's mma.sync body: float32 compute and
// the widths csrc/convlstm_narrow_hopper.cu's persistent body does not take
// (ops/convlstm_narrow.py::narrow_plan picks the body).  The same sums with
// the gates written out (gate_convs_kernel, eigen_gate_convs) are the True
// route's gate convs on every layer (ops/convlstm_narrow.py::gate_convs):
// each pixel summed in one order whatever the batch, as cuDNN's convs,
// which they replace there, were not.
//
// Replaces no TPU kernel of its own: it is the redesign of this card's port
// of evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py
// ::fused_lstm_gates (csrc/lstm_gates.cu) on the narrow layers, folded into
// their gate convolution.  Before it, a narrow layer's step was an
// upsampled copy of R_above, three cuDNN convs, a bias and two adds, and
// the gate kernel; now it is this one launch.
//
// Math: exactly the narrow route's (the JAX use_pallas=True math of a
// narrow layer).  Each source's 3x3 SAME conv sums bfloat16 products in
// float32 and is rounded to the compute type (CT: float32 or bfloat16);
// then E's conv + bias, + R's, + R_above's, each add rounded to CT, in that
// order; then the gate math in float32 (expf / tanhf, gates [i, f, o, g])
// on the gates widened from CT, and h and c rounded to the state type (ST).
//
// Bound on the H100: bytes.  At the main path's step (8 x 120 x 160, C = 3,
// C_above = 48) it reads E, R, R_above at half resolution and c_prev, and
// writes h and c: about 9.2 MB, 2.75 us at 3.35 TB/s, against 1.9 GFLOP of
// products, 1.9 us on the bfloat16 tensor cores.  R_above is read where it
// lies, at (y / 2, x / 2) of layer 1's state, so the 14.7 MB upsampled copy
// the split convs needed is neither written nor read.
//
// Design: the implicit GEMM of csrc/convlstm_fused.cu, eigen::igemm::conv3x3
// in common.cuh (mma.sync.m16n8k16, bfloat16 in, float32 sums; a block owns
// TM = 128 pixels of one strip of the tile mapping; per chunk of 16 input
// channels of one source, the 9 taps' weight slice and the halo slab are
// staged with cp.async two chunks deep, zero-filled for the SAME padding
// and the ragged channel edge, or element by element where a source's
// channels are not a multiple of 8), with three differences:
//   - a block owns all 4C gate outputs, padded to NOUT = 16, 32, 64 or 128,
//     so the epilogue needs nothing from another block;
//   - each source keeps its own sums (Accumulation below), which are
//     rounded to CT and added into the running gates in registers when the
//     source's last chunk is done;
//   - the third source, R_above, is staged from (B, H/2, W/2, C_above):
//     row r of the batch's rows reads coarse row r / 2 (H is even, so that
//     is the image's own coarse row y / 2), column x reads x / 2.
// The weights are the fused kernel's (9, C, 4, Cin) layout, so output
// n = 4 c + gate, and one thread of the epilogue reads its four gates side
// by side.
//
// Accumulation.  In bfloat16 compute (the main path) a chunk's 9 taps are
// chained in one accumulator and added to the source's float32 total, as
// in the fused kernel: each source's sum is then rounded to 8 bits, far
// coarser than that accumulation's error.  In float32 compute the sums are
// kept: each mma's sum of 16 products goes into fresh registers, added to
// the source's total by compensated (Kahan) summation, so that the total
// carries little more than the tensor cores' own rounding of each mma's
// sum (toward zero).  The plain version's float32 conv (PyTorch's own:
// im2col and a GEMM of rounded FMAs) is the yardstick; on an H100 at the
// main path's shape, mean |c - c_float64| with the chained chunks
// 4.871e-08 against the plain version's 4.163e-08; fresh sums a tap and
// plain totals 4.182e-08 against 4.159e-08; compensated, 3.215e-08.  The
// compensated adds cost time (40 us a bfloat16 call with them, 58 us), so
// the bfloat16 route does without them.

#include <type_traits>

#include "common.cuh"

namespace {

using eigen::igemm::MAX_SOURCES;
using eigen::igemm::MT;
using eigen::igemm::TM;
using eigen::igemm::WARPS_M;

// NOUT gate outputs per block, split over WARPS_N warps of NTW n8 tiles
template <int NOUT>
struct Shape {
  static constexpr int WARPS_N = NOUT <= 32 ? 1 : NOUT / 32;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int NTW = NOUT / 8 / WARPS_N;
  static constexpr int EP = NOUT + 4;  // epilogue row of floats
};

struct Params {
  eigen::igemm::Source src[MAX_SOURCES];  // R_above (the third) coarse
  int n_chunks;  // over all sources
  eigen::igemm::Tiling t;
  const void* bias;  // (4C,) gate-major [i | f | o | g], float32 or bfloat16
  int bias_bf16;
  const void* c_prev;
  void* h_out;
  void* c_out;
};

// v rounded to the compute type, as a float
template <typename CT>
__device__ __forceinline__ float round_to(float v) {
  return eigen::to_float(eigen::from_float<CT>(v));
}

// The block's gates for channels c0 .. c0 + NOUT / 4 (the thread's D
// fragments, NTW n8 tiles of MT m16 tiles): each source's conv rounded to
// the compute type, E's + bias, + R's, + R_above's, each add rounded.
template <int NOUT, typename CT>
__device__ __forceinline__ void gate_sums(unsigned char* smem, const Params& p, int c0,
                                          float (&gates)[MT][Shape<NOUT>::NTW][4]) {
  using S = Shape<NOUT>;
  constexpr int NT = S::NT, NTW = S::NTW;
  constexpr bool kKahan = std::is_same<CT, float>::value;  // see Accumulation
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp / WARPS_M;
  const int tig = lane & 3;  // mma fragment column pair
  const eigen::igemm::Tiling& t = p.t;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);

  // the bias of the thread's D fragment columns n = 4 (c - c0) + gate (0
  // past C)
  float bias[NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = (wn * NTW + nt) * 8 + 2 * tig + j;
      const int c = c0 + (n >> 2);
      const int k = (n & 3) * t.C + c;
      bias[nt][j] = 0.0f;
      if (c < t.C)  // the bias cast to the compute type
        bias[nt][j] = round_to<CT>(
            p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[k])
                        : static_cast<const float*>(p.bias)[k]);
    }

  // acc: the tap's (or chunk's) sums; tot, comp: the source's, and the
  // low-order part tot has lost (Kahan)
  float acc[MT][NTW][4], tot[MT][NTW][4], comp[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[mt][nt][i] = tot[mt][nt][i] = comp[mt][nt][i] = gates[mt][nt][i] = 0.0f;

  auto tap_done = [&] {
    if (kKahan) {  // the tap's sums into the source's totals
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
  int si = 0, src_end = p.src[0].chunks;  // the source of chunk kc and its end
  auto chunk_done = [&](int kc) {
    if (!kKahan) {  // the chunk's sums into the source's totals
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[mt][nt][i] += acc[mt][nt][i], acc[mt][nt][i] = 0.0f;
    }
    if (kc + 1 == src_end) {
      // the source's conv is complete: rounded to the compute type, then
      // E's + bias, or the gates so far + this one, rounded again
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = round_to<CT>(tot[mt][nt][i] - comp[mt][nt][i]);
            gates[mt][nt][i] = round_to<CT>((si == 0 ? bias[nt][i & 1] : gates[mt][nt][i]) + v);
            tot[mt][nt][i] = comp[mt][nt][i] = 0.0f;
          }
      ++si;
      src_end += si == 1 ? p.src[1].chunks : p.src[2].chunks;
    }
  };
  eigen::igemm::conv3x3<NOUT, NT, NTW, true>(smem, p.src, p.n_chunks, t, blk, c0, acc, tap_done,
                                             chunk_done);
}

// the thread's D fragments into the epilogue's rows of floats: rows =
// pixels gid, gid + 8; columns = outputs 2 tig (+1)
template <int NOUT>
__device__ __forceinline__ void gates_to_smem(float* ep,
                                              const float (&gates)[MT][Shape<NOUT>::NTW][4]) {
  using S = Shape<NOUT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wm * MT + mt) * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < S::NTW; ++nt) {
      const int n = (wn * S::NTW + nt) * 8 + 2 * tig;
      ep[m * S::EP + n] = gates[mt][nt][0];
      ep[m * S::EP + n + 1] = gates[mt][nt][1];
      ep[(m + 8) * S::EP + n] = gates[mt][nt][2];
      ep[(m + 8) * S::EP + n + 1] = gates[mt][nt][3];
    }
  }
}

template <int NOUT, typename CT, typename ST>
__global__ void __launch_bounds__(Shape<NOUT>::NT) convlstm_narrow_kernel(Params p) {
  using S = Shape<NOUT>;
  constexpr int NT = S::NT, EP = S::EP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const eigen::igemm::Tiling& t = p.t;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);
  float gates[MT][S::NTW][4];
  gate_sums<NOUT, CT>(smem, p, 0, gates);
  __syncthreads();  // the epilogue reuses the stages

  float* ep = reinterpret_cast<float*>(smem);  // [TM][EP]; the stages are done
  gates_to_smem<NOUT>(ep, gates);
  __syncthreads();
  // the gate math of csrc/lstm_gates.cu, one thread per (pixel, channel)
  const ST* c_prev = static_cast<const ST*>(p.c_prev);
  ST* h_out = static_cast<ST*>(p.h_out);
  ST* c_out = static_cast<ST*>(p.c_out);
  for (int i = tid; i < TM * t.C; i += NT) {
    const int cl = i % t.C, m = i / t.C;
    const int q = blk.q0 + m;
    const int row = q / t.tw, x = blk.x0 + q % t.tw;
    if (row >= t.rows || x >= t.W) continue;
    const float* gv = ep + m * EP + 4 * cl;
    const float ig = eigen::sigmoid(gv[0]);
    const float fg = eigen::sigmoid(gv[1]);
    const float og = eigen::sigmoid(gv[2]);
    const float gg = tanhf(gv[3]);
    const long long o = ((long long)row * t.W + x) * t.C + cl;
    const float c = fg * eigen::to_float(c_prev[o]) + ig * gg;
    c_out[o] = eigen::from_float<ST>(c);
    h_out[o] = eigen::from_float<ST>(og * tanhf(c));
  }
}

// The True route's gate convs (ops/convlstm_narrow.py::gate_convs):
// gate_sums over the channel group blockIdx.y of NOUT / 4 channels, the
// gates written out gate-major ([i | f | o | g], C each) in the compute
// type, for csrc/lstm_gates.cu to read.
template <int NOUT, typename CT>
__global__ void __launch_bounds__(Shape<NOUT>::NT) gate_convs_kernel(Params p, CT* gates_out) {
  using S = Shape<NOUT>;
  constexpr int NT = S::NT, EP = S::EP, NC = NOUT / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const eigen::igemm::Tiling& t = p.t;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);
  const int c0 = blockIdx.y * NC;
  float gates[MT][S::NTW][4];
  gate_sums<NOUT, CT>(smem, p, c0, gates);
  __syncthreads();  // the gates reuse the stages

  float* ep = reinterpret_cast<float*>(smem);
  gates_to_smem<NOUT>(ep, gates);
  __syncthreads();
  // a pixel's gates of the group: four runs of nc channels, one a gate
  const int nc = min(NC, t.C - c0);
  for (int i = tid; i < TM * 4 * nc; i += NT) {
    const int m = i / (4 * nc), j = i % (4 * nc);
    const int gate = j / nc, cl = j % nc;
    const int q = blk.q0 + m;
    const int row = q / t.tw, x = blk.x0 + q % t.tw;
    if (row >= t.rows || x >= t.W) continue;
    gates_out[((long long)row * t.W + x) * 4 * t.C + gate * t.C + c0 + cl] =
        eigen::from_float<CT>(ep[m * EP + 4 * cl + gate]);
  }
}

template <int NOUT, typename CT, typename ST>
int launch(const Params& p, cudaStream_t st) {
  const int bytes = eigen::igemm::smem_bytes(p.t, NOUT, Shape<NOUT>::EP);
  const cudaError_t rc = cudaFuncSetAttribute(convlstm_narrow_kernel<NOUT, CT, ST>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  convlstm_narrow_kernel<NOUT, CT, ST>
      <<<eigen::igemm::pixel_blocks(p.t), Shape<NOUT>::NT, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int NOUT>
int launch_types(const Params& p, int compute_bf16, int state_bf16, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (compute_bf16)
    return state_bf16 ? launch<NOUT, bf16, bf16>(p, st) : launch<NOUT, bf16, float>(p, st);
  return state_bf16 ? launch<NOUT, float, bf16>(p, st) : launch<NOUT, float, float>(p, st);
}

template <int NOUT, typename CT>
int launch_gate_convs(const Params& p, int groups, void* gates_out, cudaStream_t st) {
  const int bytes = eigen::igemm::smem_bytes(p.t, NOUT, Shape<NOUT>::EP);
  const cudaError_t rc = cudaFuncSetAttribute(gate_convs_kernel<NOUT, CT>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  gate_convs_kernel<NOUT, CT><<<dim3(eigen::igemm::pixel_blocks(p.t), groups), Shape<NOUT>::NT,
                                bytes, st>>>(p, static_cast<CT*>(gates_out));
  return (int)cudaGetLastError();
}

template <int NOUT>
int launch_gate_types(const Params& p, int groups, int compute_bf16, void* gates_out,
                      cudaStream_t st) {
  return compute_bf16 ? launch_gate_convs<NOUT, __nv_bfloat16>(p, groups, gates_out, st)
                      : launch_gate_convs<NOUT, float>(p, groups, gates_out, st);
}

// the sources, tiling and bias of either entry; false on a bad argument
bool make_params(Params& p, const void* x0, const void* w0, int cin0, const void* x1,
                 const void* w1, int cin1, const void* x2, const void* w2, int cin2, int n_src,
                 const void* bias, int bias_bf16, int B, int H, int W, int C, int tw) {
  if (n_src < 2 || n_src > MAX_SOURCES || tw < 1 || tw > W || C < 1) return false;
  if (n_src == 3 && (H % 2 || W % 2)) return false;
  const void* xs[MAX_SOURCES] = {x0, x1, x2};
  const void* wts[MAX_SOURCES] = {w0, w1, w2};
  const int cins[MAX_SOURCES] = {cin0, cin1, cin2};
  if (!eigen::igemm::make_sources(p.src, p.n_chunks, xs, wts, cins, n_src, 2)) return false;
  p.t = eigen::igemm::make_tiling(B, H, W, C, tw);
  p.bias = bias;
  p.bias_bf16 = bias_bf16;
  return true;
}

}  // namespace

// x0 (E): (B, H, W, cin0); x1 (R): (B, H, W, cin1); x2 (R_above, n_src = 3
// only): (B, H/2, W/2, cin2), H and W even; all bfloat16, with weights w_s
// (9, C, 4, cin_s) bfloat16.  bias: (4C,) gate-major, float32 or bfloat16
// (bias_bf16 != 0), cast to the compute type (bfloat16 when compute_bf16 !=
// 0, else float32).  c_prev, h_out, c_out: (B, H, W, C) in the state type
// (bfloat16 when state_bf16 != 0, else float32).  C < 32.  All contiguous.
// tw: the strip width of the tile mapping, 1..W.  Launches on `stream` and
// returns the CUDA error of the launch.
extern "C" int eigen_convlstm_narrow(const void* x0, const void* w0, int cin0,
                                     const void* x1, const void* w1, int cin1,
                                     const void* x2, const void* w2, int cin2, int n_src,
                                     const void* bias, int bias_bf16, int compute_bf16,
                                     const void* c_prev,
                                     int state_bf16, void* h_out, void* c_out, int B, int H,
                                     int W, int C, int tw, void* stream) {
  if (C >= 32 || B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  Params p{};
  if (!make_params(p, x0, w0, cin0, x1, w1, cin1, x2, w2, cin2, n_src, bias, bias_bf16, B, H, W,
                   C, tw))
    return (int)cudaErrorInvalidValue;
  p.c_prev = c_prev;
  p.h_out = h_out;
  p.c_out = c_out;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 4 * C;
  if (n <= 16) return launch_types<16>(p, compute_bf16, state_bf16, st);
  if (n <= 32) return launch_types<32>(p, compute_bf16, state_bf16, st);
  if (n <= 64) return launch_types<64>(p, compute_bf16, state_bf16, st);
  return launch_types<128>(p, compute_bf16, state_bf16, st);
}

// The gate convs alone (the True route's), any C: sources, weights, bias
// and compute type as above; gates_out: (B, H, W, 4C) gate-major in the
// compute type.  C < 32: one block holds all 4C outputs; else channel
// groups of 32 (N 128) along the grid's second axis.  Launches on `stream`
// and returns the CUDA error of the launch.
extern "C" int eigen_gate_convs(const void* x0, const void* w0, int cin0, const void* x1,
                                const void* w1, int cin1, const void* x2, const void* w2,
                                int cin2, int n_src, const void* bias, int bias_bf16,
                                int compute_bf16, void* gates_out, int B, int H, int W, int C,
                                int tw, void* stream) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  Params p{};
  if (!make_params(p, x0, w0, cin0, x1, w1, cin1, x2, w2, cin2, n_src, bias, bias_bf16, B, H, W,
                   C, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 4 * C;
  if (n <= 16) return launch_gate_types<16>(p, 1, compute_bf16, gates_out, st);
  if (n <= 32) return launch_gate_types<32>(p, 1, compute_bf16, gates_out, st);
  if (n <= 64) return launch_gate_types<64>(p, 1, compute_bf16, gates_out, st);
  return launch_gate_types<128>(p, (C + 31) / 32, compute_bf16, gates_out, st);
}
