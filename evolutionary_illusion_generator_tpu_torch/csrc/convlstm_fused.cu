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
// bfloat16 tensor cores stop waiting on memory.  So the products run on the
// tensor cores: mma.sync.m16n8k16, bfloat16 in, float32 sums.
//
// Design.  The gate convolution is an implicit GEMM: M = output pixels,
// N = 4C gate outputs, K = 9 taps x the sources' channels.  A block owns
// TM = 128 pixels and a group of 16 channels with all four gates (N = 64),
// so the epilogue needs nothing from another block and h and c are written
// once.  It walks K chunk by chunk, 16 input channels of one source at a
// time (one k16 step per tap), the sources one after another.  Per chunk,
// with cp.async two chunks deep and one barrier a chunk, it stages the
// 9 x 64 x 16 weight slice (layout (9, C, 4, Cin)) and the halo slab of the
// block's pixels, read in place from the unpadded source: the SAME padding
// and the ragged channel edge are the zero-filling src-size-0 form of
// cp.async, so no padded copy is made (eigen::igemm::conv3x3 in common.cuh,
// which csrc/convlstm_narrow.cu shares).
// Which 128 pixels a block owns is the tile mapping, chosen per layer by
// the wrapper: the image columns are cut into strips `tw` wide, and each
// strip's pixels are taken in (image, row, column) order over all images
// of the batch, 128 at a time.  tw = 16 gives 8 x 16 tiles; tw = W gives
// 128 consecutive pixels of the flattened batch, so a 15 x 20 image wastes
// no pixels on a tile edge.  A tile may cross from one image into the next;
// a tap whose row lies outside the pixel's own image reads a zero row.
// The slab covers the tile's rows plus one above and below, tw + 2 wide.
// Eight warps split the block 4 x 2: each computes 32 pixels x 32 outputs
// (2 x 4 mma tiles) with ldmatrix fragment loads.
//
// Accumulation.  The tensor cores' float32 sums round less exactly than an
// FMA chain: over one accumulator chain of 9 x Cin / 16 mma (up to 324 at
// layer 3) c drifts several times further from float64 sums than the plain
// float32 version does, enough to flip h's bfloat16 rounding on over 1% of
// a layer's elements against the CPU.  So each chunk's 9 mma go into fresh
// registers, which are then added to float32 totals with ordinary rounded
// adds; that is at least as accurate as the plain version (chip_smoke.py
// checks it).  After the last chunk the totals go through shared memory,
// so that one thread holds the four gates of a (pixel, channel).

#include "common.cuh"

namespace {

using eigen::igemm::MAX_SOURCES;
using eigen::igemm::MT;
using eigen::igemm::TM;
using eigen::igemm::WARPS_M;

constexpr int CG = 16;        // channels per block
constexpr int NOUT = 4 * CG;  // gate outputs per block, n = 4 * (c - c0) + gate
constexpr int WARPS_N = 2;
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int NTW = NOUT / 8 / WARPS_N;   // n8 tiles per warp
constexpr int EP = NOUT + 4;              // epilogue row of floats

struct Params {
  eigen::igemm::Source src[MAX_SOURCES];
  int n_chunks;  // over all sources
  eigen::igemm::Tiling t;
  const float* bias;
  const void* c_prev;
  void* h_out;
  float* c_out;
};

template <typename ST>
__global__ void __launch_bounds__(NT) convlstm_fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int c0 = blockIdx.y * CG;
  const eigen::igemm::Tiling& t = p.t;
  const eigen::igemm::Block blk = eigen::igemm::block_tile(t);

  float acc[MT][NTW][4], tot[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = tot[mt][nt][i] = 0.0f;

  auto chunk_done = [&](int) {  // the chunk's sums into the totals (see Accumulation)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[mt][nt][i] += acc[mt][nt][i], acc[mt][nt][i] = 0.0f;
  };
  eigen::igemm::conv3x3<NOUT, NT, NTW, false>(smem, p.src, p.n_chunks, t, blk, c0, acc, [] {},
                                              chunk_done);
  __syncthreads();  // the epilogue reuses the stages

  // D fragment: rows = pixels gid, gid + 8; columns = outputs 2 tig (+1)
  float* ep = reinterpret_cast<float*>(smem);  // [TM][EP]; the stages are done
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wm * MT + mt) * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = (wn * NTW + nt) * 8 + 2 * tig;
      ep[m * EP + n] = tot[mt][nt][0];
      ep[m * EP + n + 1] = tot[mt][nt][1];
      ep[(m + 8) * EP + n] = tot[mt][nt][2];
      ep[(m + 8) * EP + n + 1] = tot[mt][nt][3];
    }
  }
  __syncthreads();
  const ST* c_prev = static_cast<const ST*>(p.c_prev);
  ST* h_out = static_cast<ST*>(p.h_out);
  for (int i = tid; i < TM * CG; i += NT) {
    const int cl = i % CG, m = i / CG;
    const int q = blk.q0 + m, c = c0 + cl;
    const int row = q / t.tw, x = blk.x0 + q % t.tw;
    if (row >= t.rows || x >= t.W || c >= t.C) continue;
    const float* gv = ep + m * EP + 4 * cl;
    const float gi = gv[0] + p.bias[c];
    const float gf = gv[1] + p.bias[t.C + c];
    const float go = gv[2] + p.bias[2 * t.C + c];
    const float gg = gv[3] + p.bias[3 * t.C + c];
    const long long o = ((long long)row * t.W + x) * t.C + c;
    const float cn =
        eigen::sigmoid(gf) * eigen::to_float(c_prev[o]) + eigen::sigmoid(gi) * tanhf(gg);
    p.c_out[o] = cn;
    h_out[o] = eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn));
  }
}

}  // namespace

// x_s: (B, H, W, cin_s) bfloat16; w_s: (9, C, 4, cin_s) bfloat16, for
// s < n_src (1..3); bias: (4C,) float32; c_prev and h_out: (B, H, W, C) in
// float32 or bfloat16 (state_bf16 != 0); c_out: (B, H, W, C) float32.  All
// contiguous.  tw: the strip width of the tile mapping, 1..W.  Launches on
// `stream` and returns the CUDA error of the launch.
extern "C" int eigen_convlstm_fused(const void* x0, const void* w0, int cin0,
                                    const void* x1, const void* w1, int cin1,
                                    const void* x2, const void* w2, int cin2,
                                    int n_src, const void* bias, const void* c_prev,
                                    int state_bf16, void* h_out, void* c_out, int B,
                                    int H, int W, int C, int tw, void* stream) {
  if (n_src < 1 || n_src > MAX_SOURCES || tw < 1 || tw > W) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  Params p{};
  const void* xs[MAX_SOURCES] = {x0, x1, x2};
  const void* wts[MAX_SOURCES] = {w0, w1, w2};
  const int cins[MAX_SOURCES] = {cin0, cin1, cin2};
  if (!eigen::igemm::make_sources(p.src, p.n_chunks, xs, wts, cins, n_src, MAX_SOURCES))
    return (int)cudaErrorInvalidValue;
  p.t = eigen::igemm::make_tiling(B, H, W, C, tw);
  p.bias = (const float*)bias;
  p.c_prev = c_prev;
  p.h_out = h_out;
  p.c_out = (float*)c_out;
  const int bytes = eigen::igemm::smem_bytes(p.t, NOUT, EP);
  const dim3 grid((unsigned)eigen::igemm::pixel_blocks(p.t), (unsigned)((C + CG - 1) / CG));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc;
  if (state_bf16) {
    rc = cudaFuncSetAttribute(convlstm_fused_kernel<__nv_bfloat16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    convlstm_fused_kernel<__nv_bfloat16><<<grid, NT, bytes, st>>>(p);
  } else {
    rc = cudaFuncSetAttribute(convlstm_fused_kernel<float>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    convlstm_fused_kernel<float><<<grid, NT, bytes, st>>>(p);
  }
  return (int)cudaGetLastError();
}
