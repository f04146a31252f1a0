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
// with cp.async two chunks deep and one barrier a chunk:
//   - the 9 x 64 x 16 weight slice (layout (9, C, 4, Cin): a chunk of input
//     channels of one output is 32 contiguous bytes), its two 16-byte
//     halves swapped on every other group of four rows so that the 8 rows
//     of an ldmatrix fall in distinct banks;
//   - the halo slab of the block's pixels, read in place from the unpadded
//     source: the SAME padding and the ragged channel edge are the
//     zero-filling src-size-0 form of cp.async, so no padded copy is made.
//     Its rows are padded from 16 to 24 values (48 bytes) for the same
//     reason: a tap's 8 pixels are neighbours in the slab.
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

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 128;       // output pixels per block
constexpr int CG = 16;        // channels per block
constexpr int NOUT = 4 * CG;  // gate outputs per block, n = 4 * (c - c0) + gate
constexpr int KC = 16;        // input channels per chunk: one k16 step per tap
constexpr int KP = KC + 8;    // slab pixel row, padded to 48 bytes (bank spread)
constexpr int KW = KC;        // weight rows: 32 bytes, 16-byte halves swizzled
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int MT = TM / 16 / WARPS_M;     // m16 tiles per warp
constexpr int NTW = NOUT / 8 / WARPS_N;   // n8 tiles per warp
constexpr int STAGES = 2;                 // chunks in flight
constexpr int WS_ELEMS = 9 * NOUT * KW;   // bfloat16 per weight stage
constexpr int EP = NOUT + 4;              // epilogue row of floats
constexpr int MAX_SOURCES = 3;

static_assert(NTW % 2 == 0, "B fragments load two n8 tiles at a time");

struct Source {
  const __nv_bfloat16* x;  // (B, H, W, cin)
  const __nv_bfloat16* w;  // (9, C, 4, cin): [tap][channel][gate][input channel]
  int cin;
  int chunks;  // ceil(cin / KC)
  int vec;     // cin % 8 == 0 and x, w 16-byte aligned: stage with cp.async
};

struct Params {
  Source src[MAX_SOURCES];
  int n_chunks;  // over all sources
  const float* bias;
  const void* c_prev;
  void* h_out;
  float* c_out;
  int H, W, C;
  int rows;             // B * H: the batch's rows, image after image
  int tw;               // strip width
  int tiles_per_strip;  // ceil(rows * tw / TM)
  int slab_h, slab_w;   // halo slab: tile rows + 2, tw + 2
};

template <typename ST>
__global__ void __launch_bounds__(NT) convlstm_fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][9][NOUT][KW]
  __nv_bfloat16* xs = ws + STAGES * WS_ELEMS;                    // [STAGES][slab_h][slab_w][KP]
  const int slab_px = p.slab_h * p.slab_w;
  __nv_bfloat16* zero_px = xs + STAGES * slab_px * KP;           // one pixel of zeros

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int c0 = blockIdx.y * CG;
  const int strip = blockIdx.x / p.tiles_per_strip;
  const int q0 = (blockIdx.x % p.tiles_per_strip) * TM;  // first pixel of the tile in its strip
  const int x0 = strip * p.tw;
  const int r0 = q0 / p.tw;  // the tile's first row; the slab starts one above
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  if (tid < KP) zero_px[tid] = zero;

  auto stage = [&](int s, int kc) {
    // chunk kc -> (source, chunk of that source); selects, not an indexed
    // read of the parameter struct
    int si = 0;
    if (kc >= p.src[0].chunks) kc -= p.src[0].chunks, si = 1;
    if (si == 1 && kc >= p.src[1].chunks) kc -= p.src[1].chunks, si = 2;
    const Source src = si == 0 ? p.src[0] : (si == 1 ? p.src[1] : p.src[2]);
    const int k0 = kc * KC;
    // weights: row n of tap `tap` is w[tap][c][gate][k0 .. k0 + 16), two
    // 16-byte pieces, swapped in rows with n & 4
    for (int i = tid; i < 9 * NOUT * 2; i += NT) {
      const int half = i & 1, row = i >> 1;
      const int n = row % NOUT, tap = row / NOUT;
      const int c = c0 + n / 4, k = k0 + 8 * half;
      __nv_bfloat16* dst = ws + ((s * 9 + tap) * NOUT + n) * KW + 8 * (half ^ ((n >> 2) & 1));
      const __nv_bfloat16* g = src.w + (((long long)tap * p.C + c) * 4 + n % 4) * src.cin + k;
      if (src.vec) {
        const bool valid = c < p.C && k < src.cin;
        eigen::cp_async16(dst, valid ? g : src.w, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (c < p.C && k + e < src.cin) ? g[e] : zero;
      }
    }
    // the halo slab: rows r0 - 1 .., columns x0 - 1 .. x0 + tw of the batch
    for (int i = tid; i < slab_px * 2; i += NT) {
      const int half = i & 1, px = i >> 1;
      const int row = r0 - 1 + px / p.slab_w, col = x0 - 1 + px % p.slab_w;
      const int k = k0 + 8 * half;
      const bool inside = row >= 0 && row < p.rows && col >= 0 && col < p.W;
      const __nv_bfloat16* g = src.x + ((long long)row * p.W + col) * src.cin + k;
      __nv_bfloat16* dst = xs + (s * slab_px + px) * KP + 8 * half;
      if (src.vec) {
        const bool valid = inside && k < src.cin;
        eigen::cp_async16(dst, valid ? g : src.x, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (inside && k + e < src.cin) ? g[e] : zero;
      }
    }
    eigen::cp_async_commit();
  };

  // A operand: lane 8 j + i gives row i of matrix j; matrices are (pixels
  // 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of an m16 tile.
  // Per m16 tile: the slab pixel at the top-left of the lane's pixel's 3x3
  // window, and whether the rows above / below it lie outside its image.
  int a_win[MT];
  bool a_top[MT], a_bot[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wm * MT + mt) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int q = q0 + m;
    const int row = q / p.tw, xin = q % p.tw;
    a_win[mt] = (row - r0) * p.slab_w + xin;
    const int y = row % p.H;
    a_top[mt] = y == 0;
    a_bot[mt] = y == p.H - 1;
  }
  const unsigned a_khalf = 16u * (lane >> 4);  // bytes
  const unsigned xs_addr = eigen::smem_addr(xs), zero_addr = eigen::smem_addr(zero_px) + a_khalf;
  // B operand: matrices (n8 tile 2 j', k 0-7), (2 j', k 8-15), (2 j' + 1, k
  // 0-7), (2 j' + 1, k 8-15) for the pair j' of the warp's n8 tiles
  const int b_n = wn * NTW * 8 + 8 * (lane >> 4) + (lane & 7);
  const int b_half = ((lane >> 3) ^ (lane >> 2)) & 1;  // the k half, swapped as staged
  const unsigned b_addr = eigen::smem_addr(ws) + (b_n * KW + 8 * b_half) * 2;

  float acc[MT][NTW][4], tot[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = tot[mt][nt][i] = 0.0f;

  stage(0, 0);  // every source has at least one chunk
  for (int kc = 0; kc < p.n_chunks; ++kc) {
    const int s = kc & 1;
    eigen::cp_async_wait<0>();  // chunk kc has landed ...
    __syncthreads();            // ... for every thread, and chunk kc - 1's slot is free
    if (kc + 1 < p.n_chunks) stage(s ^ 1, kc + 1);  // lands while chunk kc is computed
    const unsigned xs_s = xs_addr + (unsigned)(s * slab_px * KP * 2) + a_khalf;
    const unsigned ws_s = b_addr + (unsigned)(s * WS_ELEMS * 2);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bool off = (ky == 0 && a_top[mt]) || (ky == 2 && a_bot[mt]);
        const unsigned addr = xs_s + (unsigned)((a_win[mt] + ky * p.slab_w + kx) * KP * 2);
        eigen::ldmatrix_x4(a[mt], off ? zero_addr : addr);
      }
#pragma unroll
      for (int j = 0; j < NTW / 2; ++j) {
        unsigned b[4];
        eigen::ldmatrix_x4(b, ws_s + (unsigned)((tap * NOUT + 16 * j) * KW * 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          eigen::mma16816(acc[mt][2 * j], a[mt], b);
          eigen::mma16816(acc[mt][2 * j + 1], a[mt], b + 2);
        }
      }
    }
    // the chunk's sums into the totals (see Accumulation above)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[mt][nt][i] += acc[mt][nt][i], acc[mt][nt][i] = 0.0f;
  }
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
    const int q = q0 + m, c = c0 + cl;
    const int row = q / p.tw, x = x0 + q % p.tw;
    if (row >= p.rows || x >= p.W || c >= p.C) continue;
    const float* gv = ep + m * EP + 4 * cl;
    const float gi = gv[0] + p.bias[c];
    const float gf = gv[1] + p.bias[p.C + c];
    const float go = gv[2] + p.bias[2 * p.C + c];
    const float gg = gv[3] + p.bias[3 * p.C + c];
    const long long o = ((long long)row * p.W + x) * p.C + c;
    const float cn =
        eigen::sigmoid(gf) * eigen::to_float(c_prev[o]) + eigen::sigmoid(gi) * tanhf(gg);
    p.c_out[o] = cn;
    h_out[o] = eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn));
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

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
  for (int s = 0; s < n_src; ++s) {
    if (cins[s] < 1) return (int)cudaErrorInvalidValue;
    const int chunks = (cins[s] + KC - 1) / KC;
    p.src[s] = Source{(const __nv_bfloat16*)xs[s], (const __nv_bfloat16*)wts[s], cins[s], chunks,
                      cins[s] % 8 == 0 && aligned16(xs[s]) && aligned16(wts[s])};
    p.n_chunks += chunks;
  }
  p.bias = (const float*)bias;
  p.c_prev = c_prev;
  p.h_out = h_out;
  p.c_out = (float*)c_out;
  p.H = H;
  p.W = W;
  p.C = C;
  p.rows = B * H;
  p.tw = tw;
  p.tiles_per_strip = (int)(((long long)p.rows * tw + TM - 1) / TM);
  // rows a tile spans: TM / tw when tiles start on a row, else up to one more
  const int tile_rows = TM % tw == 0 ? TM / tw : (TM + tw - 2) / tw + 1;
  p.slab_h = tile_rows + 2;
  p.slab_w = tw + 2;
  const int stage_bytes = 2 * (STAGES * (WS_ELEMS + p.slab_h * p.slab_w * KP) + KP);
  const int bytes = stage_bytes > TM * EP * 4 ? stage_bytes : TM * EP * 4;
  const int strips = (W + tw - 1) / tw;
  const dim3 grid((unsigned)(strips * p.tiles_per_strip), (unsigned)((C + CG - 1) / CG));
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
