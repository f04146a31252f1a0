// One ConvLSTM layer update in one pass: the 3x3 SAME gate convolution over
// up to three sources, the bias, the gate nonlinearities and the cell update.
//
// Replaces evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py
// ::fused_convlstm_layer (one concatenated source, Pallas body _kernel) and
// ::fused_convlstm_layer_multi (separate E / R / upsampled-R_above sources,
// Pallas body _kernel_multi).  Both wrappers in ops/convlstm_fused.py launch
// this kernel.
//
// Math: sources and weights are bfloat16, products accumulate in float32,
// the gates and the cell state are float32; h is written in the state's type
// and c in float32 (the Pallas kernels' contract).  Gate order [i, f, o, g].
//
// Bound on the H100: operations.  At the north star's layer 1 (B 25,
// 240 x 320, sources 96 + 48 + 96, C 48) a launch is 1.59 TFLOP of bfloat16
// products, 1.61 ms at the 989 TFLOP/s peak, against 0.50 ms to read the
// sources and the state and write h and c once (1.66 GB at 3.35 TB/s).
// Only the warpgroup product (wgmma) reaches that peak, so the products run
// on it.  What holds the body at about 30% of the bound there is staging
// (the weight slices' L2 traffic) and the epilogue, which nothing overlaps
// (scripts/fused_breakdown.py takes each out; PERF.md).
//
// The gate convolution is an implicit GEMM: M = output pixels, N = gate
// outputs (n = 4 (c - c0) + gate), K = 9 taps x the sources' channels,
// walked in chunks of 16 input channels of one source (one k16 step per
// tap), the sources in their order (E, R, up(R_above)).  Two bodies share
// that walk and its sums; the wrapper picks one per launch, on the host, by
// shape and alignment (ops/convlstm_fused.py::plan), never on a failure.
//
// The wgmma body (convlstm_fused_wgmma_kernel), the design of the ladder's
// csrc/bisect_wgmma.cu carried over to several unpadded sources:
//   - A block owns a rectangle of tile_h x tile_w output pixels of one image
//     and a group of CG channels with all four gates: N = 4 CG, CG 48
//     (N 192), 32 or 16, so that at C 48 each source pixel is staged once.
//     Its two warpgroups take the M = 64 rows of their products from the
//     halo slab: the slab is (tile_h + 2) x (tile_w + 2) pixels, one 32-byte
//     row each (16 channels), and M row m of warpgroup wg is slab position
//     wg * wg_stride + m, that is slab pixel (p / slab_w, p % slab_w), an
//     output pixel where its column is below tile_w and its row below
//     tile_h.  tile_w 64 gives a warpgroup one image row (wg_stride 66); a
//     narrower tile takes tile_h = floor(130 / slab_w) rows and wg_stride 64,
//     so the two warpgroups run on across the rows and only the two halo
//     columns of a row are computed for nothing.  A tap (ky, kx) is the same
//     64 rows shifted by ky * slab_w + kx: the A descriptor's start moves,
//     nothing is copied (the swizzle is taken on absolute addresses).
//   - One thread asks the TMA for each chunk, into a ring of three chunks,
//     completing an mbarrier: the slab through a rank-4 map {cin, W, H, B}
//     of its source at (k0, x0 - 1, y0 - 1, b), whose negative and
//     far-edge coordinates the TMA fills with zeros (the SAME padding, and
//     channels past cin), and the 9 x N x 16 weight slice through a rank-3
//     map {cin, 4C, 9} of the (9, C, 4, cin) layout as it is (zeros past 4C).
//     One map of each kind per source, kernel parameters by value, so that
//     a CUDA graph keeps them.  Both operands land in wgmma's K-major
//     32-byte-swizzle layout.
//   - Two blocks of neighbouring tiles form a cluster and share the weight
//     slice: each asks for every other tap for both (multicast).  A slot is
//     refilled once every thread of both blocks is done with it (the
//     cluster barrier, split so that its wait overlaps the products).  A
//     cluster's padding block (an odd tile count) loads and computes like
//     the others and writes nothing.
//   - Per chunk and warpgroup, 9 wgmma.m64nNk16 go into fresh float32
//     accumulators (scale-d 0 on the first), which are added to float32
//     totals after wgmma.wait_group: no accumulator chain is longer than 9
//     products.  One chain over all chunks (135-324 products) drifts from
//     float64 sums several times further than the plain float32 version
//     does; these two levels of sums do not (chip_smoke.py checks it).  The
//     accumulators and totals of N 192 are 192 registers a thread: one
//     block an SM.
//   - The epilogue works from the registers: a shuffle with the neighbouring
//     lane gives each thread the four gates of one (pixel, channel) per n8
//     column pair; the c_prev tile and the bias sit in shared memory past
//     the ring, staged with cp.async while the products run.
// Each pixel's sums are the same whatever the tile, the batch or the
// channel group: its chunks and taps are added in one fixed order.
//
// The mma.sync body (convlstm_fused_kernel) takes the launches the TMA
// cannot address: a source whose cin is not a multiple of 8 (16-byte row
// strides) or a tensor that is not 16-byte aligned.  It is
// eigen::igemm::conv3x3 of common.cuh (which csrc/convlstm_narrow.cu
// shares): a block of 128 pixels of a strip `tw` columns wide x 16
// channels, mma.sync.m16n8k16 from ldmatrix fragments, cp.async two chunks
// deep (element by element where a source is not 16-byte addressable), the
// same two levels of float32 sums, and an epilogue through shared memory.

#include <cstdint>

#include "common.cuh"

namespace {

// ---- the mma.sync body

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

// ---- the wgmma body

namespace wg {

constexpr int TM = 64;         // M rows of a warpgroup's products
constexpr int WGS = 2;         // warpgroups per block
constexpr int NT = 128 * WGS;
constexpr int KC = 16;         // input channels per chunk: one k16 step per tap
constexpr int STAGES = 3;      // chunks in the ring
constexpr int CLUSTER = 2;     // blocks sharing each weight slice
// slab pixels a stage holds: the most a tile reads, wg_stride + 63 + 2
// slab_w + 2 <= 264 (ops/convlstm_fused.py::tile_shapes)
constexpr int SLAB_PX = 264;
constexpr int SLAB_BYTES = SLAB_PX * 32;

template <int N, typename ST>
struct Tile {
  static constexpr int CG = N / 4;
  static constexpr int W_TAP = N * 32;              // one tap's weights, 32-byte rows
  static constexpr int W_BYTES = 9 * W_TAP;
  static constexpr int STAGE = W_BYTES + SLAB_BYTES;  // [tap][n], then the slab; swizzled
  static constexpr int RING = STAGES * STAGE;
  static constexpr int CPREV = RING;                 // the c_prev tile [m][CG], state type
  static constexpr int BIAS = CPREV + WGS * TM * CG * (int)sizeof(ST);  // [gate][CG] floats
  static constexpr int BARS = BIAS + N * 4;          // the ring's mbarriers
  static constexpr int SMEM = BARS + 8 * STAGES;
  static_assert(STAGE % 256 == 0 && W_TAP % 256 == 0 && SLAB_BYTES % 256 == 0,
                "TMA destinations and swizzle atoms are 256-byte aligned");
  static_assert(BARS % 8 == 0 && SMEM <= 232448, "shared memory");
};

struct Geometry {
  int B, H, W, C;
  int tile_h, tile_w, slab_w, wg_stride;  // the plan's tile (see the note above)
  int tiles_x, tiles_y, tiles;  // tiles = B * tiles_y * tiles_x; blocks past it write nothing
  int slab_bytes;               // the slab box the TMA delivers: (tile_h + 2) * slab_w * 32
  int chunks0, chunks1, n_chunks;  // chunks of sources 0 and 1, and of all
  int cprev_vec;  // c_prev's pixel rows are 16-byte aligned: staged with cp.async
};

template <int N, typename ST>
__global__ void __launch_bounds__(NT, 1)
    convlstm_fused_wgmma_kernel(const __grid_constant__ CUtensorMap map_x0,
                                const __grid_constant__ CUtensorMap map_x1,
                                const __grid_constant__ CUtensorMap map_x2,
                                const __grid_constant__ CUtensorMap map_w0,
                                const __grid_constant__ CUtensorMap map_w1,
                                const __grid_constant__ CUtensorMap map_w2,
                                const float* __restrict__ bias, const ST* __restrict__ c_prev,
                                ST* __restrict__ h_out, float* __restrict__ c_out, Geometry g) {
  using T = Tile<N, ST>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;       // warpgroup
  const int q = (tid >> 5) & 3;   // warp in the warpgroup: accumulator rows 16 q ..
  const int lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * T::CG;
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  const int b = t / g.tiles_y;  // >= B for a cluster's padding block
  const int y0 = ty * g.tile_h, x0 = tx * g.tile_w;
  const unsigned base = eigen::smem_addr(smem);
  const unsigned bars = base + T::BARS;

  // thread 0 asks for chunk kc in slot s: the slab of its source, and every
  // CLUSTER-th tap's weights (from the block's rank on) for both blocks
  auto load_chunk = [&](int s, int kc) {
    const unsigned st = base + s * T::STAGE, bar = bars + 8 * s;
    const CUtensorMap* mx = &map_x0;
    const CUtensorMap* mw = &map_w0;
    if (kc >= g.chunks0) {
      kc -= g.chunks0;
      mx = &map_x1;
      mw = &map_w1;
      if (kc >= g.chunks1) {
        kc -= g.chunks1;
        mx = &map_x2;
        mw = &map_w2;
      }
    }
    const int k0 = kc * KC;
    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + g.slab_bytes);
    eigen::tma_load_4d(st + T::W_BYTES, mx, bar, k0, x0 - 1, y0 - 1, b);
    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)
      eigen::tma_load_3d_multicast(st + tap * T::W_TAP, mw, bar, (1 << CLUSTER) - 1, k0, 4 * c0,
                                   tap);
  };

  // the block's M row m (0 .. 127) -> its output pixel, or false
  auto pixel = [&](int m, int& y, int& x) {
    const int p = (m / TM) * g.wg_stride + m % TM;
    const int r = p / g.slab_w, col = p % g.slab_w;
    y = y0 + r;
    x = x0 + col;
    return b < g.B && col < g.tile_w && r < g.tile_h && y < g.H && x < g.W;
  };

  // the c_prev tile [m][CG] and the bias [gate][CG] land in shared memory
  // while the products run
  ST* cps = reinterpret_cast<ST*>(smem + T::CPREV);
  float* sb = reinterpret_cast<float*>(smem + T::BIAS);
  if (g.cprev_vec) {
    constexpr int PER = 16 / (int)sizeof(ST);  // channels per 16-byte piece
    constexpr int PIECES = T::CG / PER;        // per pixel
    for (int i = tid; i < WGS * TM * PIECES; i += NT) {
      const int m = i / PIECES, c = c0 + PER * (i % PIECES);
      int y, x;
      const bool valid = pixel(m, y, x) && c < g.C;
      const ST* src = c_prev + (((long long)b * g.H + y) * g.W + x) * g.C + c;
      eigen::cp_async16(cps + m * T::CG + (c - c0), valid ? src : c_prev, valid);
    }
  }
  eigen::cp_async_commit();
  for (int n = tid; n < N; n += NT) {
    const int gate = n / T::CG, c = c0 + n % T::CG;
    sb[n] = c < g.C ? bias[gate * g.C + c] : 0.0f;
  }

  // descriptors of slot 0, tap (0, 0); a slot and a tap add their byte
  // offsets / 16 to the start address field
  const uint64_t desc_b = eigen::wgmma_desc(base, 16, 256, eigen::kSwizzle32);
  const uint64_t desc_a = eigen::wgmma_desc(base + T::W_BYTES + wgi * g.wg_stride * 32, 16, 256,
                                            eigen::kSwizzle32);

  float acc[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = tot[i] = 0.0f;

  // the 9 products of chunk kc (in its slot) into fresh accumulators
  auto products = [&](int kc) {
    const uint64_t slot = (uint64_t)((kc % STAGES) * T::STAGE) >> 4;
    eigen::fence_operands(acc);
    eigen::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      eigen::wgmma_bf16<N>(acc, desc_a + slot + (uint64_t)((ky * g.slab_w + kx) * 2),
                           desc_b + slot + (tap * T::W_TAP >> 4), tap > 0);
    }
    eigen::wgmma_commit();
  };
  // ... and, once they are done, into the totals
  auto add = [&]() {
    eigen::wgmma_wait<0>();
    eigen::fence_operands(acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) eigen::mbar_init(bars + 8 * s, 1);
    eigen::fence_mbarrier_init();
  }
  // every block's mbarriers are initialised before any multicast
  eigen::cluster_arrive();
  eigen::cluster_wait();
  if (tid == 0)
    for (int s = 0; s < STAGES - 1 && s < g.n_chunks; ++s) load_chunk(s, s);
  __syncwarp();
  eigen::cluster_arrive();  // pairs with the first wait below
  for (int kc = 0; kc < g.n_chunks; ++kc) {
    eigen::mbar_wait_or_trap(bars + 8 * (kc % STAGES), (kc / STAGES) & 1);
    products(kc);
    // every thread of the cluster is done with chunk kc - 1: refill its slot
    eigen::cluster_wait();
    if (tid == 0 && kc + STAGES - 1 < g.n_chunks)
      load_chunk((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
    __syncwarp();
    add();
    eigen::cluster_arrive();
  }
  eigen::cluster_wait();  // no block's copies into another's ring are left
  eigen::cp_async_wait<0>();  // the c_prev tile
  __syncthreads();
  if (b >= g.B) return;  // a cluster's padding block

  // Accumulator fragment: warp q holds rows 16 q + gid (tot[4 j], [4 j + 1])
  // and + 8 ([4 j + 2], [4 j + 3]) of columns n = 8 j + 2 tig (+1), so channel
  // 2 j + tig / 2 and gates 2 (tig & 1) (+1): a lane of even tig holds i and
  // f, its neighbour o and g.  One exchange gives the even lane the four
  // gates of row gid and the odd lane those of row gid + 8.
  const int odd = tig & 1;
  const int m = wgi * TM + 16 * q + gid + 8 * odd;
  int y, x;
  const bool inside = pixel(m, y, x);
  const long long row = (((long long)b * g.H + y) * g.W + x) * g.C;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float d0 = tot[4 * j], d1 = tot[4 * j + 1], d2 = tot[4 * j + 2], d3 = tot[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
    const int cl = 2 * j + (tig >> 1), c = c0 + cl;
    if (!inside || c >= g.C) continue;
    const float gi = (odd ? r0 : d0) + sb[cl];
    const float gf = (odd ? r1 : d1) + sb[T::CG + cl];
    const float go = (odd ? d2 : r0) + sb[2 * T::CG + cl];
    const float gg = (odd ? d3 : r1) + sb[3 * T::CG + cl];
    const float cp = eigen::to_float(g.cprev_vec ? cps[m * T::CG + cl] : c_prev[row + c]);
    const float cn = eigen::sigmoid(gf) * cp + eigen::sigmoid(gi) * tanhf(gg);
    __stcs(c_out + row + c, cn);  // streaming stores: the kernel reads none of its outputs
    __stcs(h_out + row + c, eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn)));
  }
}

template <int N, typename ST>
int launch_n(const CUtensorMap* maps, const float* bias, const ST* c_prev, ST* h_out,
             float* c_out, const Geometry& g, void* stream) {
  const auto kernel = convlstm_fused_wgmma_kernel<N, ST>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Tile<N, ST>::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((g.tiles + CLUSTER - 1) / CLUSTER * CLUSTER),
                     (unsigned)((g.C + Tile<N, ST>::CG - 1) / Tile<N, ST>::CG));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Tile<N, ST>::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], bias,
                          c_prev, h_out, c_out, g);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

template <typename ST>
int launch_cg(int cg, const CUtensorMap* maps, const void* bias, const void* c_prev, void* h_out,
              void* c_out, const Geometry& g, void* stream) {
  const float* bs = (const float*)bias;
  const ST* cp = (const ST*)c_prev;
  ST* h = (ST*)h_out;
  float* c = (float*)c_out;
  switch (cg) {
    case 16: return launch_n<64, ST>(maps, bs, cp, h, c, g, stream);
    case 32: return launch_n<128, ST>(maps, bs, cp, h, c, g, stream);
    case 48: return launch_n<192, ST>(maps, bs, cp, h, c, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// x_s: (B, H, W, cin_s) bfloat16; w_s: (9, C, 4, cin_s) bfloat16, for
// s < n_src (1..3); bias: (4C,) float32; c_prev and h_out: (B, H, W, C) in
// float32 or bfloat16 (state_bf16 != 0); c_out: (B, H, W, C) float32.  All
// contiguous.  Each entry launches on `stream` and returns the CUDA error of
// the launch.
//
// The mma.sync body; tw: the strip width of the tile mapping, 1..W.
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

// The wgmma body: every cin_s a multiple of 8 and every x_s and w_s 16-byte
// aligned (else cudaErrorInvalidValue: the wrapper sends such launches to
// the mma.sync body); cg 16, 32 or 48 channels a block; the tile tile_h x
// tile_w with the warpgroups wg_stride slab positions apart, as
// ops/convlstm_fused.py::tile_shapes makes them.
extern "C" int eigen_convlstm_fused_wgmma(const void* x0, const void* w0, int cin0,
                                          const void* x1, const void* w1, int cin1,
                                          const void* x2, const void* w2, int cin2, int n_src,
                                          const void* bias, const void* c_prev, int state_bf16,
                                          void* h_out, void* c_out, int B, int H, int W, int C,
                                          int cg, int tile_h, int tile_w, int wg_stride,
                                          void* stream) {
  const int slab_w = tile_w + 2;
  const bool two_rows = tile_w == wg::TM && wg_stride == slab_w && tile_h == 2;
  const bool run_on = wg_stride == wg::TM && slab_w <= wg::TM && tile_h >= 1 &&
                      tile_h * slab_w <= 2 * wg::TM + 2;
  if (n_src < 1 || n_src > 3 || B < 0 || H < 0 || W < 0 || C < 0 || !(two_rows || run_on))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  const void* xs[3] = {x0, x1, x2};
  const void* ws[3] = {w0, w1, w2};
  const int cins[3] = {cin0, cin1, cin2};
  CUtensorMap maps[6];
  int chunks[3] = {0, 0, 0};
  for (int s = 0; s < 3; ++s) {
    const int src = s < n_src ? s : 0;  // unused maps repeat source 0
    const int cin = cins[src];
    if (cin < 1 || cin % 8 != 0 || !eigen::igemm::aligned16(xs[src]) ||
        !eigen::igemm::aligned16(ws[src]))
      return (int)cudaErrorInvalidValue;
    const cuuint64_t pix = (cuuint64_t)cin * 2;
    const cuuint64_t dx[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t sx[3] = {pix, pix * W, pix * W * H};
    const cuuint32_t bx[4] = {wg::KC, (cuuint32_t)slab_w, (cuuint32_t)tile_h + 2, 1};
    const cuuint64_t dw[3] = {(cuuint64_t)cin, 4 * (cuuint64_t)C, 9};
    const cuuint64_t sw[2] = {pix, pix * 4 * C};
    const cuuint32_t bw[3] = {wg::KC, 4 * (cuuint32_t)cg, 1};
    if (!eigen::tensor_map(&maps[s], xs[src], 4, dx, sx, bx, CU_TENSOR_MAP_SWIZZLE_32B) ||
        !eigen::tensor_map(&maps[3 + s], ws[src], 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (s < n_src) chunks[s] = (cin + wg::KC - 1) / wg::KC;
  }
  wg::Geometry g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.slab_w = slab_w;
  g.wg_stride = wg_stride;
  g.tiles_x = (W + tile_w - 1) / tile_w;
  g.tiles_y = (H + tile_h - 1) / tile_h;
  g.tiles = B * g.tiles_x * g.tiles_y;
  g.slab_bytes = (tile_h + 2) * slab_w * 32;
  g.chunks0 = chunks[0];
  g.chunks1 = chunks[1];
  g.n_chunks = chunks[0] + chunks[1] + chunks[2];
  const int state_size = state_bf16 ? 2 : 4;
  g.cprev_vec = C * state_size % 16 == 0 && eigen::igemm::aligned16(c_prev);
  if (state_bf16)
    return wg::launch_cg<__nv_bfloat16>(cg, maps, bias, c_prev, h_out, c_out, g, stream);
  return wg::launch_cg<float>(cg, maps, bias, c_prev, h_out, c_out, g, stream);
}
