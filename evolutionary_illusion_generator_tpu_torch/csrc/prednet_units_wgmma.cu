// The PredNet A and Ahat units' wgmma bodies (bfloat16 compute): the same
// two functions as csrc/prednet_units.cu's kernels,
//   ahat_error_unit_wgmma_kernel: Ahat = SatLU (layer 0) or ReLU of conv(R)
//     + b; E = [ReLU(Ahat - A); ReLU(A - Ahat)], and at layer 0 the float32
//     prediction Ahat;
//   a_unit_wgmma_kernel: A_next = maxpool2(ReLU(conv(E) + b)), only the
//     pooled values leaving the block;
//   a_unit_im2col_kernel: the A unit where E has few channels (the pixel
//     layer's 2 C0: 6 colour, 2 grey), whose 12-byte pixel rows the TMA
//     cannot address.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA
// (evolutionary_illusion_generator_tpu/models/prednet/model.py, prednet_step
// after the ConvLSTM updates).  They are the redesign for Hopper of
// csrc/prednet_units.cu's mma.sync bodies, which keep the float32 compute
// type, channel counts the TMA cannot address (not a multiple of 8) and the
// pixel layer's Ahat unit (on the CUDA cores).  ops/prednet_units.py::
// ahat_plan / a_plan pick the body on the host from the layer's shape and
// types alone, never from the batch or after a failure.
//
// Bound on the H100: bytes, but for the north star's layer-1 and layer-2 A
// convs (operations, about even); chip_smoke.py computes each launch's
// bound from its shapes.  What held the mma.sync bodies at 5-38% of it: a
// block of 128 pixels x 64 outputs restaged the same halo slab for every
// group of 64 outputs and streamed the layer's whole weight from L2 for
// every 128 pixels; cp.async two chunks deep; an epilogue through shared
// memory; the A unit's pixel layer padded each tap's 6 channels to 16.
//
// Design: convlstm_fused.cu's wgmma body with one source and N = every
// output of the layer (48, 64, 96 or 192 columns; a wider layer, or a small
// one that would leave most SMs idle, takes channel groups of N, grid.y):
//   - A block owns a tile_h x tile_w rectangle of output pixels of one image;
//     its two warpgroups take their M = 64 rows as positions of the halo
//     slab ((tile_h + 2) x (tile_w + 2) pixels, one 32-byte row of 16
//     channels each): row m of warpgroup wg is slab position wg * wg_stride
//     + m, a tap (ky, kx) the same rows shifted by ky * slab_w + kx (the A
//     descriptor's start moves).  tile_w 64 gives each warpgroup one image
//     row (wg_stride 66); a narrower tile runs the 128 rows on across the
//     slab's rows (wg_stride 64), as ops/convlstm_fused.py::tile_shapes
//     makes them.  The slab is staged once for every output of the layer.
//   - One thread asks the TMA for each chunk of 16 input channels into a
//     ring of three, completing an mbarrier: the slab through a rank-4 map
//     {cin, W, H, B} at (k0, x0 - 1, y0 - 1, b), whose out-of-range
//     coordinates read as zeros (the SAME padding and the channels past
//     cin), and the 9 x N x 16 weight slice through a rank-3 map {cin, Cp,
//     9} of the packed (9, Cp, cin) layout (zeros past Cp).  Two or four
//     blocks of neighbouring tiles (the plan's) form a cluster and share
//     the weight slice by multicast, each asking for every cluster-th tap
//     for all: the weights' L2-to-SM traffic, which bounds the staging at
//     N 96 and 192, is cut by the cluster's size against one block, and by
//     N / 64 more against the mma.sync body's per-group restaging.
//   - Sums: per chunk, 9 wgmma.m64nNk16 into fresh float32 accumulators
//     (scale-d 0 on the first tap), added to float32 totals after
//     wgmma.wait_group: the order is chunk, then tap, then the instruction's
//     16 products, fixed per pixel whatever the batch, the tile or the
//     channel group.
//   - Epilogue from the registers: round(round(sum) + b) to bfloat16.  The
//     Ahat unit reads A straight from device memory at each accumulator
//     pair (its 128-pixel A tile, 48 KB at 192 channels, does not fit beside
//     the ring) and writes E's two halves and the prediction as pairs.  The
//     A unit pools each 2x2 quad inside the block: tiles start on even rows
//     and columns, tile_w and tile_h are even, so slab position p and p + 1
//     of an even column are accumulator rows gid and gid + 1 (a shuffle with
//     lane + 4); the pair's max goes into shared memory that the ring no
//     longer needs, and the rows' pairs are taken from there, only the
//     pooled A written.
//   - The pixel layer's A unit (im2col; cin <= IM2COL_MAX_CIN): a block's M
//     rows are the 128 output pixels of a tile_h x tile_w tile (tile_w 16,
//     32 or 64, 128 / tile_w rows); per tile its halo is staged by the
//     threads into shared memory, each pixel's 9 cin products are laid out
//     as one K row (k = tap * cin + ci, zeros to K = 64), and four wgmma
//     k16 steps (where the mma.sync body took 9 steps at cin 6, of which 6 in
//     16 products were real) sum them in one accumulator, a fixed order per
//     pixel.  The block keeps the weight (N x 64) in shared memory and
//     walks tiles in a grid-stride loop; several blocks share an SM, so one
//     block's loads overlap another's products.
// A cluster's padding blocks (a tile count that is not a multiple of the
// cluster) load and compute like the others and write nothing.  A deadlocked ring traps (mbar_wait_or_trap).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 64;         // M rows of a warpgroup's products
constexpr int WGS = 2;         // warpgroups per block
constexpr int NT = 128 * WGS;
constexpr int KC = 16;         // input channels per chunk: one k16 step per tap
constexpr int STAGES = 3;      // chunks in the ring
constexpr int MAX_CLUSTER = 4;  // blocks sharing each weight slice: 2 or 4 (the plan's)
constexpr int SLAB_PX = 264;   // slab pixels a stage holds (convlstm_fused.cu's)
constexpr int SLAB_BYTES = SLAB_PX * 32;
constexpr int IM2COL_MAX_CIN = 7;  // 9 cin <= 64: at most four k16 steps
constexpr int IM2COL_KS = 4;
constexpr int IM2COL_HALO = 4096;  // bytes: (tile_h + 2)(tile_w + 2) cin bfloat16 at most

template <int N>
struct Tile {
  static constexpr int W_TAP = N * 32;  // one tap's weights, 32-byte rows
  static constexpr int W_BYTES = 9 * W_TAP;
  static constexpr int STAGE = W_BYTES + SLAB_BYTES;  // [tap][n], then the slab; swizzled
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BIAS = RING;  // N floats, the bias rounded to bfloat16
  static constexpr int BARS = BIAS + N * 4;
  static constexpr int SMEM = BARS + 8 * STAGES;
  static_assert(STAGE % 256 == 0 && W_TAP % 256 == 0 && SLAB_BYTES % 256 == 0,
                "TMA destinations and swizzle atoms are 256-byte aligned");
  static_assert(BARS % 8 == 0 && SMEM <= 232448, "shared memory");
  // the A unit's row pairs, [tile_h][tile_w / 2][N] floats, fit in the ring
  static_assert((2 * TM + 2) / 2 * N * 4 <= RING, "pooling buffer");
};

struct Geometry {
  int B, H, W, cin, cout;
  int tile_h, tile_w, slab_w, wg_stride;  // the plan's tile (see the note above)
  int tiles_x, tiles_y, tiles;            // tiles = B * tiles_y * tiles_x
  int slab_bytes;                         // the slab box: (tile_h + 2) * slab_w * 32
  int n_chunks;
  int cluster;       // blocks of neighbouring tiles sharing each weight slice
  const void* bias;  // (cout,) float32 or bfloat16
  int bias_bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// torch.relu, clamp(0, 1) and max-pool keep a NaN
__device__ __forceinline__ float relu(float v) { return v > 0.0f || v != v ? v : 0.0f; }
__device__ __forceinline__ float satlu(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
__device__ __forceinline__ float max_nan(float a, float b) { return a != a || a > b ? a : b; }

// the bias of outputs n0 .. n0 + N rounded to bfloat16, zeros past cout
template <int N>
__device__ __forceinline__ void stage_bias(float* sb, const Geometry& g, int n0) {
  for (int n = threadIdx.x; n < N; n += NT) {
    const int c = n0 + n;
    float v = 0.0f;
    if (c < g.cout)
      v = g.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g.bias)[c])
                      : static_cast<const float*>(g.bias)[c];
    sb[n] = round_bf16(v);
  }
}

// The block's tile from blockIdx.x: image b (>= B for a cluster's padding
// block), first output row y0 and column x0.
struct TileAt {
  int b, y0, x0;
};
__device__ __forceinline__ TileAt tile_at(const Geometry& g) {
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  return TileAt{t / g.tiles_y, ty * g.tile_h, tx * g.tile_w};
}

// M row m (0 .. 127) of the block -> its slab row r and column col; true
// where that is an output pixel of the tile inside the image
__device__ __forceinline__ bool slab_pixel(const Geometry& g, const TileAt& at, int m, int& r,
                                           int& col) {
  const int p = (m / TM) * g.wg_stride + m % TM;
  r = p / g.slab_w;
  col = p % g.slab_w;
  return at.b < g.B && col < g.tile_w && r < g.tile_h && at.y0 + r < g.H && at.x0 + col < g.W;
}

// tot (this thread's accumulator fragment, warpgroup threadIdx.x / 128) =
// the block's conv for outputs n0 .. n0 + N.  Ends with every thread of the
// cluster past its last product: the ring may be reused.
template <int N>
__device__ __forceinline__ void conv_wgmma(unsigned char* smem, const CUtensorMap* map_x,
                                           const CUtensorMap* map_w, const Geometry& g,
                                           const TileAt& at, int n0, float (&tot)[N / 2]) {
  using T = Tile<N>;
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const unsigned base = eigen::smem_addr(smem);
  const unsigned bars = base + T::BARS;

  // thread 0 asks for chunk kc in slot s: the slab, and every cluster-th tap
  // of the weights (from the block's rank on) for every block of the cluster
  const unsigned short everyone = (unsigned short)((1 << g.cluster) - 1);
  auto load_chunk = [&](int s, int kc) {
    const unsigned st = base + s * T::STAGE, bar = bars + 8 * s;
    const int k0 = kc * KC;
    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + g.slab_bytes);
    eigen::tma_load_4d(st + T::W_BYTES, map_x, bar, k0, at.x0 - 1, at.y0 - 1, at.b);
    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += g.cluster)
      eigen::tma_load_3d_multicast(st + tap * T::W_TAP, map_w, bar, everyone, k0, n0, tap);
  };

  // descriptors of slot 0, tap (0, 0); a slot and a tap add their byte
  // offsets / 16 to the start address field
  const uint64_t desc_b = eigen::wgmma_desc(base, 16, 256, eigen::kSwizzle32);
  const uint64_t desc_a = eigen::wgmma_desc(base + T::W_BYTES + wgi * g.wg_stride * 32, 16, 256,
                                            eigen::kSwizzle32);
  float acc[N / 2];
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
}

template <typename ST>
struct AhatOut {
  const __nv_bfloat16* a;  // (B, H, W, cout) bfloat16 (the compute type)
  ST* e_out;               // (B, H, W, 2 cout)
  float* pred_out;         // (B, H, W, cout) or null
  int layer0;
};

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Accumulator fragment: warp q of warpgroup wg holds rows 16 q + gid
// (tot[4 j], [4 j + 1]) and + 8 ([4 j + 2], [4 j + 3]) of columns n = 8 j +
// 2 tig (+1); cout % 8 == 0 here (cin = cout, a multiple of 8 for the TMA),
// so a pair is two outputs of one pixel, 4- or 8-byte aligned.
template <int N, typename ST>
__global__ void __launch_bounds__(NT, 1)
    ahat_error_unit_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_w, AhatOut<ST> o,
                                 Geometry g) {
  using T = Tile<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * N;
  const TileAt at = tile_at(g);
  float* sb = reinterpret_cast<float*>(smem + T::BIAS);
  stage_bias<N>(sb, g, n0);
  float tot[N / 2];
  conv_wgmma<N>(smem, &map_x, &map_w, g, at, n0, tot);
  __syncthreads();  // the bias
  if (at.b >= g.B) return;  // a cluster's padding block

  const int q = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int C = g.cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = (tid >> 7) * TM + 16 * q + gid + 8 * h;
    int r, col;
    if (!slab_pixel(g, at, m, r, col)) continue;
    const long long px = ((long long)at.b * g.H + at.y0 + r) * g.W + at.x0 + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * tig, c = n0 + n;
      if (c >= C) continue;
      float ahat[2], av[2];
      const __nv_bfloat162 a2 = *reinterpret_cast<const __nv_bfloat162*>(o.a + px * C + c);
      av[0] = __low2float(a2);
      av[1] = __high2float(a2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = round_bf16(round_bf16(tot[4 * j + 2 * h + e]) + sb[n + e]);
        ahat[e] = o.layer0 ? satlu(v) : relu(v);
      }
      store_pair(o.e_out + px * 2 * C + c, relu(round_bf16(ahat[0] - av[0])),
                 relu(round_bf16(ahat[1] - av[1])));
      store_pair(o.e_out + px * 2 * C + C + c, relu(round_bf16(av[0] - ahat[0])),
                 relu(round_bf16(av[1] - ahat[1])));
      if (o.pred_out != nullptr) store_pair(o.pred_out + px * C + c, ahat[0], ahat[1]);
    }
  }
}

// The A unit's epilogue from the accumulator rows' values v(m, n) =
// round(round(sum) + b): each even column's pair max (lane + 4 holds row m
// + 1) into hp[r][col / 2][n] (shared memory past use by the products),
// then the max of each pair of rows, ReLU, written as the pooled output.
// `pos(m, r, col)` maps a row to its tile pixel (r < tile_h, col < tile_w);
// hw_shift is log2(tile_w / 2) where that is a power of two, else -1.
template <int N, typename Pos>
__device__ __forceinline__ void pool_out(float* hp, const float (&tot)[N / 2], const float* sb,
                                         int tile_h, int tile_w, int hw_shift, Pos pos,
                                         const TileAt& at, int H, int W, int cout, int n0,
                                         __nv_bfloat16* out) {
  const int tid = threadIdx.x;
  const int q = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int hw = tile_w / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = (tid >> 7) * TM + 16 * q + gid + 8 * h;
    int r, col;
    const bool keep = pos(m, r, col) && (col & 1) == 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * tig + e;
        const float v = round_bf16(round_bf16(tot[4 * j + 2 * h + e]) + sb[n]);
        const float right = __shfl_xor_sync(0xffffffffu, v, 4);
        if (keep) hp[(r * hw + col / 2) * N + n] = max_nan(v, right);
      }
  }
  __syncthreads();
  const int H2 = H / 2, W2 = W / 2;
  for (int i = tid; i < tile_h / 2 * hw * N; i += NT) {
    const int n = i % N, pix = i / N;
    const int pc = hw_shift >= 0 ? pix & (hw - 1) : pix % hw;
    const int pr = hw_shift >= 0 ? pix >> hw_shift : pix / hw;
    const int y2 = at.y0 / 2 + pr, x2 = at.x0 / 2 + pc, c = n0 + n;
    if (y2 >= H2 || x2 >= W2 || c >= cout) continue;
    const float v = max_nan(hp[(2 * pr * hw + pc) * N + n], hp[((2 * pr + 1) * hw + pc) * N + n]);
    out[(((long long)at.b * H2 + y2) * W2 + x2) * cout + c] = __float2bfloat16_rn(relu(v));
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
    a_unit_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w, __nv_bfloat16* __restrict__ out,
                        Geometry g) {
  using T = Tile<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.y * N;
  const TileAt at = tile_at(g);
  float* sb = reinterpret_cast<float*>(smem + T::BIAS);
  stage_bias<N>(sb, g, n0);
  float tot[N / 2];
  conv_wgmma<N>(smem, &map_x, &map_w, g, at, n0, tot);
  __syncthreads();  // the bias
  if (at.b >= g.B) return;  // a cluster's padding block (the whole block: no shuffle is left)
  auto pos = [&](int m, int& r, int& col) {
    const int p = (m / TM) * g.wg_stride + m % TM;
    r = p / g.slab_w;
    col = p % g.slab_w;
    return col < g.tile_w && r < g.tile_h;
  };
  pool_out<N>(reinterpret_cast<float*>(smem), tot, sb, g.tile_h, g.tile_w, -1, pos, at, g.H,
              g.W, g.cout, n0, out);
}

// ---- the pixel layer's A unit (im2col)

template <int N>
struct Im2col {
  static constexpr int PLANE_B = N * 32;        // one k16 step of the weight, [n] 32-byte rows
  static constexpr int PLANE_A = 2 * TM * 32;   // one k16 step of the 128 pixels' K rows
  static constexpr int B_OFF = 0;
  static constexpr int A_OFF = IM2COL_KS * PLANE_B;
  static constexpr int HALO = A_OFF + IM2COL_KS * PLANE_A;
  static constexpr int HP = HALO + IM2COL_HALO;  // [tile_h][tile_w / 2][N] floats
  static constexpr int BIAS = HP + TM * N * 4;
  static constexpr int KOFF = BIAS + N * 4;      // [64] shorts: k -> halo offset, or -1
  static constexpr int SMEM = KOFF + 16 * IM2COL_KS * 2;
  static_assert(PLANE_B % 256 == 0 && PLANE_A % 256 == 0 && HALO % 16 == 0, "alignment");
};

// generic pointer to byte `o` of a 32-byte-swizzled region at `base`, the
// swizzle taken on the absolute shared address (as wgmma reads it)
__device__ __forceinline__ unsigned char* swizzled(unsigned char* base, unsigned o) {
  const unsigned a = eigen::smem_addr(base) + o;
  return base + (eigen::swizzle32(a) - eigen::smem_addr(base));
}

template <int N>
__global__ void __launch_bounds__(NT)
    a_unit_im2col_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, Geometry g) {
  using T = Im2col<N>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * N;
  const int cin = g.cin, K = 9 * cin;
  const int tw = g.tile_w, th = g.tile_h, hw_px = tw + 2;
  const int tw_shift = __ffs(tw) - 1;   // tw is 16, 32 or 64
  const int cp = (g.cout + 3) / 4 * 4;  // the packed weight's rows
  float* sb = reinterpret_cast<float*>(smem + T::BIAS);
  stage_bias<N>(sb, g, n0);
  // k = tap * cin + ci of a K row -> its offset in the halo from the pixel's
  // top-left neighbour, or -1 past K
  short* koff = reinterpret_cast<short*>(smem + T::KOFF);
  if (tid < 16 * IM2COL_KS) {
    const int tap = tid / cin;
    koff[tid] = tid < K ? (short)(((tap / 3) * hw_px + tap % 3) * cin + tid % cin) : (short)-1;
  }
  // the weight once: B[n][k] = w[tap][n0 + n][ci], k = tap * cin + ci
  for (int i = tid; i < IM2COL_KS * N * 8; i += NT) {
    const int pair = i % 8, n = i / 8 % N, s = i / 8 / N;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 16 * s + 2 * pair + e, c = n0 + n;
      v[e] = k < K && c < g.cout ? __bfloat162float(w[((long long)(k / cin) * cp + c) * cin + k % cin])
                                 : 0.0f;
    }
    *reinterpret_cast<__nv_bfloat162*>(
        swizzled(smem + T::B_OFF, s * T::PLANE_B + n * 32 + pair * 4)) =
        __floats2bfloat162_rn(v[0], v[1]);
  }
  const unsigned base = eigen::smem_addr(smem);
  const int wgi = tid >> 7;
  const uint64_t desc_b = eigen::wgmma_desc(base + T::B_OFF, 16, 256, eigen::kSwizzle32);
  const uint64_t desc_a =
      eigen::wgmma_desc(base + T::A_OFF + wgi * TM * 32, 16, 256, eigen::kSwizzle32);
  unsigned short* halo = reinterpret_cast<unsigned short*>(smem + T::HALO);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  float* hp = reinterpret_cast<float*>(smem + T::HP);
  // this thread's K-row pieces: pixel m = tid / 2 of the tile, steps 2 (tid
  // & 1) and + 1; its top-left neighbour's element in the halo
  const int m = tid >> 1;
  const int pbase = ((m >> tw_shift) * hw_px + (m & (tw - 1))) * cin;
  // the halo's rows are (tw + 2) cin contiguous elements in device memory,
  // read as 4-byte words (two channels of one pixel) where cin is even
  const int per = cin % 2 == 0 ? 2 : 1;
  const int row_n = hw_px * cin / per;

  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int rest = t;
    const int tx = rest % g.tiles_x;
    rest /= g.tiles_x;
    const TileAt at{rest / g.tiles_y, rest % g.tiles_y * th, tx * tw};
    // the halo: rows y0 - 1 .. y0 + th, columns x0 - 1 .. x0 + tw, zeros
    // outside the image
    for (int i = tid; i < (th + 2) * row_n; i += NT) {
      const int hr = i / row_n, e = i % row_n * per;
      const int y = at.y0 - 1 + hr, xx = at.x0 - 1 + e / cin;
      const bool inside = y >= 0 && y < g.H && xx >= 0 && xx < g.W;
      const int dst = hr * hw_px * cin + e;
      const long long src = (((long long)at.b * g.H + y) * g.W + at.x0 - 1) * cin + e;
      if (per == 2)
        *reinterpret_cast<unsigned*>(halo + dst) =
            inside ? *reinterpret_cast<const unsigned*>(xs + src) : 0u;
      else
        halo[dst] = inside ? xs[src] : (unsigned short)0;
    }
    __syncthreads();
    // the K rows: four 16-byte pieces a thread, eight gathered values each
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = 2 * (tid & 1) + (q >> 1), k0 = 16 * s + 8 * (q & 1);
      unsigned v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o0 = koff[k0 + 2 * j], o1 = koff[k0 + 2 * j + 1];
        v[j] = (o0 >= 0 ? (unsigned)halo[pbase + o0] : 0u) |
               (o1 >= 0 ? (unsigned)halo[pbase + o1] : 0u) << 16;
      }
      *reinterpret_cast<uint4*>(swizzled(smem + T::A_OFF, s * T::PLANE_A + m * 32 + (q & 1) * 16)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    eigen::fence_proxy_async();  // the generic proxy's writes, read by wgmma
    __syncthreads();
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    eigen::fence_operands(acc);
    eigen::wgmma_fence();
#pragma unroll
    for (int s = 0; s < IM2COL_KS; ++s)  // all four: the steps past K add zeros
      eigen::wgmma_bf16<N>(acc, desc_a + (uint64_t)(s * T::PLANE_A >> 4),
                           desc_b + (uint64_t)(s * T::PLANE_B >> 4), s > 0);
    eigen::wgmma_commit();
    eigen::wgmma_wait<0>();
    eigen::fence_operands(acc);
    auto pos = [&](int mm, int& r, int& col) {  // tw a power of two
      r = mm >> tw_shift;
      col = mm & (tw - 1);
      return true;
    };
    pool_out<N>(hp, acc, sb, th, tw, tw_shift - 1, pos, at, g.H, g.W, g.cout, n0, out);
    __syncthreads();  // the halo, the K rows and hp are free for the next tile
  }
}

// ---- host

bool unit_maps(CUtensorMap* mx, CUtensorMap* mw, const void* x, const void* w, int cin,
               int cout, int B, int H, int W, int n, int tile_h, int slab_w) {
  if (cin < 8 || cin % 8 != 0 || !eigen::igemm::aligned16(x) || !eigen::igemm::aligned16(w))
    return false;
  const int cp = (cout + 3) / 4 * 4;
  const cuuint64_t pix = (cuuint64_t)cin * 2;
  const cuuint64_t dx[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t sx[3] = {pix, pix * W, pix * W * H};
  const cuuint32_t bx[4] = {KC, (cuuint32_t)slab_w, (cuuint32_t)tile_h + 2, 1};
  const cuuint64_t dw[3] = {(cuuint64_t)cin, (cuuint64_t)cp, 9};
  const cuuint64_t sw[2] = {pix, pix * cp};
  const cuuint32_t bw[3] = {KC, (cuuint32_t)n, 1};
  return eigen::tensor_map(mx, x, 4, dx, sx, bx, CU_TENSOR_MAP_SWIZZLE_32B) &&
         eigen::tensor_map(mw, w, 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_32B);
}

// the tile's shape is one the body takes: a row of 64 a warpgroup, or
// run-on rows whose last output pixel is M row 127 at most
bool make_geometry(Geometry& g, int cin, int cout, const void* bias, int bias_bf16, int B, int H,
                   int W, int tile_h, int tile_w, int wg_stride, int cluster) {
  const int slab_w = tile_w + 2;
  const bool two_rows = tile_w == TM && wg_stride == slab_w && tile_h == 2;
  const bool run_on = wg_stride == TM && slab_w <= TM && tile_h >= 1 &&
                      tile_h * slab_w <= 2 * TM + 2;
  if (!(two_rows || run_on) || cout < 1 || !(cluster == 2 || cluster == MAX_CLUSTER))
    return false;
  g.cluster = cluster;
  g.B = B;
  g.H = H;
  g.W = W;
  g.cin = cin;
  g.cout = cout;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.slab_w = slab_w;
  g.wg_stride = wg_stride;
  g.tiles_x = (W + tile_w - 1) / tile_w;
  g.tiles_y = (H + tile_h - 1) / tile_h;
  g.tiles = B * g.tiles_x * g.tiles_y;
  g.slab_bytes = (tile_h + 2) * slab_w * 32;
  g.n_chunks = (cin + KC - 1) / KC;
  g.bias = bias;
  g.bias_bf16 = bias_bf16;
  return true;
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int smem, const Geometry& g, int n, cudaStream_t st,
                   Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((g.tiles + g.cluster - 1) / g.cluster * g.cluster),
                     (unsigned)((g.cout + n - 1) / n));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, args..., g);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

template <int N>
int launch_ahat_n(const CUtensorMap& mx, const CUtensorMap& mw, const void* a, void* e_out,
                  void* pred_out, int layer0, int state_bf16, const Geometry& g,
                  cudaStream_t st) {
  if (state_bf16) {
    AhatOut<__nv_bfloat16> o{(const __nv_bfloat16*)a, (__nv_bfloat16*)e_out, (float*)pred_out,
                             layer0};
    return launch_cluster(ahat_error_unit_wgmma_kernel<N, __nv_bfloat16>, Tile<N>::SMEM, g, N,
                          st, mx, mw, o);
  }
  AhatOut<float> o{(const __nv_bfloat16*)a, (float*)e_out, (float*)pred_out, layer0};
  return launch_cluster(ahat_error_unit_wgmma_kernel<N, float>, Tile<N>::SMEM, g, N, st, mx, mw,
                        o);
}

template <int N>
int launch_im2col_n(const void* x, const void* w, void* out, const Geometry& g, int blocks,
                    cudaStream_t st) {
  const auto kernel = a_unit_im2col_kernel<N>;
  const int smem = Im2col<N>::SMEM;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)blocks, (unsigned)((g.cout + N - 1) / N));
  kernel<<<grid, NT, smem, st>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                                 (__nv_bfloat16*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// The Ahat and error units' wgmma body, bfloat16 compute.  x (R): (B, H, W,
// cin) bfloat16, cin = cout a multiple of 8; w (9, Cp, cin) bfloat16; bias
// (cout,) float32 or bfloat16 (bias_bf16 != 0); a (A): (B, H, W, cout)
// bfloat16; e_out (E): (B, H, W, 2 cout) in the state type (bfloat16 when
// state_bf16 != 0, else float32); pred_out: (B, H, W, cout) float32 or null.
// layer0 != 0: SatLU, else ReLU.  All contiguous, x and w 16-byte aligned.
// n: outputs a block (48, 64, 96 or 192; ceil(cout / n) channel groups);
// tile_h x tile_w with the warpgroups wg_stride slab positions apart;
// cluster: 2 or 4 blocks sharing each weight slice; as
// ops/prednet_units.py::ahat_plan makes them.  Launches on `stream` and
// returns the CUDA error of the launch.
extern "C" int eigen_ahat_error_unit_wgmma(const void* x, const void* w, int cin, int cout,
                                           const void* bias, int bias_bf16, const void* a,
                                           void* e_out, void* pred_out, int layer0,
                                           int state_bf16, int B, int H, int W, int n,
                                           int tile_h, int tile_w, int wg_stride, int cluster,
                                           void* stream) {
  if (B < 0 || H < 0 || W < 0 || cin != cout || cout % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  Geometry g{};
  CUtensorMap mx, mw;
  if (!make_geometry(g, cin, cout, bias, bias_bf16, B, H, W, tile_h, tile_w, wg_stride,
                     cluster) ||
      !unit_maps(&mx, &mw, x, w, cin, cout, B, H, W, n, tile_h, tile_w + 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 48: return launch_ahat_n<48>(mx, mw, a, e_out, pred_out, layer0, state_bf16, g, st);
    case 64: return launch_ahat_n<64>(mx, mw, a, e_out, pred_out, layer0, state_bf16, g, st);
    case 96: return launch_ahat_n<96>(mx, mw, a, e_out, pred_out, layer0, state_bf16, g, st);
    case 192: return launch_ahat_n<192>(mx, mw, a, e_out, pred_out, layer0, state_bf16, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The A unit's wgmma body, bfloat16 compute.  x (E): (B, H, W, cin)
// bfloat16, cin a multiple of 8; w (9, Cp, cin) bfloat16; bias (cout,)
// float32 or bfloat16; out: (B, H / 2, W / 2, cout) bfloat16.  n, tile_h,
// tile_w, wg_stride and cluster as above, tile_w and tile_h even.
extern "C" int eigen_a_unit_wgmma(const void* x, const void* w, int cin, int cout,
                                  const void* bias, int bias_bf16, void* out, int B, int H, int W,
                                  int n, int tile_h, int tile_w, int wg_stride, int cluster,
                                  void* stream) {
  if (B < 0 || H < 0 || W < 0 || tile_h % 2 || tile_w % 2) return (int)cudaErrorInvalidValue;
  if (B == 0 || H < 2 || W < 2) return (int)cudaSuccess;
  Geometry g{};
  CUtensorMap mx, mw;
  if (!make_geometry(g, cin, cout, bias, bias_bf16, B, H, W, tile_h, tile_w, wg_stride,
                     cluster) ||
      !unit_maps(&mx, &mw, x, w, cin, cout, B, H, W, n, tile_h, tile_w + 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  switch (n) {
    case 48: return launch_cluster(a_unit_wgmma_kernel<48>, Tile<48>::SMEM, g, 48, st, mx, mw, o);
    case 64: return launch_cluster(a_unit_wgmma_kernel<64>, Tile<64>::SMEM, g, 64, st, mx, mw, o);
    case 96: return launch_cluster(a_unit_wgmma_kernel<96>, Tile<96>::SMEM, g, 96, st, mx, mw, o);
    case 192:
      return launch_cluster(a_unit_wgmma_kernel<192>, Tile<192>::SMEM, g, 192, st, mx, mw, o);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The A unit's pixel layer (im2col body), bfloat16 compute.  x (E): (B, H,
// W, cin) bfloat16, 1 <= cin <= 7; w (9, Cp, cin) bfloat16; bias and out as
// above.  tile_w 16, 32 or 64 (128 / tile_w rows a tile); blocks: the grid's
// blocks along the tiles (each walks every blocks-th tile).
extern "C" int eigen_a_unit_im2col(const void* x, const void* w, int cin, int cout,
                                   const void* bias, int bias_bf16, void* out, int B, int H,
                                   int W, int n, int tile_w, int blocks, void* stream) {
  if (B < 0 || H < 0 || W < 0 || cin < 1 || cin > IM2COL_MAX_CIN || cout < 1 || blocks < 1 ||
      !(tile_w == 16 || tile_w == 32 || tile_w == 64))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H < 2 || W < 2) return (int)cudaSuccess;
  const int tile_h = 2 * TM / tile_w;
  if ((tile_h + 2) * (tile_w + 2) * cin * 2 > IM2COL_HALO) return (int)cudaErrorInvalidValue;
  Geometry g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.cin = cin;
  g.cout = cout;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_x = (W + tile_w - 1) / tile_w;
  g.tiles_y = (H + tile_h - 1) / tile_h;
  g.tiles = B * g.tiles_x * g.tiles_y;
  g.bias = bias;
  g.bias_bf16 = bias_bf16;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 48: return launch_im2col_n<48>(x, w, out, g, blocks, st);
    case 64: return launch_im2col_n<64>(x, w, out, g, blocks, st);
    case 96: return launch_im2col_n<96>(x, w, out, g, blocks, st);
    case 192: return launch_im2col_n<192>(x, w, out, g, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
