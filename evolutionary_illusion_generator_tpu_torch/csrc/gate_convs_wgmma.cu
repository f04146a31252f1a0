// The True route's gate convs on the warpgroup tensor cores: the split gate
// convolutions of one ConvLSTM layer (E, R and R_above, each a 3x3 SAME
// conv), each source's conv summed in float32 and rounded to bfloat16, then
// E's + the bias, + R's, + R_above's, each add rounded to bfloat16; the
// gates written out gate-major [i | f | o | g] in bfloat16 for
// csrc/lstm_gates.cu to read.  ops/convlstm_narrow.py::gate_plan picks this
// body (bfloat16 compute, C >= 32, every source's channels a multiple of 8)
// or csrc/convlstm_narrow.cu's gate_convs_kernel (the mma.sync body: float32
// compute with its compensated sums, C < 32, sources the TMA cannot
// address) on the host, from the layer's shape, channels and compute type,
// never from the batch and never after a failure.
//
// Replaces no TPU kernel: the JAX package leaves use_pallas=True's split
// convs to XLA (evolutionary_illusion_generator_tpu/models/prednet/model.py,
// prednet_step) and then runs the Pallas gate kernel
// (ops/convlstm_pallas.py::fused_lstm_gates, here csrc/lstm_gates.cu, which
// stays the route's second launch).  This is the redesign for Hopper of the
// mma.sync body on the wide layers, where that body lost to cuDNN's convs.
//
// Bound on the H100: operations.  At the main path's layer 1 (8 x 60x80,
// sources 96 + 48 + 96, R_above's at half resolution, C 48) a launch is 2 x
// 9 x 240 x 192 products a pixel, 31.9 GFLOP, 32 us at the 989 TFLOP/s
// peak, against 8.5 us to read the sources once and write the gates (28.5
// MB at 3.35 TB/s).  What held the mma.sync body back there: blocks of 128
// pixels x 32 channels staged every source's halo slab again for each group
// of 32 channels (two groups at C 48, three at 96, six at 192), with
// cp.async two chunks deep and a block barrier every chunk.  What holds this
// body back, measured on an H100 (scripts/fused_breakdown.py --body gates):
// the weight slices' loads, whose latency the ring does not hide (without
// them a north-star launch runs a quarter to a third faster), and the
// epilogue, which nothing overlaps.
//
// Design: the wgmma body of csrc/convlstm_fused.cu (its notes set the parts
// out), with its sums, R_above and its epilogue changed:
//   - A block owns a tile_h x tile_w tile of one image and CG = 48, 32 or
//     16 channels with their four gates (N = 4 CG; n = 4 (c - c0) + gate,
//     the (9, C, 4, cin) weight layout); its two warpgroups take their 64 M
//     rows from the halo slab, a tap (ky, kx) is the A descriptor's start
//     moved by ky * slab_w + kx rows.  The TMA fills a ring of three chunks
//     (four at N 128) of 16 input channels (the slab at (k0, x0 - 1,
//     y0 - 1, b), zeros for the SAME padding and past cin), the weight
//     slices multicast across a cluster of two.  The tile and CG come from
//     the host plan.
//   - Sums: one float32 chain a source.  A source's chunks and taps go into
//     one accumulator (scale-d 0 on its first product), and the next
//     chunk's nine products are issued while the last one's still run
//     (wgmma.wait_group 1 frees the slot before).  At the source's last
//     chunk the accumulator is rounded to bfloat16 and added into the
//     running gates, which are bfloat16 pairs in registers (N / 4 a thread
//     beside the N / 2 accumulators; they start as the rounded bias).  A
//     bfloat16 sum keeps 8 bits, far coarser than the chain's float32
//     error; the chain's order (source, chunk, tap, the instruction's 16
//     products) is the same for a pixel whatever the batch, the tile, the
//     channel group or the grid.
//   - R_above at half resolution: its chunk's box of coarse pixels (rows
//     (y0 - 1) >> 1 .., columns (x0 - 1) >> 1 .., tile_h / 2 + 2 by
//     tile_w / 2 + 2) lands by TMA beside the ring, unswizzled, and the
//     block's threads expand it 2x into the slot's slab rows, fine pixel
//     (y, x) from coarse pixel (y >> 1, x >> 1), swizzled as the TMA writes
//     a slab, while the chunk before it is on the tensor cores; a proxy
//     fence and a block barrier hand them to wgmma.  No upsampled copy is
//     written or read.  (Waiting for and expanding the next chunk a chunk
//     ahead measured slower at the north star's layer 1:
//     scripts/fused_breakdown.py's "expansion ahead".)
//   - The ring's slot is handed back by a cluster barrier a chunk whose
//     arrival is relaxed (it orders no write: the products' reads are
//     done); the release arrival cost a fifth of the time at the north
//     star's layers (scripts/fused_breakdown.py --body gates).
//   - Epilogue: the gates into the ring (its chunks are done) as a row of
//     [gate][CG] bfloat16 a pixel, then 16-byte stores of each pixel's run
//     of CG channels of a gate.
// A cluster's padding block (an odd tile count) loads and computes like the
// others and writes nothing.  A deadlocked ring traps once the products are
// done (mbar_wait_or_flag).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 64;         // M rows of a warpgroup's products
constexpr int WGS = 2;         // warpgroups per block
constexpr int NT = 128 * WGS;
constexpr int KC = 16;         // input channels per chunk: one k16 step per tap
constexpr int CLUSTER = 2;     // blocks sharing each weight slice
constexpr int SLAB_PX = 264;   // slab pixels a stage holds (convlstm_fused.cu's)
constexpr int SLAB_BYTES = SLAB_PX * 32;
// R_above's box of coarse pixels, (tile_h / 2 + 2) x (tile_w / 2 + 2): at
// most 102 for the tiles of ops/convlstm_fused.py::tile_shapes
constexpr int COARSE_PX = 104;
constexpr int COARSE_BYTES = COARSE_PX * 32;

template <int N>
struct Tile {
  // chunks in the ring: four at N 128 (the weights' latency, not their
  // bytes, held the products: 15% less time at the north star's layer 2
  // than three); at N 192 four do not fit, at N 64 three leave room for a
  // second block an SM, which four would not
  static constexpr int STAGES = N == 128 ? 4 : 3;
  static constexpr int CG = N / 4;
  static constexpr int W_TAP = N * 32;              // one tap's weights, 32-byte rows
  static constexpr int W_BYTES = 9 * W_TAP;
  static constexpr int STAGE = W_BYTES + SLAB_BYTES;  // [tap][n], then the slab; swizzled
  static constexpr int RING = STAGES * STAGE;
  static constexpr int COARSE = RING;               // a coarse box a slot, unswizzled
  static constexpr int BARS = COARSE + STAGES * COARSE_BYTES;  // the ring's mbarriers
  static constexpr int SMEM = BARS + 8 * STAGES;
  static constexpr int OUT_ROW = N + 8;  // the epilogue's bfloat16 a pixel, in the ring
  static_assert(STAGE % 256 == 0 && W_TAP % 256 == 0 && SLAB_BYTES % 256 == 0,
                "TMA destinations and swizzle atoms are 256-byte aligned");
  static_assert(COARSE_BYTES % 128 == 0 && BARS % 8 == 0 && SMEM <= 232448, "shared memory");
  static_assert(WGS * TM * OUT_ROW * 2 <= RING && OUT_ROW * 2 % 16 == 0 && CG * 2 % 16 == 0,
                "the epilogue's rows: in the ring, 16-byte runs");
};

struct Geometry {
  int B, H, W, C;
  int tile_h, tile_w, slab_w, wg_stride;  // the plan's tile (convlstm_fused.cu's notes)
  int tiles_x, tiles_y, tiles;  // tiles = B * tiles_y * tiles_x; blocks past it write nothing
  int slab_bytes;               // the slab box: (tile_h + 2) * slab_w * 32
  int coarse_w, coarse_bytes;   // R_above's box: coarse pixels a row, and its bytes
  int chunks0, chunks1, n_chunks;  // chunks of E and R, and of all the sources
  const void* bias;                // (4C,) gate-major, float32 or bfloat16 (bias_bf16)
  int bias_bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// common.cuh's mbar_wait_or_trap without the trap inside the ring, where a
// group of products is in flight (the compiler waits for the group on the
// trap's path, and at N 128 then serialises every product): a phase still
// open after about 2^32 cycles sets `stuck`, later waits return at once,
// and the kernel traps once its products are done.
__device__ __forceinline__ void mbar_wait_or_flag(unsigned bar, unsigned parity, bool& stuck) {
  const long long start = clock64();
  while (!stuck) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) stuck = true;
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
    gate_convs_wgmma_kernel(const __grid_constant__ CUtensorMap map_x0,
                            const __grid_constant__ CUtensorMap map_x1,
                            const __grid_constant__ CUtensorMap map_x2,
                            const __grid_constant__ CUtensorMap map_w0,
                            const __grid_constant__ CUtensorMap map_w1,
                            const __grid_constant__ CUtensorMap map_w2,
                            __nv_bfloat16* __restrict__ gates_out, Geometry g) {
  using T = Tile<N>;
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
  const int cy0 = (y0 - 1) >> 1, cx0 = (x0 - 1) >> 1;  // R_above's box origin (-1 at an edge)
  const unsigned base = eigen::smem_addr(smem);
  const unsigned bars = base + T::BARS;
  const int coarse_from = g.chunks0 + g.chunks1;  // R_above's first chunk (n_chunks: none)

  // thread 0 asks for chunk kc in slot s: the slab of E or R (R_above's
  // coarse box beside the ring), and every CLUSTER-th tap's weights (from
  // the block's rank on) for both blocks
  auto load_chunk = [&](int s, int kc) {
    const unsigned st = base + s * T::STAGE, bar = bars + 8 * s;
    const CUtensorMap* mx = &map_x0;
    const CUtensorMap* mw = &map_w0;
    unsigned dst = st + T::W_BYTES, bytes = g.slab_bytes;
    int xc = x0 - 1, yc = y0 - 1;
    if (kc >= g.chunks0) {
      kc -= g.chunks0;
      mx = &map_x1;
      mw = &map_w1;
      if (kc >= g.chunks1) {
        kc -= g.chunks1;
        mx = &map_x2;
        mw = &map_w2;
        dst = base + T::COARSE + s * COARSE_BYTES;
        bytes = g.coarse_bytes;
        xc = cx0;
        yc = cy0;
      }
    }
    const int k0 = kc * KC;
    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + bytes);
    eigen::tma_load_4d(dst, mx, bar, k0, xc, yc, b);
    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)
      eigen::tma_load_3d_multicast(st + tap * T::W_TAP, mw, bar, (1 << CLUSTER) - 1, k0, 4 * c0,
                                   tap);
  };

  // R_above's chunk in slot s: slab position p (row r, column col of the
  // box) gets the coarse pixel ((y0 - 1 + r) >> 1, (x0 - 1 + col) >> 1), a
  // 32-byte row whose halves are swizzled as the TMA writes a slab (address
  // bit 4 ^= bit 7, on the absolute address); then the rows are handed to
  // the async proxy and to every thread
  auto expand = [&](int s) {
    const unsigned char* box = smem + T::COARSE + s * COARSE_BYTES;
    const unsigned slab = base + s * T::STAGE + T::W_BYTES;
    for (int i = tid; i < g.slab_bytes / 16; i += NT) {
      const int p = i >> 1, half = i & 1;
      const int r = p / g.slab_w, col = p - r * g.slab_w;
      const int cr = ((y0 - 1 + r) >> 1) - cy0, cc = ((x0 - 1 + col) >> 1) - cx0;
      const uint4 v =
          *reinterpret_cast<const uint4*>(box + (cr * g.coarse_w + cc) * 32 + half * 16);
      const unsigned a = slab + i * 16;
      *reinterpret_cast<uint4*>(smem + ((a ^ ((a >> 3) & 16u)) - base)) = v;
    }
    eigen::fence_proxy_async();
    __syncthreads();
  };

  // the block's M row m (0 .. 127) -> its output pixel, or false
  auto pixel = [&](int m, int& y, int& x) {
    const int p = (m / TM) * g.wg_stride + m % TM;
    const int r = p / g.slab_w, col = p % g.slab_w;
    y = y0 + r;
    x = x0 + col;
    return b < g.B && col < g.tile_w && r < g.tile_h && y < g.H && x < g.W;
  };

  // the running gates, bfloat16 pairs: pair k holds accumulator columns n,
  // n + 1 (n = 8 (k / 2) + 2 tig) of row gid (k even) or gid + 8 (odd),
  // channel c0 + n / 4, gates n % 4 and + 1; they start as the bias rounded
  // to bfloat16 (zeros past C)
  __nv_bfloat162 gates[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int n = 8 * (k >> 1) + 2 * tig;
    const int c = c0 + (n >> 2), gate = n & 3;
    float b0 = 0.0f, b1 = 0.0f;
    if (c < g.C) {
      const int i = gate * g.C + c;
      if (g.bias_bf16) {
        const __nv_bfloat16* bs = static_cast<const __nv_bfloat16*>(g.bias);
        b0 = __bfloat162float(bs[i]);
        b1 = __bfloat162float(bs[i + g.C]);
      } else {
        const float* bs = static_cast<const float*>(g.bias);
        b0 = bs[i];
        b1 = bs[i + g.C];
      }
    }
    gates[k] = __floats2bfloat162_rn(b0, b1);
  }

  // descriptors of slot 0, tap (0, 0); a slot and a tap add their byte
  // offsets / 16 to the start address field
  const uint64_t desc_b = eigen::wgmma_desc(base, 16, 256, eigen::kSwizzle32);
  const uint64_t desc_a = eigen::wgmma_desc(base + T::W_BYTES + wgi * g.wg_stride * 32, 16, 256,
                                            eigen::kSwizzle32);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

  // the 9 products of chunk kc (in its slot) onto the source's chain; the
  // first product of a source (accumulate 0) starts it
  auto products = [&](int kc, int accumulate) {
    const uint64_t slot = (uint64_t)((kc % T::STAGES) * T::STAGE) >> 4;
    eigen::fence_operands(acc);
    eigen::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      eigen::wgmma_bf16<N>(acc, desc_a + slot + (uint64_t)((ky * g.slab_w + kx) * 2),
                           desc_b + slot + (tap * T::W_TAP >> 4), tap > 0 || accumulate);
    }
    eigen::wgmma_commit();
  };
  // the source's conv is complete: rounded to bfloat16 and added into the
  // running gates, the sum rounded to bfloat16
  auto source_done = [&]() {
    eigen::wgmma_wait<0>();
    eigen::fence_operands(acc);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float2 gv = __bfloat1622float2(gates[k]);
      gates[k] = __floats2bfloat162_rn(gv.x + round_bf16(acc[2 * k]),
                                       gv.y + round_bf16(acc[2 * k + 1]));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) eigen::mbar_init(bars + 8 * s, 1);
    eigen::fence_mbarrier_init();
  }
  // every block's mbarriers are initialised before any multicast
  eigen::cluster_arrive();
  eigen::cluster_wait();
  if (tid == 0)
    for (int s = 0; s < T::STAGES - 1 && s < g.n_chunks; ++s) load_chunk(s, s);
  __syncwarp();
  // a source's chunks first .. end - 1, one group of products left in
  // flight from one chunk to the next (one loop a source, so that no branch
  // reads the accumulators while a group runs: the compiler would wait)
  bool stuck = false;
  auto source = [&](int first, int end) {
    for (int kc = first; kc < end; ++kc) {
      mbar_wait_or_flag(bars + 8 * (kc % T::STAGES), (kc / T::STAGES) & 1, stuck);
      if (kc >= coarse_from) expand(kc % T::STAGES);  // under chunk kc - 1's products
      products(kc, kc != first);
      eigen::wgmma_wait<1>();  // chunk kc - 1's products are done; kc's run on
      // every thread of the cluster is done with chunk kc - 1: refill its slot
      eigen::cluster_arrive_relaxed();
      eigen::cluster_wait();
      if (tid == 0 && kc + T::STAGES - 1 < g.n_chunks)
        load_chunk((kc + T::STAGES - 1) % T::STAGES, kc + T::STAGES - 1);
      __syncwarp();
    }
    source_done();
  };
  source(0, g.chunks0);
  source(g.chunks0, coarse_from);
  if (coarse_from < g.n_chunks) source(coarse_from, g.n_chunks);
  if (stuck) __trap();  // a phase of the ring never completed
  if (b >= g.B) return;  // a cluster's padding block

  // the gates into the ring, a row of [gate][CG] a pixel (the last chunk's
  // products are done and the cluster barrier has passed every thread)
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int m = wgi * TM + 16 * q + gid + 8 * (k & 1);
    const int n = 8 * (k >> 1) + 2 * tig;
    const int cl = n >> 2, gate = n & 3;
    out[m * T::OUT_ROW + gate * T::CG + cl] = gates[k].x;
    out[m * T::OUT_ROW + (gate + 1) * T::CG + cl] = gates[k].y;
  }
  __syncthreads();
  // 16-byte runs of 8 channels of one gate of one pixel
  constexpr int RUNS = T::CG / 8;
  for (int i = tid; i < WGS * TM * 4 * RUNS; i += NT) {
    const int m = i / (4 * RUNS), j = i - m * (4 * RUNS);
    const int gate = j / RUNS, cl = 8 * (j - gate * RUNS);
    int y, x;
    if (!pixel(m, y, x) || c0 + cl >= g.C) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(out + m * T::OUT_ROW + gate * T::CG + cl);
    *reinterpret_cast<uint4*>(gates_out + (((long long)b * g.H + y) * g.W + x) * 4 * g.C +
                              gate * g.C + c0 + cl) = v;
  }
}

template <int N>
int launch_n(const CUtensorMap* maps, void* gates_out, const Geometry& g, void* stream) {
  const auto kernel = gate_convs_wgmma_kernel<N>;
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<N>::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((g.tiles + CLUSTER - 1) / CLUSTER * CLUSTER),
                     (unsigned)((g.C + Tile<N>::CG - 1) / Tile<N>::CG));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Tile<N>::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                          static_cast<__nv_bfloat16*>(gates_out), g);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x0 (E): (B, H, W, cin0); x1 (R): (B, H, W, cin1); x2 (R_above, n_src = 3
// only): (B, H/2, W/2, cin2), H and W even; all bfloat16, every cin a
// multiple of 8, with weights w_s (9, C, 4, cin_s) bfloat16, every x_s and
// w_s 16-byte aligned.  bias: (4C,) gate-major, float32 or bfloat16
// (bias_bf16 != 0), rounded to bfloat16.  gates_out: (B, H, W, 4C)
// gate-major bfloat16, 16-byte aligned; C a multiple of 8.  cg 16, 32 or 48
// channels a block; the tile tile_h x tile_w with the warpgroups wg_stride
// slab positions apart, as ops/convlstm_fused.py::tile_shapes makes them.
// Anything else returns cudaErrorInvalidValue.  Launches on `stream` and
// returns the CUDA error of the launch.
extern "C" int eigen_gate_convs_wgmma(const void* x0, const void* w0, int cin0, const void* x1,
                                      const void* w1, int cin1, const void* x2, const void* w2,
                                      int cin2, int n_src, const void* bias, int bias_bf16,
                                      void* gates_out, int B, int H, int W, int C, int cg,
                                      int tile_h, int tile_w, int wg_stride, void* stream) {
  const int slab_w = tile_w + 2;
  const bool two_rows = tile_w == TM && wg_stride == slab_w && tile_h == 2;
  const bool run_on = wg_stride == TM && slab_w <= TM && tile_h >= 1 &&
                      tile_h * slab_w <= 2 * TM + 2;
  const int coarse_w = tile_w / 2 + 2, coarse_h = tile_h / 2 + 2;
  if (n_src < 2 || n_src > 3 || B < 0 || H < 0 || W < 0 || C < 0 || C % 8 != 0 ||
      !(two_rows || run_on) || !eigen::igemm::aligned16(gates_out) ||
      (n_src == 3 && (H % 2 != 0 || W % 2 != 0 || coarse_w * coarse_h > COARSE_PX)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  const void* xs[3] = {x0, x1, x2};
  const void* ws[3] = {w0, w1, w2};
  const int cins[3] = {cin0, cin1, cin2};
  CUtensorMap maps[6];
  int chunks[3] = {0, 0, 0};
  for (int s = 0; s < 3; ++s) {
    const int src = s < n_src ? s : 0;  // an unused map repeats source 0
    const int cin = cins[src];
    const bool coarse = s == 2 && n_src == 3;
    if (cin < 1 || cin % 8 != 0 || !eigen::igemm::aligned16(xs[src]) ||
        !eigen::igemm::aligned16(ws[src]))
      return (int)cudaErrorInvalidValue;
    const cuuint64_t Ws = coarse ? W / 2 : W, Hs = coarse ? H / 2 : H;
    const cuuint64_t pix = (cuuint64_t)cin * 2;
    const cuuint64_t dx[4] = {(cuuint64_t)cin, Ws, Hs, (cuuint64_t)B};
    const cuuint64_t sx[3] = {pix, pix * Ws, pix * Ws * Hs};
    const cuuint32_t fine[4] = {KC, (cuuint32_t)slab_w, (cuuint32_t)tile_h + 2, 1};
    const cuuint32_t box[4] = {KC, (cuuint32_t)coarse_w, (cuuint32_t)coarse_h, 1};
    const cuuint64_t dw[3] = {(cuuint64_t)cin, 4 * (cuuint64_t)C, 9};
    const cuuint64_t sw[2] = {pix, pix * 4 * C};
    const cuuint32_t bw[3] = {KC, 4 * (cuuint32_t)cg, 1};
    if (!eigen::tensor_map(&maps[s], xs[src], 4, dx, sx, coarse ? box : fine,
                           coarse ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_32B) ||
        !eigen::tensor_map(&maps[3 + s], ws[src], 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
    if (s < n_src) chunks[s] = (cin + KC - 1) / KC;
  }
  Geometry g{};
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
  g.coarse_w = coarse_w;
  g.coarse_bytes = coarse_w * coarse_h * 32;
  g.chunks0 = chunks[0];
  g.chunks1 = chunks[1];
  g.n_chunks = chunks[0] + chunks[1] + chunks[2];
  g.bias = bias;
  g.bias_bf16 = bias_bf16;
  switch (cg) {
    case 16: return launch_n<64>(maps, gates_out, g, stream);
    case 32: return launch_n<128>(maps, gates_out, g, stream);
    case 48: return launch_n<192>(maps, gates_out, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
