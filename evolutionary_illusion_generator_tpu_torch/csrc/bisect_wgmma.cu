// The six conv rungs of the kernel-bisection ladder (C, D, H, E, I and J) on
// Hopper's warpgroup tensor cores (wgmma): one kernel behind the C entries
// eigen_bisect_c, _d, _h, _e, _i and _j.
//
// Replaces scripts/pallas_bisect.py::variant_C (:104; the 3x3 SAME conv of
// the padded input xp + bias -> float32 gates (B, H, W, 4C), gate order
// [i | f | o | g]), ::variant_D (:151; the same conv, the gate
// nonlinearities and the cell update -> h in the state's type, c float32),
// ::variant_H (:192; D's function over row blocks of `rows` rows, read from
// the window stack xh (B, H / rows, rows + 2, W + 2, Cin): the overlapped
// row windows of xp, materialised), ::variant_E (:245; D's function over
// the same row blocks, each DMA'd from xp), ::variant_E2 (:300, ladder key
// J; E over xp of the aligned width Wp = ceil16(W + 2), whose columns past
// W + 1 are zeros) and ::variant_H2 (:365, ladder key I; H at Wp).  Rung A
// is in convlstm_bisect.cu; the wrappers, plain versions and host glue in
// ops/convlstm_bisect.py.
//
// The kernel addresses its input as windows: `windows` windows of rows + 2
// padded rows of `pitch` pixels, each giving `rows` output rows, window
// `win` starting `step` padded rows after window win - 1, in an image of
// img_rows padded rows.  Three layouts, one addressing:
//   - xp as one window of H rows (C, D);
//   - xp as H / rows windows that overlap by two rows, step = rows (E, J);
//   - the stack xh, H / rows windows back to back, step = rows + 2 (H, I).
// A block's two output rows are a row pair of one window, and a window of
// odd `rows` ends on a pair whose second row it does not own: that row's
// warpgroup computes on what lies past the window (the next window's rows,
// or zeros past the image or in the cp.async loop) and writes nothing.
//
// Bound on the H100: operations.  At the ladder's --big shape (B 25, 240 x
// 320, Cin 240, C 48) a call is 1.59 TFLOP of bfloat16 products, 1.61 ms at
// the 989 TFLOP/s peak, against 0.72 ms to read xp and write the gates once
// at 3.35 TB/s (xh at rows 48 is 3% more bytes than xp, 8% at I's width;
// J's xp is 4% more).  The warpgroup product (wgmma) is the only instruction
// that reaches that peak, so the products run on it.
//
// Design.  An implicit GEMM: M = output pixels, N = gate outputs, K = 9 taps
// x Cin, walked in chunks of 16 input channels, one k16 step per tap.
//   - A block owns two image rows of 64 pixels each (one warpgroup a row: the
//     M = 64 of its products) and a group of CG channels with all four gates,
//     N = 4 CG gate outputs (n = 4 (c - c0) + gate): CG = 48 (N = 192) when
//     C >= 48, so that at --big one block stages each input pixel once, not
//     three times as with 16 channels.  Wider C is split into channel groups;
//     channels past C have zero weights and are masked.  Ragged W is masked.
//   - Per chunk and warpgroup, 9 wgmma.m64nNk16 (one a tap) read A and B
//     from shared memory into fresh float32 accumulators (scale-d 0 on the
//     first), which are added to float32 totals after wgmma.wait_group: two
//     levels of sums, as the fused kernel has, so no accumulator chain is
//     longer than 9 products (a chain of 135 tensor-core products drifts
//     from float64 sums further than the plain version; PERF.md).
//     The accumulators and totals of a 64 x 192 tile are 192 registers a
//     thread, so a block is two warpgroups and an SM holds one block.
//   - Staging is what bounds it (PERF.md: on the H100 the products alone
//     take 2.3 ms at --big): with 128 pixels a block, the blocks together read
//     12.4 GB of weight slices from L2 a call (55 KB a chunk).  So one thread
//     of each block asks the TMA for each chunk, into a ring of three chunks,
//     completing an mbarrier: the halo slab (4 rows x 66 pixels x 16
//     channels: a rank-4 map {Cin, pitch, img_rows, B} at row
//     win * step + yw) and the weights (9 x N x 16), where two blocks of
//     neighbouring tiles form a cluster and each loads every other tap's
//     weights for both (multicast), so each block asks for half.  The TMA
//     fills zeros past the input's edges, past Cin and past 4C.  Both
//     operands are in wgmma's K-major 32-byte-swizzle layout: a pixel's (or
//     an output's) 16 channels are one 32-byte row, so the TMA moves 32-byte
//     rows (16-byte rows, the no-swizzle layout, took 1.5 ms more), and a
//     tap's shift (ky, kx) moves the A descriptor's start by (ky * 66 + kx)
//     rows: no copy per tap.  A slot is refilled once both blocks of the
//     cluster are done with it (the cluster barrier, split so that its wait
//     overlaps the products).
//     A Cin that is not a multiple of 8 has rows the TMA cannot address
//     (16-byte strides); that shape takes a second main loop, chosen on the
//     host by shape, that stages the same layout with cp.async / st.shared
//     and a barrier a chunk, one block a cluster.
//   - The epilogue is not overlapped (one block an SM), so it is kept short:
//     the totals go through shared memory as [pixel][gate][channel], padded
//     so that the fragments' stores and the epilogue's reads are free of bank
//     conflicts, and the writes coalesce as streaming stores: C writes bias +
//     gates, 16 bytes a store; the others compute the gates and the cell
//     update, one thread a (pixel, channel), from a c_prev tile that cp.async
//     brought into shared memory while the products ran.
// At even `rows` the row-block rungs (H, E, I, J) compute exactly D's tiles,
// in D's order and with D's sums: their outputs equal D's bit for bit, only
// the addresses of their slabs differ.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 64;                  // pixels per warpgroup: one image row, the wgmma M
constexpr int WGS = 2;                  // warpgroups per block, one image row each
constexpr int NT = 128 * WGS;
constexpr int KC = 16;                  // input channels per chunk: one k16 step per tap
constexpr int STAGES = 3;               // chunks in the ring
constexpr int CLUSTER = 2;              // blocks sharing each weight slice (TMA main loop)
constexpr int SLAB_H = WGS + 2, SLAB_W = TM + 2;
constexpr int SLAB_PX = SLAB_H * SLAB_W;
constexpr int SLAB_BYTES = SLAB_PX * 32;  // 16 channels, 32 bytes a pixel
constexpr int MAX_CG = 48;              // channels per block at most (N = 192)

template <int N>
struct Tile {
  static constexpr int CG = N / 4;
  static constexpr int W_TAP = N * 32;             // bytes: one tap's weights, 32-byte rows
  static constexpr int W_BYTES = 9 * W_TAP;
  static constexpr int STAGE = W_BYTES + SLAB_BYTES;  // [tap][n], then [px]; swizzled
  // epilogue: ep[pixel][gate][channel], floats; a gate's row is CG + 1 long
  // and a pixel's 4 of them, so that the accumulator fragments' stores and
  // the epilogue's reads each fall in 32 distinct banks
  static constexpr int EG = CG + 1;
  static constexpr int EP = 4 * EG;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int EPI = (WGS * TM * EP + N) * 4;  // epilogue rows, then the bias
  static constexpr int CPREV = RING > EPI ? RING : EPI;  // D's c_prev tile, past both
  static constexpr int BARS = CPREV + WGS * TM * CG * 4;  // the mbarriers
  static constexpr int SMEM = BARS + 8 * STAGES;
  static_assert(STAGE % 256 == 0 && W_TAP % 256 == 0 && SLAB_BYTES % 256 == 0,
                "TMA destinations and swizzle atoms are 256-byte aligned");
};

struct Geometry {
  int B, H, W, cin, C;
  int pitch;    // pixels per input row: W + 2, or Wp (rungs I and J)
  int rows;     // output rows per input window: H for C and D, else the row-block height
  int windows;  // input windows per image (rows + 2 padded rows each): H / rows
  int step;     // padded rows from a window's start to the next one's: rows (xp), rows + 2 (xh)
  int img_rows;  // padded input rows per image: H + 2 (xp), windows * (rows + 2) (xh)
  int tiles_x, row_pairs;  // 64-pixel tiles of a row; ceil(rows / 2) per window
  int tiles;  // B * windows * row_pairs * tiles_x: blocks past it (cluster padding) write nothing
  int cprev_vec;           // D: c_prev's pixel rows are 16-byte aligned, staged with cp.async
};

// D: the state and h
template <typename ST>
struct Cell {
  const ST* c_prev;
  ST* h_out;
};

template <int N, bool TMA, bool FUSE, typename ST>
__global__ void __launch_bounds__(NT, 1)
    wgmma_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __nv_bfloat16* __restrict__ xin, const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ bias, Cell<ST> cell, float* __restrict__ out,
                      Geometry g) {
  using T = Tile<N>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // the warpgroup's image row in the block
  const int q = (tid >> 5) & 3;     // warp in the warpgroup: accumulator rows 16 q ..
  const int lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * T::CG;
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int yw = 2 * (t % g.row_pairs);  // the slab's first row in its window
  t /= g.row_pairs;
  const int win = t % g.windows;
  const int b = t / g.windows;      // >= B for a cluster's padding block
  const int y0 = win * g.rows + yw;  // warpgroup 0's output row
  const int y_end = (win + 1) * g.rows;  // the window's output rows end here
  const int x0 = tx * TM;
  const int nk = (g.cin + KC - 1) / KC;
  const unsigned base = eigen::smem_addr(smem);
  const unsigned bars = base + T::BARS;

  // TMA path: thread 0 asks for chunk kc in slot s: the slab, and every
  // CLUSTER-th tap's weights (from its rank on) for every block of the
  // cluster
  auto load_chunk = [&](int s, int kc) {
    const unsigned st = base + s * T::STAGE, bar = bars + 8 * s;
    const int k0 = kc * KC;
    eigen::mbar_arrive_expect_tx(bar, T::STAGE);
    eigen::tma_load_4d(st + T::W_BYTES, &map_x, bar, k0, x0, win * g.step + yw, b);
    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)
      eigen::tma_load_3d_multicast(st + tap * T::W_TAP, &map_w, bar, (1 << CLUSTER) - 1, k0,
                                   4 * c0, tap);
  };

  // cp.async path (Cin % 8 != 0 takes its st.shared branch): every thread
  // stages its share of chunk kc in slot s
  const __nv_bfloat16* slab_src =
      xin + ((long long)b * g.img_rows + win * g.step + yw) * g.pitch * g.cin;
  const bool vec = g.cin % 8 == 0;
  auto stage = [&](int s, int kc) {
    unsigned char* st = smem + s * T::STAGE;
    const int k0 = kc * KC;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    // weights: row n of tap `tap` is wt[tap][c][gate][k0 .. k0 + 16), two
    // 16-byte pieces, placed as the TMA's 32-byte swizzle places them
    for (int i = tid; i < 9 * N * 2; i += NT) {
      const int half = i & 1, row = i >> 1;
      const int n = row % N, tap = row / N;
      const int c = c0 + n / 4, k = k0 + 8 * half;
      __nv_bfloat16* dst =
          reinterpret_cast<__nv_bfloat16*>(st + eigen::swizzle32(row * 32 + half * 16));
      const __nv_bfloat16* src = wt + (((long long)tap * g.C + c) * 4 + n % 4) * g.cin + k;
      if (vec) {
        const bool valid = c < g.C && k < g.cin;
        eigen::cp_async16(dst, valid ? src : wt, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (c < g.C && k + e < g.cin) ? src[e] : zero;
      }
    }
    // the halo slab: rows yw .. yw + 3 of the window, columns x0 .. x0 + 65
    for (int i = tid; i < SLAB_PX * 2; i += NT) {
      const int half = i & 1, px = i >> 1;
      const int row = px / SLAB_W, col = x0 + px % SLAB_W, k = k0 + 8 * half;
      const bool inside = b < g.B && yw + row < g.rows + 2 && col < g.pitch;
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
          st + T::W_BYTES + eigen::swizzle32(px * 32 + half * 16));
      const __nv_bfloat16* src = slab_src + ((long long)row * g.pitch + col) * g.cin + k;
      if (vec) {
        const bool valid = inside && k < g.cin;
        eigen::cp_async16(dst, valid ? src : xin, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (inside && k + e < g.cin) ? src[e] : zero;
      }
    }
  };

  // descriptors of slot 0, tap (0, 0); a slot and a tap add their byte
  // offsets / 16 to the start address field
  const uint64_t desc_b = eigen::wgmma_desc(base, 16, 256, eigen::kSwizzle32);
  const uint64_t desc_a =
      eigen::wgmma_desc(base + T::W_BYTES + wg * SLAB_W * 32, 16, 256, eigen::kSwizzle32);

  // D: the block's c_prev tile, [pixel][CG] in the state's type, lands in
  // shared memory while the products run (the epilogue's loads would
  // otherwise wait on device memory with only 8 warps an SM)
  ST* cps = reinterpret_cast<ST*>(smem + T::CPREV);
  if constexpr (FUSE) {
    if (g.cprev_vec) {
      constexpr int PIECES = T::CG * (int)sizeof(ST) / 16;  // per pixel
      constexpr int PER = 16 / (int)sizeof(ST);             // channels per piece
      for (int i = tid; i < WGS * TM * PIECES; i += NT) {
        const int m = i / PIECES, p = i % PIECES;
        const int y = y0 + m / TM, x = x0 + m % TM, c = c0 + PER * p;
        const bool valid = b < g.B && y < y_end && x < g.W && c < g.C;
        const ST* src = cell.c_prev + (((long long)b * g.H + y) * g.W + x) * g.C + c;
        eigen::cp_async16(cps + m * T::CG + PER * p, valid ? src : cell.c_prev, valid);
      }
    }
    eigen::cp_async_commit();
  }

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
      eigen::wgmma_bf16<N>(acc, desc_a + slot + ((ky * SLAB_W + kx) * 32 >> 4),
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

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) eigen::mbar_init(bars + 8 * s, 1);
      eigen::fence_mbarrier_init();
    }
    // every block's mbarriers are initialised before any multicast
    eigen::cluster_arrive();
    eigen::cluster_wait();
    if (tid == 0)
      for (int s = 0; s < STAGES - 1 && s < nk; ++s) load_chunk(s, s);
    __syncwarp();
    eigen::cluster_arrive();  // pairs with the first wait below
    for (int kc = 0; kc < nk; ++kc) {
      eigen::mbar_wait(bars + 8 * (kc % STAGES), (kc / STAGES) & 1);
      products(kc);
      // every thread of the cluster is done with chunk kc - 1: refill its slot
      eigen::cluster_wait();
      if (tid == 0 && kc + STAGES - 1 < nk)
        load_chunk((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
      __syncwarp();
      add();
      eigen::cluster_arrive();
    }
    eigen::cluster_wait();  // no block's copies into another's ring are left
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage(s, s);
      eigen::cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      eigen::cp_async_wait<STAGES - 2>();  // chunk kc has landed (this thread's pieces)
      eigen::fence_proxy_async();          // ... and is visible to wgmma
      __syncthreads();                     // every thread's; chunk kc - 1's slot is free
      products(kc);
      if (kc + STAGES - 1 < nk) stage((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
      eigen::cp_async_commit();            // an empty group at the tail keeps the count
      add();
    }
    eigen::cp_async_wait<0>();
    __syncthreads();  // every warpgroup is done with the ring: the epilogue reuses it
  }

  // accumulator fragment -> ep (pixel = 64 wg + row, output n = 4 channel +
  // gate); the bias -> sb[gate][channel]
  float* ep = reinterpret_cast<float*>(smem);
  float* sb = ep + WGS * TM * T::EP;
  const int m0 = wg * TM + 16 * q + gid;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * tig + (e & 1), m = m0 + 8 * (e >> 1);
      ep[m * T::EP + (n % 4) * T::EG + n / 4] = tot[4 * j + e];
    }
  }
  for (int n = tid; n < N; n += NT) {
    const int gate = n / T::CG, c = c0 + n % T::CG;
    sb[n] = c < g.C ? bias[gate * g.C + c] : 0.0f;
  }
  if constexpr (FUSE) eigen::cp_async_wait<0>();  // the c_prev tile
  __syncthreads();
  if (b >= g.B) return;  // a cluster's padding block

  if constexpr (FUSE) {
    // one (pixel, channel) a step
    for (int i = tid; i < WGS * TM * T::CG; i += NT) {
      const int cl = i % T::CG, m = i / T::CG;
      const int y = y0 + m / TM, x = x0 + m % TM, c = c0 + cl;
      if (y >= y_end || x >= g.W || c >= g.C) continue;
      const float* e = ep + m * T::EP + cl;
      const float gi = e[0] + sb[cl], gf = e[T::EG] + sb[T::CG + cl];
      const float go = e[2 * T::EG] + sb[2 * T::CG + cl], gg = e[3 * T::EG] + sb[3 * T::CG + cl];
      const long long o = (((long long)b * g.H + y) * g.W + x) * g.C + c;
      const float cp = eigen::to_float(g.cprev_vec ? cps[m * T::CG + cl] : cell.c_prev[o]);
      const float cn = eigen::sigmoid(gf) * cp + eigen::sigmoid(gi) * tanhf(gg);
      __stcs(out + o, cn);  // streaming stores: the kernel reads none of its outputs
      __stcs(cell.h_out + o, eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn)));
    }
  } else if (g.C % 4 == 0) {
    // four channels of one gate a step, one 16-byte store; consecutive
    // threads take the four gates, then the next four channels, so a warp
    // writes four runs of 32 floats of one pixel
    constexpr int Q = T::CG / 4;
    for (int i = tid; i < WGS * TM * 4 * Q; i += NT) {
      const int gate = i % 4, cq = (i / 4) % Q, m = i / (4 * Q);
      const int y = y0 + m / TM, x = x0 + m % TM, c = c0 + 4 * cq;
      if (y >= y_end || x >= g.W || c >= g.C) continue;
      const float* e = ep + m * T::EP + gate * T::EG + 4 * cq;
      const float4 bv = *reinterpret_cast<const float4*>(sb + gate * T::CG + 4 * cq);
      __stcs(reinterpret_cast<float4*>(out + (((long long)b * g.H + y) * g.W + x) * 4 * g.C +
                                       gate * g.C + c),
             make_float4(e[0] + bv.x, e[1] + bv.y, e[2] + bv.z, e[3] + bv.w));
    }
  } else {
    // consecutive threads: the four gates of consecutive channels, so a warp
    // writes four runs of 8 floats of one pixel
    for (int i = tid; i < WGS * TM * N; i += NT) {
      const int n = i % N, m = i / N;
      const int y = y0 + m / TM, x = x0 + m % TM, c = c0 + n / 4, gate = n % 4;
      if (y >= y_end || x >= g.W || c >= g.C) continue;
      __stcs(out + (((long long)b * g.H + y) * g.W + x) * 4 * g.C + gate * g.C + c,
             ep[m * T::EP + gate * T::EG + n / 4] + sb[gate * T::CG + n / 4]);
    }
  }
}

template <int N, bool FUSE, typename ST>
int launch_n(const void* xin, const void* wt, const void* bias, Cell<ST> cell, void* out,
             Geometry g, void* stream) {
  const bool tma = g.cin % 8 == 0;  // 16-byte row strides: the TMA can address the input and wt
  CUtensorMap map_x{}, map_w{};
  if (tma) {
    // {cin, pitch, img_rows, B}, innermost first: xp or xh, whose windows'
    // rows the kernel addresses
    const cuuint64_t pix = (cuuint64_t)g.cin * 2, row = pix * g.pitch;
    const cuuint64_t dx[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.pitch, (cuuint64_t)g.img_rows,
                              (cuuint64_t)g.B};
    const cuuint64_t sx[3] = {pix, row, row * g.img_rows};
    const cuuint32_t bx[4] = {KC, SLAB_W, SLAB_H, 1};
    const cuuint64_t dw[3] = {(cuuint64_t)g.cin, 4 * (cuuint64_t)g.C, 9};
    const cuuint64_t sw[2] = {pix, pix * 4 * g.C};
    const cuuint32_t bw[3] = {KC, (cuuint32_t)N, 1};
    if (!eigen::tensor_map(&map_x, xin, 4, dx, sx, bx, CU_TENSOR_MAP_SWIZZLE_32B) ||
        !eigen::tensor_map(&map_w, wt, 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_32B))
      return (int)cudaErrorInvalidValue;
  }
  const int cluster = tma ? CLUSTER : 1;
  const unsigned blocks = (unsigned)((g.tiles + cluster - 1) / cluster * cluster);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks, (unsigned)((g.C + Tile<N>::CG - 1) / Tile<N>::CG));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Tile<N>::SMEM;  // above the 48 KB of static shared memory
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto kernel = tma ? wgmma_conv_kernel<N, true, FUSE, ST> : wgmma_conv_kernel<N, false, FUSE, ST>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Tile<N>::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, (const __nv_bfloat16*)xin,
                          (const __nv_bfloat16*)wt, (const float*)bias, cell, (float*)out, g);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// Channels per block: 16, 32 or 48, for the fewest channel groups, then the
// fewest padded channels.
int channel_group(int C) {
  const int groups = (C + MAX_CG - 1) / MAX_CG;
  const int per = (C + groups - 1) / groups;
  return per <= 16 ? 16 : per <= 32 ? 32 : 48;
}

// The input is H / rows windows of rows + 2 padded rows of `pitch` pixels:
// the stack xh (`stack`), or xp (B, H + 2, pitch, cin), whose windows
// overlap by two rows (one window of H rows for C and D).
template <bool FUSE, typename ST>
int launch(const void* xin, const void* wt, const void* bias, Cell<ST> cell, void* out, int B,
           int H, int W, int cin, int C, int pitch, int rows, bool stack, void* stream) {
  if (B < 0 || H < 0 || W < 0 || cin < 1 || C < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  if (rows < 1 || H % rows != 0 || pitch < W + 2) return (int)cudaErrorInvalidValue;
  const int windows = H / rows;
  Geometry g{B, H, W, cin, C, pitch, rows, windows, stack ? rows + 2 : rows,
             stack ? windows * (rows + 2) : H + 2, (W + TM - 1) / TM, (rows + 1) / 2, 0, 0};
  g.tiles = B * g.windows * g.row_pairs * g.tiles_x;
  g.cprev_vec = C * (int)sizeof(ST) % 16 == 0 &&
                reinterpret_cast<std::uintptr_t>(cell.c_prev) % 16 == 0;
  switch (channel_group(C)) {
    case 16: return launch_n<64, FUSE, ST>(xin, wt, bias, cell, out, g, stream);
    case 32: return launch_n<128, FUSE, ST>(xin, wt, bias, cell, out, g, stream);
    default: return launch_n<192, FUSE, ST>(xin, wt, bias, cell, out, g, stream);
  }
}

// D, H, E, I and J: the conv, the gates and the cell update, in the state's type
int fused(const void* xin, const void* wt, const void* bias, const void* c_prev, int state_bf16,
          void* h_out, void* c_out, int B, int H, int W, int cin, int C, int pitch, int rows,
          bool stack, void* stream) {
  if (state_bf16)
    return launch<true, __nv_bfloat16>(
        xin, wt, bias,
        Cell<__nv_bfloat16>{(const __nv_bfloat16*)c_prev, (__nv_bfloat16*)h_out}, c_out, B, H, W,
        cin, C, pitch, rows, stack, stream);
  return launch<true, float>(xin, wt, bias, Cell<float>{(const float*)c_prev, (float*)h_out},
                             c_out, B, H, W, cin, C, pitch, rows, stack, stream);
}

}  // namespace

// xp: (B, H + 2, pitch, cin) bfloat16, the zero-padded input (pitch = W + 2,
// or wp for J); xh: (B, H / rows, rows + 2, pitch, cin) bfloat16, the window
// stack (pitch = W + 2 for H, wp for I); H % rows == 0 for the row-block
// rungs; wt: (9, C, 4, cin) bfloat16, [tap][channel][gate][input channel];
// bias: (4C,) float32; gates (C): (B, H, W, 4C) float32; c_prev and h_out
// (D, H, E, I, J): (B, H, W, C) float32 or bfloat16 (state_bf16 != 0);
// c_out: (B, H, W, C) float32.  All contiguous, the input and wt 16-byte
// aligned.  Each launches on `stream` and returns the CUDA error of the
// launch.
extern "C" int eigen_bisect_c(const void* xp, const void* wt, const void* bias, void* gates,
                              int B, int H, int W, int cin, int C, void* stream) {
  return launch<false, float>(xp, wt, bias, Cell<float>{nullptr, nullptr}, gates, B, H, W, cin, C,
                              W + 2, H, false, stream);
}

extern "C" int eigen_bisect_d(const void* xp, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, void* stream) {
  return fused(xp, wt, bias, c_prev, state_bf16, h_out, c_out, B, H, W, cin, C, W + 2, H, false,
               stream);
}

extern "C" int eigen_bisect_h(const void* xh, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, void* stream) {
  return fused(xh, wt, bias, c_prev, state_bf16, h_out, c_out, B, H, W, cin, C, W + 2, rows, true,
               stream);
}

extern "C" int eigen_bisect_e(const void* xp, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, void* stream) {
  return fused(xp, wt, bias, c_prev, state_bf16, h_out, c_out, B, H, W, cin, C, W + 2, rows, false,
               stream);
}

extern "C" int eigen_bisect_i(const void* xh, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, int wp, void* stream) {
  return fused(xh, wt, bias, c_prev, state_bf16, h_out, c_out, B, H, W, cin, C, wp, rows, true,
               stream);
}

extern "C" int eigen_bisect_j(const void* xp, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, int wp, void* stream) {
  return fused(xp, wt, bias, c_prev, state_bf16, h_out, c_out, B, H, W, cin, C, wp, rows, false,
               stream);
}
