// The narrow ConvLSTM layer's persistent body: one narrow layer update (the
// gate convolution of E, R and the upsampled R_above, the bias, the gate
// nonlinearities and the cell update) in bfloat16 compute at C <= 3, the
// pixel layers of the bundled stacks (C 3 under 48 channels, C 1 under 16).
//
// Replaces no TPU kernel of its own: like csrc/convlstm_narrow.cu (the
// mma.sync body, which keeps float32 compute and the wider narrow layers:
// at layer 1 of 1,16,32,64 it measured faster than this design on the H100,
// a block of C 16's 92 KB of weights alone on its SM), it is this card's
// redesign of the port of
// evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py
// ::fused_lstm_gates on the narrow layers, folded into their gate
// convolution.  ops/convlstm_narrow.py::narrow_plan picks the body on the
// host from the layer's channels and compute type alone.
//
// Math: the narrow route's, as the mma.sync body's.  Each source's 3x3 SAME
// conv sums bfloat16 products in float32 and is rounded to bfloat16; E's +
// the bias, + R's, + R_above's, each add rounded; the gate math of
// csrc/lstm_gates.cu in float32; h and c rounded to the state type (ST).  A
// pixel's sums run over its source's K row in one order, k16 step after
// k16 step into one float32 accumulator (one mma.sync each), whatever the
// batch, the tile or the grid.
//
// Bound on the H100: bytes (a call reads E, R, R_above at half resolution
// and c_prev, and writes h and c: 60 bytes a pixel at the colour pixel
// layer, 0.138 ms at the north star against 0.04 ms of products).  What held
// the mma.sync body at 7-9% of it: each block of 128 pixels restaged the
// weights chunk by chunk (23 KB at the pixel layer for every 128 pixels),
// padded the 6- and 3-channel E and R to 16 channels a tap and staged them
// one element at a time, expanded R_above to the fine resolution in shared
// memory (each coarse pixel staged about four times), ran two chunks deep
// with a block barrier a chunk, and left its epilogue exposed.  The design
// answers each:
//   - Persistent blocks with resident weights: the grid is a multiple of
//     the 132 SMs (as many blocks an SM as the shared memory holds); each
//     block stages the layer's whole weight set once (12.3 KB at the pixel
//     layer) and walks tiles t = blockIdx.x, + gridDim.x ... of 128 /
//     tile_w x tile_w pixels of one image: four consumer warps of 32 pixels
//     each, and a producer warp that asks the TMA for each tile.
//   - Packed taps: E and R are staged as their (B, H, W Cs) rows, a TMA box
//     of (tile_h + 2) rows from element (x0 - 1) Cs - lead (the TMA starts
//     a box on a 16-byte boundary: lead = (-Cs) mod 8, the same for every
//     tile; the box's zero fill is the SAME padding), and each thread lays
//     out its pixel's K row, k = tap * Cs + ci, zero-padded to 16 (64 + 32
//     values at C 3, against the mma.sync body's 144 + 144), at
//     compile-time offsets into the halo (a channel pair of E is one 4-byte
//     word; tests/test_torch_narrow_plan.py::packed_taps is the table).
//   - R_above staged once, at half resolution: a tile's coarse halo
//     ((th / 2 + 2) x (tw / 2 + 2) pixels); each ldmatrix lane gives the
//     address of its own pixel's row, so a tap (dy, dx) of fine pixel (y, x)
//     reads coarse pixel ((y + dy - 1) >> 1, (x + dx - 1) >> 1) where it
//     lies: no 2x expansion, and still the 9-tap conv of the upsampled
//     source (the taps that meet one coarse pixel are not pre-summed).
//   - A ring of three tile stages (halos and c_prev's rows), each filled
//     by the TMA on an mbarrier ("full") and handed back by the four
//     consumer warps on another ("empty"), so the next tiles' loads run
//     under this tile's products and epilogue, the producer's address
//     arithmetic is the TMA's, and the consumer warps never wait for each
//     other; the epilogue reads c_prev from the ring and writes h and c
//     through each warp's runs in shared memory as 16-byte stores (NHWC: a
//     tile row's h is one contiguous run).  The tensors' rows must be
//     16-byte multiples for the TMA (W C a multiple of 8):
//     ops/convlstm_narrow.py pads a narrower image with zero columns, which
//     are the SAME padding's own zeros.
//   - The instruction: mma.sync.m16n8k16 with ldmatrix, not wgmma.  At N =
//     16 (12 real gates at C 3) the operand feed, not the tensor cores'
//     rate, is the limit; ldmatrix takes a row address per lane, which is
//     what reads R_above at the coarse pixel, and each warp owns its 32
//     pixels from K row to epilogue, so a tile needs no warpgroup fences
//     and no block barrier.
//   - The epilogue: the gates (bfloat16 already) go through a row a pixel
//     in the warp's K rows, and each lane takes (pixel, channel) pairs of
//     the warp's 32 C, so no lane idles on the padding columns (4C = 12 of
//     16).
// The K rows are an odd number of 16-byte chunks apart (208 bytes at C 3),
// so an ldmatrix's eight rows fall in distinct banks; R_above's coarse
// pixels lie 96 bytes apart at 48 channels, so the four or five an
// ldmatrix reads do too.  A deadlocked ring traps (mbar_wait_or_trap).

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TM = 128;        // pixels a tile
constexpr int CONSUMERS = 4;   // warps of 32 pixels
constexpr int NT = 32 * (CONSUMERS + 1);  // and the producer warp
constexpr int MT = 2;          // m16 tiles a warp
constexpr int NOUT = 16;       // gate outputs a block (4C <= 12, n8 tiles of 8)
constexpr int NTW = NOUT / 8;
constexpr int STAGES = 3;      // tile stages in flight
constexpr int MAX_C = 3;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

// The layout of a launch, made on the host (make_geometry) and mirrored by
// ops/convlstm_narrow.py::persistent_smem.  Shared memory: the weights,
// STAGES tile stages, the packed sources' K rows (the epilogue's gates
// after them), the warps' output runs, the ring's mbarriers and one zero
// chunk; every part 128-byte aligned.
struct Geometry {
  int B, H, W, C, cu;  // cu: R_above's channels, 0 without it
  int tw, th, tw_shift, tiles_x, tiles_y, tiles;
  int steps[3], wplane[3];  // E, R, R_above: k16 steps and first weight plane
  int off[3], off_c, stage_bytes, stage_tx;  // a stage: three halos, c_prev's rows
  int row[2];   // E, R: a halo row in elements (the TMA box's width)
  int lead[2];  // E, R: elements before pixel x0 - 1 in a halo row
  int ps;       // R_above: a coarse halo pixel's bytes (2 cu)
  int stage0, krow_off, krow, out_off, seg_cap, bar_off, zero_off, smem;
};

struct Params {
  const __nv_bfloat16* w[3];  // (9, C, 4, cs): E, R, R_above
  const void* bias;           // (4C,) gate-major
  int bias_bf16;
  void* h_out;
  void* c_out;
  Geometry g;
};

// the tensor maps of a launch: E, R, R_above, c_prev
struct Maps {
  CUtensorMap e, r, u, c;
};

struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_of(const Geometry& g, int t) {
  const int tx = t % g.tiles_x, r = t / g.tiles_x;
  return TileAt{r / g.tiles_y, r % g.tiles_y * g.th, tx * g.tw};
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc += the k16 step's products: A fragments a (the warp's MT m16 tiles),
// B the weight plane at b_addr (the lane's ldmatrix row of it), NTW n8 tiles
__device__ __forceinline__ void mma_step(float (&acc)[MT][NTW][4], const unsigned (&a)[MT][4],
                                         unsigned b_addr) {
#pragma unroll
  for (int j = 0; j < NTW / 2; ++j) {
    unsigned b[4];
    eigen::ldmatrix_x4(b, b_addr + (unsigned)(j * 16 * 32));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      eigen::mma16816(acc[mt][2 * j], a[mt], b);
      eigen::mma16816(acc[mt][2 * j + 1], a[mt], b + 2);
    }
  }
}

// A packed source's part of its pixel's K row (CS channels, K16 values:
// k = (3 dy + dx) CS + ci, zeros past 9 CS), from the halo rows pr .. pr + 2
// (hrow[dy]: the pixel's left neighbour in row dy; the TMA's zero fill is
// the image's edge), into 16-byte stores at `krow`
template <int CS, int K16>
__device__ __forceinline__ void build_k_row(unsigned char* krow,
                                            const unsigned short* const (&hrow)[3]) {
  unsigned v[K16 / 2];
#pragma unroll
  for (int i = 0; i < K16 / 2; ++i) v[i] = 0u;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      if constexpr (CS % 2 == 0) {
        // an even CS: each channel pair is one aligned 4-byte word (a row
        // starts on an even element, lead and CS are even), and one word
        // of the K row
#pragma unroll
        for (int ci = 0; ci < CS; ci += 2)
          v[((3 * dy + dx) * CS + ci) >> 1] =
              *reinterpret_cast<const unsigned*>(hrow[dy] + dx * CS + ci);
      } else {
#pragma unroll
        for (int ci = 0; ci < CS; ++ci) {
          const int k = (3 * dy + dx) * CS + ci;
          v[k >> 1] |= (unsigned)hrow[dy][dx * CS + ci] << (16 * (k & 1));
        }
      }
    }
#pragma unroll
  for (int q = 0; q < K16 / 8; ++q)
    *reinterpret_cast<uint4*>(krow + 16 * q) = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                          v[4 * q + 3]);
}

// C: the layer's channels (1 .. 3); KU: R_above's 16-channel steps a tap
// where they are known (its channels 16 or 48 under C 1 or 3), else 0
// (counted at run time, or no R_above)
template <int C, int KU, typename ST>
__global__ void __launch_bounds__(NT) convlstm_narrow_persistent_kernel(
    const __grid_constant__ Maps maps, const Params p) {
  constexpr int EPC = 16 / (int)sizeof(ST);       // state elements a 16-byte chunk
  constexpr int KE16 = 16 * cdiv(18 * C, 16);     // the K of E (2C channels), of R
  constexpr int KR16 = 16 * cdiv(9 * C, 16);
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry& g = p.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if ((int)blockIdx.x >= g.tiles) return;
  const int n_my = (g.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nsrc = g.cu ? 3 : 2;
  const int cs[3] = {2 * C, C, g.cu};
  const unsigned s_base = eigen::smem_addr(smem);
  const unsigned full = s_base + (unsigned)g.bar_off, empty = full + 8 * STAGES;

  // ---- the weights, once.  The sources' (9, C, 4, cs) weights are copied
  // whole into the ring's space (before its first tile; make_geometry
  // checks that they fit), then laid out from there as B planes: plane
  // wplane[s] + step holds the step's 16 k values of rows n = 4 c + gate,
  // two 16-byte halves swapped where (n >> 2) & 1 (common.cuh's B layout).
  // Then the zero chunk and the ring's mbarriers.
  int at[3];
  for (int s = 0, used = 0; s < nsrc; ++s) {
    const int bytes = 72 * C * cs[s];
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p.w[s]);
    at[s] = used;
    for (int o = 16 * tid; o < bytes; o += 16 * NT)
      eigen::cp_async16_partial(smem + g.stage0 + used + o, src + o, min(16, bytes - o));
    used += round_up(bytes, 16);
  }
  eigen::cp_async_commit();
  eigen::cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < nsrc; ++s) {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(smem + g.stage0 + at[s]);
    const int cpt = s < 2 ? cs[s] : 16 * cdiv(cs[s], 16);  // K values a tap
    for (int row = tid; row < g.steps[s] * NOUT; row += NT) {
      const int st = row / NOUT, n = row % NOUT, c = n >> 2;
      int tap = 16 * st / cpt, ci = 16 * st - tap * cpt;
      unsigned v[8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned e =
            tap < 9 && ci < cs[s] && c < C ? w[((tap * C + c) * 4 + (n & 3)) * cs[s] + ci] : 0u;
        v[j >> 1] = (j & 1) ? v[j >> 1] | e << 16 : e;
        if (++ci == cpt) ci = 0, ++tap;
      }
      unsigned char* dst = smem + ((g.wplane[s] + st) * NOUT + n) * 32;
      const int swap = (n >> 2) & 1;
      *reinterpret_cast<uint4*>(dst + 16 * swap) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(dst + 16 * (swap ^ 1)) = make_uint4(v[4], v[5], v[6], v[7]);
    }
  }
  if (tid < 4) reinterpret_cast<unsigned*>(smem + g.zero_off)[tid] = 0u;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      eigen::mbar_init(full + 8 * s, 1);
      eigen::mbar_init(empty + 8 * s, CONSUMERS);
    }
    eigen::fence_mbarrier_init();
  }
  eigen::fence_proxy_async();  // the ring's space, written here, is the TMA's next
  __syncthreads();  // the weights are laid out, the raw copies read

  // ---- the producer warp: each tile's stage, STAGES ahead, once its slot
  // is handed back
  if (warp == CONSUMERS) {
    if (lane == 0) {
      for (int i = 0; i < n_my; ++i) {
        const int slot = i % STAGES;
        if (i >= STAGES) eigen::mbar_wait_or_trap(empty + 8 * slot, (i / STAGES - 1) & 1);
        const TileAt at = tile_of(g, (int)blockIdx.x + i * (int)gridDim.x);
        const unsigned st = s_base + (unsigned)(g.stage0 + slot * g.stage_bytes);
        const unsigned bar = full + 8 * slot;
        eigen::mbar_arrive_expect_tx(bar, (unsigned)g.stage_tx);
        // E's and R's rows of (W Cs): the box from element (x0 - 1) Cs - lead
        eigen::tma_load_4d(st + g.off[0], &maps.e, bar, (at.x0 - 1) * 2 * C - g.lead[0],
                           at.y0 - 1, at.b, 0);
        eigen::tma_load_4d(st + g.off[1], &maps.r, bar, (at.x0 - 1) * C - g.lead[1], at.y0 - 1,
                           at.b, 0);
        if (g.cu)  // coarse pixels from (y0 / 2 - 1, x0 / 2 - 1)
          eigen::tma_load_4d(st + g.off[2], &maps.u, bar, 0, at.x0 / 2 - 1, at.y0 / 2 - 1, at.b);
        // c_prev's rows of (W C) state elements, as bfloat16 pairs where
        // the state is float32
        eigen::tma_load_4d(st + g.off_c, &maps.c, bar, at.x0 * C * (int)sizeof(ST) / 2, at.y0,
                           at.b, 0);
      }
    }
    return;
  }

  // the bias of the thread's D fragment columns n = nt * 8 + 2 tig + j,
  // cast to bfloat16 (0 past 4C)
  float bias_reg[NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = nt * 8 + 2 * tig + j, c = n >> 2;
      const int k = (n & 3) * C + c;
      bias_reg[nt][j] = c < C ? round_bf16(p.bias_bf16
                                               ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[k])
                                               : static_cast<const float*>(p.bias)[k])
                              : 0.0f;
    }

  // ---- the lane's operand rows: ldmatrix lane l reads row (l & 7) + 8
  // ((l >> 3) & 1) of an m16 tile at k half l >> 4 (A), and row 8 (l >> 4)
  // + (l & 7) of two n8 tiles at the swizzled k half (B)
  const int akh = lane >> 4;
  int am[MT];
  // the lane's A rows in R_above's coarse halo, the same for every tile:
  // their coarse row and column parts
  unsigned crow[MT][3], ccol[MT][3];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    am[mt] = warp * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int apr = am[mt] >> g.tw_shift, apc = am[mt] & (g.tw - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      crow[mt][d] = (unsigned)((((apr + d - 1) >> 1) + 1) * (g.tw / 2 + 2) * g.ps);
      ccol[mt][d] = (unsigned)((((apc + d - 1) >> 1) + 1) * g.ps);
    }
  }
  const unsigned b_lane = s_base + (unsigned)((8 * (lane >> 4) + (lane & 7)) * 32 +
                                              16 * (((lane >> 3) ^ (lane >> 2)) & 1));
  const unsigned zero_addr = s_base + (unsigned)g.zero_off;

  // the gates of a tile: each source's products into acc, rounded, added
  float acc[MT][NTW][4];
  auto clear = [&] {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  };
  auto add_source = [&](float (&gates)[MT][NTW][4], bool first) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gates[mt][nt][i] =
              round_bf16((first ? bias_reg[nt][i & 1] : gates[mt][nt][i]) + round_bf16(acc[mt][nt][i]));
  };
  // R_above from its coarse halo: tap by tap, 16 channels a step
  auto coarse = [&](unsigned halo) {
    const int cpt16 = KU ? KU : cdiv(g.cu, 16);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned pix[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pix[mt] = halo + crow[mt][dy] + ccol[mt][dx];
#pragma unroll
      for (int cc = 0; cc < cpt16; ++cc) {
        const int ci = 16 * cc + 8 * akh;
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          eigen::ldmatrix_x4(a[mt], ci < g.cu ? pix[mt] + (unsigned)(2 * ci) : zero_addr);
        mma_step(acc, a, b_lane + (unsigned)((g.wplane[2] + tap * cpt16 + cc) * NOUT * 32));
      }
    }
  };
  // E or R from the K rows: `steps` k16 steps from value k0
  auto from_k_rows = [&](int s, int k0, auto steps) {
#pragma unroll
    for (int st = 0; st < decltype(steps)::value; ++st) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        eigen::ldmatrix_x4(a[mt], s_base + (unsigned)(g.krow_off + am[mt] * g.krow +
                                                      2 * (k0 + 16 * st + 8 * akh)));
      mma_step(acc, a, b_lane + (unsigned)((g.wplane[s] + st) * NOUT * 32));
    }
  };

  auto tile_gates = [&](int slot, float (&gates)[MT][NTW][4]) {
    const unsigned char* base = smem + g.stage0 + slot * g.stage_bytes;
    // this thread's pixel m = tid (its warp's own rows): its K row from the
    // halo rows pr .. pr + 2, its left neighbour at column pc
    const int pr = tid >> g.tw_shift, pc = tid & (g.tw - 1);
    const unsigned short* hrow_e[3];
    const unsigned short* hrow_r[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      hrow_e[dy] = reinterpret_cast<const unsigned short*>(base + g.off[0]) +
                   (pr + dy) * g.row[0] + g.lead[0] + pc * 2 * C;
      hrow_r[dy] = reinterpret_cast<const unsigned short*>(base + g.off[1]) +
                   (pr + dy) * g.row[1] + g.lead[1] + pc * C;
    }
    unsigned char* krow = smem + g.krow_off + tid * g.krow;
    __syncwarp();  // the warp's last gates (in its K rows) are read
    build_k_row<2 * C, KE16>(krow, hrow_e);
    build_k_row<C, KR16>(krow + 2 * KE16, hrow_r);
    __syncwarp();
    clear();
    from_k_rows(0, 0, std::integral_constant<int, KE16 / 16>{});
    add_source(gates, true);
    clear();
    from_k_rows(1, KE16, std::integral_constant<int, KR16 / 16>{});
    add_source(gates, false);
    if (g.cu) {
      clear();
      coarse(s_base + (unsigned)(base - smem + g.off[2]));
      add_source(gates, false);
    }
  };

  // ---- the epilogue: the gates into the warp's K rows (bfloat16: they are
  // rounded to it; E's and R's products are done with them), then the
  // gate math on the warp's 32 C (pixel, channel) pairs, lane by lane, h
  // and c into the warp's runs in shared memory, then out as 16-byte stores
  const int seglen = min(g.tw, 32), nseg = 32 / seglen;
  ST* outw = reinterpret_cast<ST*>(smem + g.out_off) + warp * 2 * nseg * g.seg_cap;
  ST* h_out = static_cast<ST*>(p.h_out);
  ST* c_out = static_cast<ST*>(p.c_out);
  unsigned char* gbuf = smem + g.krow_off + warp * 32 * g.krow;
  auto epilogue = [&](int slot, const TileAt at, float (&gates)[MT][NTW][4]) {
    const ST* cst = reinterpret_cast<const ST*>(smem + g.stage0 + slot * g.stage_bytes + g.off_c);
    __syncwarp();  // the warp's K rows and last runs are read
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        // D fragment: rows gid, gid + 8 of the m16 tile, columns n = nt * 8
        // + 2 tig (+1), n = 4 c + gate
        const int r = mt * 16 + gid, n = nt * 8 + 2 * tig;
        const float* d = gates[mt][nt];
        *reinterpret_cast<__nv_bfloat162*>(gbuf + r * g.krow + 2 * n) =
            __floats2bfloat162_rn(d[0], d[1]);
        *reinterpret_cast<__nv_bfloat162*>(gbuf + (r + 8) * g.krow + 2 * n) =
            __floats2bfloat162_rn(d[2], d[3]);
      }
    __syncwarp();
    for (int q = lane; q < 32 * C; q += 32) {
      const int px = q / C, c = q - px * C;
      const int m = warp * 32 + px;
      const int pr = m >> g.tw_shift, pc = m & (g.tw - 1);
      const int y = at.y0 + pr, x = at.x0 + pc;
      if (y >= g.H || x >= g.W) continue;
      const uint2 gv = *reinterpret_cast<const uint2*>(gbuf + px * g.krow + 8 * c);
      const float ig = eigen::sigmoid(__uint_as_float(gv.x << 16));
      const float fg = eigen::sigmoid(__uint_as_float(gv.x & 0xffff0000u));
      const float og = eigen::sigmoid(__uint_as_float(gv.y << 16));
      const float gg = tanhf(__uint_as_float(gv.y & 0xffff0000u));
      const float cv = fg * eigen::to_float(cst[(pr * g.tw + pc) * C + c]) + ig * gg;
      const int seg = px / seglen, pc0 = (warp * 32 + seg * seglen) & (g.tw - 1);
      const int o = seg * g.seg_cap + (pc - pc0) * C + c;
      outw[o] = eigen::from_float<ST>(og * tanhf(cv));
      outw[nseg * g.seg_cap + o] = eigen::from_float<ST>(cv);
    }
    __syncwarp();
    // a segment's run starts on a 16-byte boundary: W C is a multiple of 8
    // and x0 + pc0 of 16
    for (int seg = 0; seg < nseg; ++seg) {
      const int m0 = warp * 32 + seg * seglen;
      const int pr = m0 >> g.tw_shift, pc0 = m0 & (g.tw - 1);
      const int y = at.y0 + pr, cnt = min(seglen, g.W - at.x0 - pc0);
      if (y >= g.H || cnt <= 0) continue;
      const int n = cnt * C, nch = cdiv(n, EPC);
      const long long e0 = ((long long)(at.b * g.H + y) * g.W + at.x0 + pc0) * C;
      for (int q = lane; q < 2 * nch; q += 32) {
        const int which = q >= nch, lo = (q - which * nch) * EPC;
        const ST* src = outw + (which * nseg + seg) * g.seg_cap + lo;
        ST* dst = (which ? c_out : h_out) + e0 + lo;
        if (lo + EPC <= n) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            if (lo + e < n) dst[e] = src[e];
        }
      }
    }
  };

  // ---- the consumers: tiles blockIdx.x + i gridDim.x as they land; each
  // warp hands its slot back when its epilogue has read c_prev from it
  for (int i = 0; i < n_my; ++i) {
    const int slot = i % STAGES;
    eigen::mbar_wait_or_trap(full + 8 * slot, (i / STAGES) & 1);
    const TileAt tile = tile_of(g, (int)blockIdx.x + i * (int)gridDim.x);
    float gates[MT][NTW][4];
    tile_gates(slot, gates);
    epilogue(slot, tile, gates);
    __syncwarp();
    if (lane == 0) eigen::mbar_arrive_expect_tx(empty + 8 * slot, 0);
  }
}

bool make_geometry(Geometry& g, int B, int H, int W, int C, int cu, int tw, int state_bytes) {
  if (!(tw == 16 || tw == 32) || C < 1 || C > MAX_C) return false;
  const int epc = 16 / state_bytes;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.cu = cu;
  g.tw = tw;
  g.th = TM / tw;
  g.tw_shift = tw == 16 ? 4 : 5;
  g.tiles_x = cdiv(W, tw);
  g.tiles_y = cdiv(H, g.th);
  const long long tiles = (long long)B * g.tiles_x * g.tiles_y;
  if (tiles > 0x7fffffff) return false;
  g.tiles = (int)tiles;
  const int cs[3] = {2 * C, C, cu};
  int plane = 0;
  for (int s = 0; s < 3; ++s) {  // k16 steps: E, R packed; R_above 16 channels a tap
    g.steps[s] = s < 2 ? cdiv(9 * cs[s], 16) : 9 * cdiv(cu, 16);
    g.wplane[s] = plane;
    plane += g.steps[s];
  }
  // a stage: each part the bytes of its TMA box, 128-byte aligned
  int off = 0, tx = 0;
  for (int s = 0; s < 2; ++s) {
    g.off[s] = off;
    g.lead[s] = (8 - cs[s] % 8) % 8;
    g.row[s] = round_up(g.lead[s] + (tw + 2) * cs[s], 8);
    const int bytes = (g.th + 2) * g.row[s] * 2;
    tx += bytes;
    off += round_up(bytes, 128);
  }
  g.off[2] = off;
  g.ps = 2 * cu;
  const int u_bytes = (g.th / 2 + 2) * (tw / 2 + 2) * g.ps;
  tx += u_bytes;
  off += round_up(u_bytes, 128);
  g.off_c = off;
  const int c_bytes = g.th * tw * C * state_bytes;
  tx += c_bytes;
  off += round_up(c_bytes, 128);
  g.stage_bytes = off;
  g.stage_tx = tx;
  // the whole
  g.stage0 = plane * NOUT * 32;
  g.krow_off = g.stage0 + STAGES * g.stage_bytes;
  g.krow = (16 * cdiv(18 * C, 16) + 16 * cdiv(9 * C, 16)) * 2 + 16;
  g.out_off = g.krow_off + round_up(TM * g.krow, 128);
  const int seglen = tw < 32 ? tw : 32;
  g.seg_cap = round_up(seglen * C, epc);
  g.bar_off = g.out_off + round_up(4 * 2 * (32 / seglen) * g.seg_cap * state_bytes, 128);
  g.zero_off = g.bar_off + 16 * STAGES;
  g.smem = g.bar_off + 128;
  // the raw weights pass through the ring's space
  int raw = 0;
  for (int s = 0; s < 3; ++s) raw += round_up(72 * C * cs[s], 16);
  return raw <= STAGES * g.stage_bytes;
}

// the four tensor maps: E and R as rows of (W Cs) elements, R_above's
// coarse pixels, c_prev as rows of W C state elements (as bfloat16 pairs
// where the state is float32)
bool make_maps(Maps& m, const Geometry& g, const void* x0, const void* x1, const void* x2,
               const void* c_prev, int state_bytes) {
  const cuuint64_t B = g.B, H = g.H, W = g.W;
  const void* xs[2] = {x0, x1};
  CUtensorMap* ms[2] = {&m.e, &m.r};
  for (int s = 0; s < 2; ++s) {
    const cuuint64_t n = W * (s == 0 ? 2 * g.C : g.C);  // a row's elements
    const cuuint64_t dims[4] = {n, H, B, 1}, strides[3] = {n * 2, n * 2 * H, n * 2 * H * B};
    const cuuint32_t box[4] = {(cuuint32_t)g.row[s], (cuuint32_t)g.th + 2, 1, 1};
    if (n * 2 % 16 ||
        !eigen::tensor_map(ms[s], xs[s], 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  }
  if (g.cu) {
    const cuuint64_t cu = g.cu, dims[4] = {cu, W / 2, H / 2, B},
                     strides[3] = {cu * 2, cu * 2 * (W / 2), cu * 2 * (W / 2) * (H / 2)};
    const cuuint32_t box[4] = {(cuuint32_t)g.cu, (cuuint32_t)g.tw / 2 + 2,
                               (cuuint32_t)g.th / 2 + 2, 1};
    if (!eigen::tensor_map(&m.u, x2, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  } else {
    m.u = m.e;  // not read
  }
  const cuuint64_t n = W * g.C * (state_bytes / 2);  // a row's bfloat16 elements
  const cuuint64_t dims[4] = {n, H, B, 1}, strides[3] = {n * 2, n * 2 * H, n * 2 * H * B};
  const cuuint32_t box[4] = {(cuuint32_t)(g.tw * g.C * state_bytes / 2), (cuuint32_t)g.th, 1, 1};
  return n * 2 % 16 == 0 &&
         eigen::tensor_map(&m.c, c_prev, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int C, int KU, typename ST>
int launch(const Maps& m, const Params& p, int blocks, cudaStream_t st) {
  const auto kernel = convlstm_narrow_persistent_kernel<C, KU, ST>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.g.smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<blocks, NT, p.g.smem, st>>>(m, p);
  return (int)cudaGetLastError();
}

// R_above's steps a tap known at compile time at the bundled stacks' pixel
// layers (C 1 under 16 channels, C 3 under 48), else at run time
template <int C, int KU>
int launch_up(const Maps& m, const Params& p, int state_bf16, int blocks, cudaStream_t st) {
  if (KU && p.g.cu == 16 * KU)
    return state_bf16 ? launch<C, KU, __nv_bfloat16>(m, p, blocks, st)
                      : launch<C, KU, float>(m, p, blocks, st);
  return state_bf16 ? launch<C, 0, __nv_bfloat16>(m, p, blocks, st)
                    : launch<C, 0, float>(m, p, blocks, st);
}

inline bool aligned(const void* ptr) { return eigen::igemm::aligned16(ptr); }

}  // namespace

// The persistent body, bfloat16 compute (compute_bf16 must be 1).  x0 (E):
// (B, H, W, 2C); x1 (R): (B, H, W, C); x2 (R_above, n_src = 3 only): (B, H/2,
// W/2, cin2), cin2 a multiple of 8, H and W even; all bfloat16, 16-byte
// aligned, with weights w_s (9, C, 4, cin_s) bfloat16, 16-byte aligned.
// bias: (4C,) gate-major, float32 or bfloat16 (bias_bf16 != 0).  c_prev,
// h_out, c_out: (B, H, W, C) in the state type (bfloat16 when state_bf16 !=
// 0, else float32), 16-byte aligned.  C 1 .. 3, W C a multiple of 8.
// tile_w: 16 or 32; blocks: the grid.  All contiguous.  Launches on
// `stream` and returns the CUDA error of the launch (cudaErrorInvalidValue
// for what it does not take).
extern "C" int eigen_convlstm_narrow_persistent(
    const void* x0, const void* w0, int cin0, const void* x1, const void* w1, int cin1,
    const void* x2, const void* w2, int cin2, int n_src, const void* bias, int bias_bf16,
    int compute_bf16, const void* c_prev, int state_bf16, void* h_out, void* c_out, int B, int H,
    int W, int C, int tile_w, int blocks, void* stream) {
  if (compute_bf16 != 1 || C < 1 || C > MAX_C || B < 0 || H < 0 || W < 0 || blocks < 1 ||
      cin0 != 2 * C || cin1 != C || n_src < 2 || n_src > 3)
    return (int)cudaErrorInvalidValue;
  if (n_src == 3 && (cin2 < 8 || cin2 % 8 || H % 2 || W % 2 || !aligned(x2) || !aligned(w2)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x0) || !aligned(x1) || !aligned(c_prev) || !aligned(h_out) || !aligned(c_out) ||
      !aligned(w0) || !aligned(w1) || W * C % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  Params p{};
  Maps m;
  const int sb = state_bf16 ? 2 : 4;
  if (!make_geometry(p.g, B, H, W, C, n_src == 3 ? cin2 : 0, tile_w, sb) || p.g.smem > 232448 ||
      !make_maps(m, p.g, x0, x1, x2, c_prev, sb))
    return (int)cudaErrorInvalidValue;
  p.w[0] = (const __nv_bfloat16*)w0;
  p.w[1] = (const __nv_bfloat16*)w1;
  p.w[2] = (const __nv_bfloat16*)w2;
  p.bias = bias;
  p.bias_bf16 = bias_bf16;
  p.h_out = h_out;
  p.c_out = c_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_up<1, 1>(m, p, state_bf16, blocks, st);
    case 2: return launch_up<2, 0>(m, p, state_bf16, blocks, st);
    default: return launch_up<3, 3>(m, p, state_bf16, blocks, st);
  }
}
