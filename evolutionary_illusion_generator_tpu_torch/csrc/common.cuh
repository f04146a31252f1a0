// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace eigen {

// The gate nonlinearities in float32 with the accurate libm functions, as
// the plain PyTorch versions compute them (torch.sigmoid / torch.tanh).
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The recurrent state is float32 or bfloat16; these load / store it as float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

// ---- the tensor-core building blocks of the conv kernels (sm_80 and up)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// 16 bytes global -> shared of which the first `bytes` (0 .. 16) are read
// and the rest written as zeros; `src` 16-byte aligned and readable for
// `bytes` bytes.
__device__ __forceinline__ void cp_async16_partial(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// d += a * b for one 16 x 8 tile: a is 16 x 16 (row major), b 16 x 8 (column
// major), bfloat16 pairs packed in 32-bit registers, d float32.
__device__ __forceinline__ void mma16816(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bfloat16 matrices from shared memory: lane 8 j + i gives the
// 16-byte row i of matrix j; r[j] gets the lane's pair (row lane / 4,
// columns 2 (lane % 4) and + 1) of matrix j — the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---- the implicit-GEMM 3x3 SAME conv of csrc/convlstm_fused.cu and
// csrc/convlstm_narrow.cu (sm_80 and up; the design is set out in
// convlstm_fused.cu).  M = output pixels, N = gate outputs, K = 9 taps x the
// sources' channels.  A block owns TM pixels of the tile mapping and NOUT
// outputs (n = 4 (c - c0) + gate), and walks K chunk by chunk, 16 input
// channels of one source at a time, the sources one after another.

namespace igemm {

constexpr int TM = 128;               // output pixels per block
constexpr int KC = 16;                // input channels per chunk: one k16 step per tap
constexpr int KP = KC + 8;            // slab pixel row, padded to 48 bytes (bank spread)
constexpr int KW = KC;                // weight rows: 32 bytes, 16-byte halves swizzled
constexpr int WARPS_M = 4;            // warps across the pixels; the rest across N
constexpr int MT = TM / 16 / WARPS_M; // m16 tiles per warp
constexpr int STAGES = 2;             // chunks in flight
constexpr int MAX_SOURCES = 3;

struct Source {
  const __nv_bfloat16* x;  // (B, H, W, cin); coarse: (B, H/2, W/2, cin)
  const __nv_bfloat16* w;  // (9, C, 4, cin): [tap][channel][gate][input channel]
  int cin;
  int chunks;  // ceil(cin / KC)
  int vec;     // cin % 8 == 0 and x, w 16-byte aligned: stage with cp.async
  int coarse;  // read at (row / 2, column / 2): H and W even
};

// The tile mapping: the image columns cut into strips tw wide, each strip's
// pixels taken in (image, row, column) order over the batch, TM at a time.
struct Tiling {
  int H, W, C;
  int rows;             // B * H: the batch's rows, image after image
  int tw;               // strip width
  int tiles_per_strip;  // ceil(rows * tw / TM)
  int slab_h, slab_w;   // halo slab: tile rows + 2, tw + 2
};

inline Tiling make_tiling(int B, int H, int W, int C, int tw) {
  Tiling t;
  t.H = H;
  t.W = W;
  t.C = C;
  t.rows = B * H;
  t.tw = tw;
  t.tiles_per_strip = (int)(((long long)t.rows * tw + TM - 1) / TM);
  // rows a tile spans: TM / tw when tiles start on a row, else up to one more
  const int tile_rows = TM % tw == 0 ? TM / tw : (TM + tw - 2) / tw + 1;
  t.slab_h = tile_rows + 2;
  t.slab_w = tw + 2;
  return t;
}

// blocks along the pixels: strips x tiles per strip
inline int pixel_blocks(const Tiling& t) { return ((t.W + t.tw - 1) / t.tw) * t.tiles_per_strip; }

// dynamic shared memory: the stages of NOUT outputs, or the epilogue's TM
// rows of ep floats, whichever is larger (the epilogue reuses the stages)
inline int smem_bytes(const Tiling& t, int nout, int ep) {
  const int stages = 2 * (STAGES * (9 * nout * KW + t.slab_h * t.slab_w * KP) + KP);
  return stages > TM * ep * 4 ? stages : TM * ep * 4;
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

// src[s] for s < n_src from the entry's arguments, source `coarse_src` read
// at half resolution; adds their chunks to n_chunks.  False if a cin < 1.
inline bool make_sources(Source (&src)[MAX_SOURCES], int& n_chunks, const void* const* xs,
                         const void* const* ws, const int* cins, int n_src, int coarse_src) {
  for (int s = 0; s < n_src; ++s) {
    if (cins[s] < 1) return false;
    const int chunks = (cins[s] + KC - 1) / KC;
    src[s] = Source{(const __nv_bfloat16*)xs[s], (const __nv_bfloat16*)ws[s], cins[s], chunks,
                    cins[s] % 8 == 0 && aligned16(xs[s]) && aligned16(ws[s]), s == coarse_src};
    n_chunks += chunks;
  }
  return true;
}

// The block's tile: its first pixel in its strip, the strip's first
// column, and the tile's first row (the slab starts one above).
struct Block {
  int q0, x0, r0;
};
__device__ __forceinline__ Block block_tile(const Tiling& t) {
  const int strip = blockIdx.x / t.tiles_per_strip;
  const int q0 = (blockIdx.x % t.tiles_per_strip) * TM;
  return Block{q0, strip * t.tw, q0 / t.tw};
}

// acc (the warp's MT x NTW mma tiles; NT threads, warps WARPS_M across the
// pixels) += the block's conv over chunks 0 .. n_chunks of the sources, for
// the NOUT outputs of channels c0 .. c0 + NOUT / 4.  Per chunk, staged with
// cp.async two chunks deep and one barrier a chunk:
//   - the 9 x NOUT x 16 weight slice (a chunk of input channels of one
//     output is 32 contiguous bytes), its two 16-byte halves swapped on
//     every other group of four rows so that the 8 rows of an ldmatrix fall
//     in distinct banks;
//   - the halo slab of the block's pixels, read in place from the unpadded
//     source (at (row / 2, column / 2) of a coarse one when kCoarse): the
//     SAME padding and the ragged channel edge are the zero-filling form of
//     cp.async, or element by element where a source is not `vec`.  Its
//     rows are padded from 16 to 24 values (48 bytes): a tap's 8 pixels are
//     neighbours in the slab.
// A tap whose row lies outside the pixel's own image reads a zero row.
// after_tap() runs after each tap's products, after_chunk(kc) after chunk
// kc's.  The caller syncs before it reuses the shared memory.
template <int NOUT, int NT, int NTW, bool kCoarse, typename AfterTap, typename AfterChunk>
__device__ __forceinline__ void conv3x3(unsigned char* smem, const Source (&src)[MAX_SOURCES],
                                        int n_chunks, const Tiling& t, const Block& blk, int c0,
                                        float (&acc)[MT][NTW][4], AfterTap after_tap,
                                        AfterChunk after_chunk) {
  static_assert(NTW % 2 == 0, "B fragments load two n8 tiles at a time");
  constexpr int WS_ELEMS = 9 * NOUT * KW;  // bfloat16 per weight stage
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][9][NOUT][KW]
  __nv_bfloat16* xs = ws + STAGES * WS_ELEMS;                    // [STAGES][slab_h][slab_w][KP]
  const int slab_px = t.slab_h * t.slab_w;
  __nv_bfloat16* zero_px = xs + STAGES * slab_px * KP;           // one pixel of zeros

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  if (tid < KP) zero_px[tid] = zero;

  auto stage = [&](int s, int kc) {
    // chunk kc -> (source, chunk of that source); selects, not an indexed
    // read of the parameter struct
    int si = 0;
    if (kc >= src[0].chunks) kc -= src[0].chunks, si = 1;
    if (si == 1 && kc >= src[1].chunks) kc -= src[1].chunks, si = 2;
    const Source sr = si == 0 ? src[0] : (si == 1 ? src[1] : src[2]);
    const int k0 = kc * KC;
    // weights: row n of tap `tap` is w[tap][c0 + n / 4][n % 4][k0 .. k0 + 16),
    // two 16-byte pieces, swapped in rows with n & 4
    for (int i = tid; i < 9 * NOUT * 2; i += NT) {
      const int half = i & 1, row = i >> 1;
      const int n = row % NOUT, tap = row / NOUT;
      const int c = c0 + n / 4, k = k0 + 8 * half;
      __nv_bfloat16* dst = ws + ((s * 9 + tap) * NOUT + n) * KW + 8 * (half ^ ((n >> 2) & 1));
      const __nv_bfloat16* g = sr.w + (((long long)tap * t.C + c) * 4 + n % 4) * sr.cin + k;
      if (sr.vec) {
        const bool valid = c < t.C && k < sr.cin;
        cp_async16(dst, valid ? g : sr.w, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (c < t.C && k + e < sr.cin) ? g[e] : zero;
      }
    }
    // the halo slab: rows r0 - 1 .., columns x0 - 1 .. x0 + tw of the batch
    for (int i = tid; i < slab_px * 2; i += NT) {
      const int half = i & 1, px = i >> 1;
      const int row = blk.r0 - 1 + px / t.slab_w, col = blk.x0 - 1 + px % t.slab_w;
      const int k = k0 + 8 * half;
      const bool inside = row >= 0 && row < t.rows && col >= 0 && col < t.W;
      const long long pix = kCoarse && sr.coarse ? (long long)(row >> 1) * (t.W >> 1) + (col >> 1)
                                                 : (long long)row * t.W + col;
      const __nv_bfloat16* g = sr.x + pix * sr.cin + k;
      __nv_bfloat16* dst = xs + (s * slab_px + px) * KP + 8 * half;
      if (sr.vec) {
        const bool valid = inside && k < sr.cin;
        cp_async16(dst, valid ? g : sr.x, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (inside && k + e < sr.cin) ? g[e] : zero;
      }
    }
    cp_async_commit();
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
    const int q = blk.q0 + m;
    const int row = q / t.tw, xin = q % t.tw;
    a_win[mt] = (row - blk.r0) * t.slab_w + xin;
    const int y = row % t.H;
    a_top[mt] = y == 0;
    a_bot[mt] = y == t.H - 1;
  }
  const unsigned a_khalf = 16u * (lane >> 4);  // bytes
  const unsigned xs_addr = smem_addr(xs), zero_addr = smem_addr(zero_px) + a_khalf;
  // B operand: matrices (n8 tile 2 j', k 0-7), (2 j', k 8-15), (2 j' + 1, k
  // 0-7), (2 j' + 1, k 8-15) for the pair j' of the warp's n8 tiles
  const int b_n = wn * NTW * 8 + 8 * (lane >> 4) + (lane & 7);
  const int b_half = ((lane >> 3) ^ (lane >> 2)) & 1;  // the k half, swapped as staged
  const unsigned b_addr = smem_addr(ws) + (b_n * KW + 8 * b_half) * 2;

  stage(0, 0);  // every source has at least one chunk
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int s = kc & 1;
    cp_async_wait<0>();  // chunk kc has landed ...
    __syncthreads();     // ... for every thread, and chunk kc - 1's slot is free
    if (kc + 1 < n_chunks) stage(s ^ 1, kc + 1);  // lands while chunk kc is computed
    const unsigned xs_s = xs_addr + (unsigned)(s * slab_px * KP * 2) + a_khalf;
    const unsigned ws_s = b_addr + (unsigned)(s * WS_ELEMS * 2);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bool off = (ky == 0 && a_top[mt]) || (ky == 2 && a_bot[mt]);
        const unsigned addr = xs_s + (unsigned)((a_win[mt] + ky * t.slab_w + kx) * KP * 2);
        ldmatrix_x4(a[mt], off ? zero_addr : addr);
      }
#pragma unroll
      for (int j = 0; j < NTW / 2; ++j) {
        unsigned b[4];
        ldmatrix_x4(b, ws_s + (unsigned)((tap * NOUT + 16 * j) * KW * 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * j], a[mt], b);
          mma16816(acc[mt][2 * j + 1], a[mt], b + 2);
        }
      }
      after_tap();
    }
    after_chunk(kc);
  }
}

}  // namespace igemm

// ---- the warpgroup tensor-core building blocks (sm_90a)

// Shared memory written by threads (st.shared or cp.async) is read by wgmma
// through the async proxy: each writing thread runs this after its writes
// have landed and before the barrier that hands them to the warpgroups.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers, TMA and clusters (sm_90)

// mbarrier at shared address `bar`: `count` arrivals complete a phase.
// After init, fence_mbarrier_init and a barrier before any other thread or
// block of the cluster uses it.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival, and `bytes` more for the phase's copies to deliver
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// mbar_wait for the fused kernel's ring: a phase that is still open after
// about 2^32 cycles (two seconds; the copies of a chunk take microseconds)
// traps, which fails the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(unsigned bar, unsigned parity) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// TMA: the box at coordinates (innermost first) of the tensor map `map` (a
// __grid_constant__ kernel parameter) into shared memory at `dst`, complete
// on the mbarrier `bar`; the multicast form writes the same offset in every
// block of `mask` (bit = rank in the cluster) and completes on each one's
// mbarrier at `bar`'s offset.  Elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_3d_multicast(unsigned dst, const void* map, unsigned bar,
                                                      unsigned short mask, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(dst),
      "l"(map), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const void* map, unsigned bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster-wide thread barrier, split: every thread of every block of the
// cluster arrives (release), and a wait (acquire) returns once all have
// arrived since this thread's last wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// An arrival that orders no memory access of this thread before the
// others' wait: where the barrier only says that each thread's reads of a
// ring slot are done (wgmma.wait_group has returned), not that its writes
// are visible.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// wgmma matrix descriptor of a K-major bfloat16 operand.  Start address, lbo
// and sbo in 16-byte units, 14 bits each; base offset 0.  `addr` is a
// shared-memory address.
//   - no swizzle (layout 0): a core matrix is 8 rows x 8 values (16 bytes a
//     row) stored as 128 contiguous bytes; `lbo` is the byte distance between
//     the core matrices of the two 8-value halves of k16, `sbo` that between
//     one group of 8 rows and the next; `addr` 16-byte aligned.
//   - 32-byte swizzle (layout 3): a row is the 32 bytes of k16, 8 rows a
//     256-byte atom, the two 16-byte halves swapped where address bit 7 is
//     set (bit 4 ^= bit 7, as the TMA's CU_TENSOR_MAP_SWIZZLE_32B writes
//     them); `sbo` is the distance between atoms.  The swizzle is taken on
//     the absolute address, so `addr` may start at any row (measured on the
//     H100: the shifted taps of a slab), 16-byte aligned.
constexpr int kNoSwizzle = 0, kSwizzle32 = 3;
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo,
                                               int layout = kNoSwizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)layout << 62;
}
// byte offset `o` (from a 256-byte aligned base) of the 32-byte swizzle
__device__ __forceinline__ unsigned swizzle32(unsigned o) { return o ^ ((o >> 3) & 16u); }

// Before the first wgmma of a group, and after the warpgroup's threads
// touched the accumulator registers.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins each register of `d` in place across the wgmma instructions, which
// write them asynchronously: no read of `d` moves above a wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T for one 64 x N x 16 product of the warpgroup: A (64 x 16) and
// B (N x 16) K-major bfloat16 in shared memory, given by descriptors; d the
// float32 accumulator fragment, N / 2 registers a thread: warp q of the
// warpgroup holds rows 16 q + lane / 4 (d[4 j], d[4 j + 1]) and + 8
// (d[4 j + 2], d[4 j + 3]), columns 8 j + 2 (lane % 4) (+1).  accumulate 0
// ignores d's old values (scale-d false).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- tensor maps (host)

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime: the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bfloat16 tensor map: dims and box innermost first, byte strides of dims
// 1 .. rank - 1; zeros outside (negative coordinates included).
inline bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace eigen
