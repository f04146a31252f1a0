// The rungs of the kernel-bisection ladder: one C entry per Pallas kernel of
// evolutionary_illusion_generator_tpu's scripts/pallas_bisect.py.
//
//   eigen_bisect_a   variant_A   c_prev * 2 as float32 (elementwise)
//   eigen_bisect_e   variant_E   conv + gates + cell update over row blocks
//                                of the padded input xp, staged with cp.async
//   eigen_bisect_j   variant_E2  E with the padded width Wp
//
// Rungs C, D, H and I (eigen_bisect_c, _d, _h, _i: the conv of the padded
// input to float32 gates, the same with the cell update, and the latter over
// the window stack xh at W + 2 and at Wp) run on wgmma in bisect_wgmma.cu.
//
// The wrappers, their plain versions and the host glue (zero padding to xp,
// the weight layout) are in ops/convlstm_bisect.py.
// Math as in the Pallas rungs: bfloat16 input and weights, float32 sums,
// float32 gates; h in the state's type and c in float32.  Gate order
// [i, f, o, g].
//
// Bound on the H100.  A: bytes (2 or 4 read and 4 written per element, no
// arithmetic to speak of; at the ladder's --big shape 553 MB, far past the
// 50 MB L2).  So it streams: 16-byte loads, several in flight a thread,
// 16-byte evict-first stores (__stcs) that a warp writes as 512 neighbouring
// bytes (a bfloat16 vector's two float32 stores go through warp shuffles:
// without them each store instruction wrote half of every 32-byte sector
// and the kernel took 1.5x as long), one tile of contiguous vectors a block;
// a scalar head and tail take a view that starts off a 16-byte boundary
// and a count that is not a multiple of the vector.  The conv rungs:
// operations.  At the ladder's --big shape (Cin 240, 4C 192) a pixel needs
// 9 * 240 * 192 * 2 = 829k operations for about 1 KB moved, far above the
// ~295 operations per byte where the bfloat16 tensor cores stop waiting on
// memory.  So the conv body runs on the tensor cores: the 9 shifted dots of
// the reference are 9 products per chunk of input channels with
// mma.sync.m16n8k16 (bfloat16 in, float32 sums), the warp-level instruction;
// bisect_wgmma.cu has the warpgroup-level form of rungs C, D, H and I.
//
// Design.  A TPU grid step holds a whole (rows+2) x (W+2) x Cin window:
// megabytes of VMEM.  A block here has at most 227 KB of shared memory, so a
// block owns an 8 x 16 output tile of one row block (`rows` is the row-block
// height the grid walks) and a group of 16 channels with all four gates
// (N = 64), and walks the input channels in chunks of 16, one k16 step per
// tap.  Warp w computes tile row w: M = its 16 pixels, all 64 outputs,
// 8 mma tiles of 16 x 8.  Per chunk the 9 x 64 x 16 weight slice goes into
// shared memory with cp.async, two chunks in flight, and so does the
// (10 x 18) x 16-channel halo slab of the input (the Pallas
// make_async_copy; 16-byte pieces where Cin % 8 == 0, zero-filled at the
// edges); the A fragments are read there.
// Shared-memory rows are padded from 16 to 24 values so that the 8 rows a
// fragment load touches fall in distinct banks.  After the last chunk the
// accumulators go through shared memory, so that one thread holds the four
// gates of a (pixel, channel) for the epilogue, the cell update.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TH = 8;    // output tile rows, one warp each
constexpr int TW = 16;   // output tile columns: the M = 16 of a warp's products
constexpr int CG = 16;   // channels per block
constexpr int NOUT = 4 * CG;  // gate outputs per block, n = 4 * (c - c0) + gate
constexpr int NTILES = NOUT / 8;
constexpr int KC = 16;   // input channels per chunk: one k16 step per tap
constexpr int KP = KC + 8;  // padded shared-memory row (bank spread; 48 bytes)
constexpr int NT = 32 * TH;
constexpr int STAGES = 2;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int WS_ELEMS = 9 * NOUT * KP;       // bfloat16 per weight stage
constexpr int XS_ELEMS = HALO_H * HALO_W * KP;  // bfloat16 per input stage
constexpr int EP = NOUT + 4;  // epilogue row of floats

static_assert(TH * TW * EP * 4 <= STAGES * WS_ELEMS * 2, "the epilogue fits in the weight buffers");

constexpr int SMEM_BYTES = 2 * STAGES * (WS_ELEMS + XS_ELEMS);

struct Geometry {
  int B, H, W, cin, C;
  int rows;   // row-block height; H % rows == 0
  int pitch;  // pixels per padded row: W + 2, or Wp for J
  int tiles_x, tiles_y;  // output tiles per row block
};

using eigen::cp_async16;
using eigen::cp_async_commit;
using eigen::cp_async_wait;
using eigen::ld_pair;
using eigen::mma16816;

template <typename ST>
__global__ void __launch_bounds__(NT)
    bisect_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                       const float* __restrict__ bias, const ST* __restrict__ c_prev,
                       ST* __restrict__ h_out, float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][9][NOUT][KP]
  __nv_bfloat16* xs = ws + STAGES * WS_ELEMS;                    // [STAGES][HALO_H][HALO_W][KP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // the warp's tile row
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CG;
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  const int r = t / g.tiles_y;  // row block
  const int yb = r * g.rows;
  const int y0 = yb + ty * TH, x0 = tx * TW;
  const int y_end = yb + g.rows;  // output rows of this row block end here

  // the halo'd input of output row y, tap row ky, is padded row y + ky of
  // the image
  const __nv_bfloat16* img = x + (long long)b * (g.H + 2) * g.pitch * g.cin;
  const bool vec = g.cin % 8 == 0;  // 16-byte pieces of a pixel's channels are aligned and whole
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  auto stage = [&](int s, int k0) {
    // weights: row n of tap `tap` is wt[tap][c][gate][k0 .. k0 + 16), two
    // 16-byte pieces
    for (int i = tid; i < 9 * NOUT * 2; i += NT) {
      const int half = i & 1, row = i >> 1;
      const int n = row % NOUT, tap = row / NOUT;
      const int c = c0 + n / 4, k = k0 + 8 * half;
      __nv_bfloat16* dst = ws + ((s * 9 + tap) * NOUT + n) * KP + 8 * half;
      const __nv_bfloat16* src = wt + (((long long)tap * g.C + c) * 4 + n % 4) * g.cin + k;
      if (vec) {
        const bool valid = c < g.C && k < g.cin;
        cp_async16(dst, valid ? src : wt, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (c < g.C && k + e < g.cin) ? src[e] : zero;
      }
    }
    for (int i = tid; i < HALO_H * HALO_W * 2; i += NT) {
      const int half = i & 1, p = i >> 1;
      const int hy = p / HALO_W, hx = p % HALO_W;
      const int row = y0 + hy, col = x0 + hx, k = k0 + 8 * half;
      const bool valid = row < g.H + 2 && col < g.W + 2;
      const __nv_bfloat16* src = img + ((long long)row * g.pitch + col) * g.cin + k;
      __nv_bfloat16* dst = xs + ((s * HALO_H + hy) * HALO_W + hx) * KP + 8 * half;
      if (vec) {
        cp_async16(dst, valid && k < g.cin ? src : x, valid && k < g.cin);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (valid && k + e < g.cin) ? src[e] : zero;
      }
    }
    cp_async_commit();
  };

  float acc[NTILES][4];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;

  const int nk = (g.cin + KC - 1) / KC;
  stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    const int k0 = kc * KC;
    if (kc + 1 < nk) {
      stage(s ^ 1, k0 + KC);
      cp_async_wait<1>();  // chunk kc has landed, kc + 1 may still fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // A: rows = pixels gid, gid + 8 of the warp's tile row, shifted by the
      // tap; columns = channels 2 tig (+1) and 2 tig + 8 (+1) of the chunk
      const __nv_bfloat16* xr = xs + ((s * HALO_H + warp + ky) * HALO_W + kx) * KP + 2 * tig;
      const unsigned a[4] = {ld_pair(xr + gid * KP), ld_pair(xr + (gid + 8) * KP),
                             ld_pair(xr + gid * KP + 8), ld_pair(xr + (gid + 8) * KP + 8)};
      // B: rows = channels 2 tig (+1) and 2 tig + 8 (+1), column = output
      // 8 nt + gid
      const __nv_bfloat16* wr = ws + ((s * 9 + tap) * NOUT + gid) * KP + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const unsigned bf[2] = {ld_pair(wr + 8 * nt * KP), ld_pair(wr + 8 * nt * KP + 8)};
        mma16816(acc[nt], a, bf);
      }
    }
    __syncthreads();  // stage s is refilled in the next round
  }

  // D fragment: rows = pixels gid, gid + 8; columns = outputs 8 nt + 2 tig (+1)
  float* ep = reinterpret_cast<float*>(smem);  // [TH * TW][EP]; the stages are done
  const int m0 = warp * TW + gid;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    const int n = 8 * nt + 2 * tig;
    ep[m0 * EP + n] = acc[nt][0];
    ep[m0 * EP + n + 1] = acc[nt][1];
    ep[(m0 + 8) * EP + n] = acc[nt][2];
    ep[(m0 + 8) * EP + n + 1] = acc[nt][3];
  }
  __syncthreads();
  for (int i = tid; i < TH * TW * CG; i += NT) {
    const int cl = i % CG, p = i / CG;
    const int y = y0 + p / TW, xx = x0 + p % TW, c = c0 + cl;
    if (y >= y_end || xx >= g.W || c >= g.C) continue;
    const long long pix = ((long long)b * g.H + y) * g.W + xx;
    const float* gv = ep + p * EP + 4 * cl;
    const float gi = gv[0] + bias[c];
    const float gf = gv[1] + bias[g.C + c];
    const float go = gv[2] + bias[2 * g.C + c];
    const float gg = gv[3] + bias[3 * g.C + c];
    const long long o = pix * g.C + c;
    const float cn = eigen::sigmoid(gf) * eigen::to_float(c_prev[o]) + eigen::sigmoid(gi) * tanhf(gg);
    out[o] = cn;
    h_out[o] = eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn));
  }
}

template <typename ST>
int launch_conv(const void* x, const void* wt, const void* bias, const void* c_prev, void* h_out,
                void* out, Geometry g, void* stream) {
  if (g.rows <= 0 || g.H % g.rows != 0 || g.pitch < g.W + 2) return (int)cudaErrorInvalidValue;
  if (g.B == 0 || g.H == 0 || g.W == 0 || g.C == 0) return (int)cudaSuccess;
  g.tiles_x = (g.W + TW - 1) / TW;
  g.tiles_y = (g.rows + TH - 1) / TH;
  const dim3 grid((unsigned)(g.H / g.rows * g.tiles_y * g.tiles_x), (unsigned)((g.C + CG - 1) / CG),
                  (unsigned)g.B);
  // above the 48 KB of static shared memory
  const cudaError_t rc = cudaFuncSetAttribute(
      bisect_conv_kernel<ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  bisect_conv_kernel<ST><<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const float*)bias, (const ST*)c_prev,
      (ST*)h_out, (float*)out, g);
  return (int)cudaGetLastError();
}

int launch_fused(const void* x, const void* wt, const void* bias, const void* c_prev,
                 int state_bf16, void* h_out, void* c_out, Geometry g, void* stream) {
  if (state_bf16)
    return launch_conv<__nv_bfloat16>(x, wt, bias, c_prev, h_out, c_out, g, stream);
  return launch_conv<float>(x, wt, bias, c_prev, h_out, c_out, g, stream);
}

// Rung A, one pass over 16-byte vectors of the input: 8 bfloat16 values
// (two 16-byte float32 stores) or 4 float32 (one).  A block takes a tile of
// kUnroll x kAThreads contiguous vectors (one tile a block: measured 4%
// faster at --big than a grid of the blocks the card holds at once walking
// the tiles, scripts/rung_a_breakdown.py), and each thread issues its
// kUnroll loads before its first store.  Elements [0, head) bring `in` to a
// 16-byte boundary and the last (n - head) % V follow the vectors: both
// scalar, by the first threads of the grid.  The host has checked that
// out + head is 16-byte aligned too.
constexpr int kAThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTile = kAThreads * kUnroll;
constexpr long long kMaxBlocks = 0x7fffffff;  // beyond it the blocks walk the tiles

// The two bfloat16 values of a 32-bit word (the lower address in the low
// half) as float32, exactly.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// The output is never read again here: evict-first stores keep it from
// pushing the input out of L2.
__device__ __forceinline__ void store4(float4* p, float4 v) { __stcs(p, v); }

// A warp's 32 lanes hold 32 neighbouring vectors; `wdst` is the first
// float4 of their output, of which `nout` exist.  bfloat16: lane l's vector
// is the warp's float4s 2l and 2l + 1, so that each store instruction
// writes 512 neighbouring bytes, lane l stores float4 j = l and then
// j = 32 + l, taking its half of the vector of lane j / 2 by shuffles.
__device__ __forceinline__ void store_doubled(float4* wdst, uint4 v, long long nout,
                                              __nv_bfloat16) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = 16 * r + lane / 2;
    const unsigned x = __shfl_sync(0xffffffffu, v.x, s), y = __shfl_sync(0xffffffffu, v.y, s);
    const unsigned z = __shfl_sync(0xffffffffu, v.z, s), w = __shfl_sync(0xffffffffu, v.w, s);
    const unsigned a = lane & 1 ? z : x, b = lane & 1 ? w : y;
    const int j = 32 * r + lane;
    if (j < nout)
      store4(wdst + j, make_float4(bf16_lo(a) * 2.0f, bf16_hi(a) * 2.0f, bf16_lo(b) * 2.0f,
                                   bf16_hi(b) * 2.0f));
  }
}
__device__ __forceinline__ void store_doubled(float4* wdst, uint4 v, long long nout, float) {
  const int lane = threadIdx.x & 31;
  if (lane < nout)
    store4(wdst + lane, make_float4(__uint_as_float(v.x) * 2.0f, __uint_as_float(v.y) * 2.0f,
                                    __uint_as_float(v.z) * 2.0f, __uint_as_float(v.w) * 2.0f));
}

// vector u of this thread in tile `tile`
__device__ __forceinline__ long long vec_index(long long tile, int u) {
  return tile * kTile + u * kAThreads + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(kAThreads)
    double_kernel(const T* __restrict__ in, float* __restrict__ out, long long n, long long head) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = (n - head) / V;
  const long long tail = head + nvec * V;
  if (tid < head) out[tid] = eigen::to_float(in[tid]) * 2.0f;
  if (tid < n - tail) out[tail + tid] = eigen::to_float(in[tail + tid]) * 2.0f;
  const uint4* src = reinterpret_cast<const uint4*>(in + head);
  float4* dst = reinterpret_cast<float4*>(out + head);
  const long long ntiles = (nvec + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = vec_index(tile, u);
      v[u] = k < nvec ? __ldcs(src + k) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k0 = vec_index(tile, u) - lane;  // the warp's first vector
      if (k0 < nvec) store_doubled(dst + k0 * (V / 4), v[u], (nvec - k0) * (V / 4), T());
    }
  }
}

template <typename T>
int launch_double(const void* in, void* out, long long n, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  const uintptr_t a = (uintptr_t)in;
  if (a % sizeof(T) || (uintptr_t)out % sizeof(float)) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((16 - a % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long nvec = (n - head) / V;
  if (nvec > 0 && ((uintptr_t)out + 4 * head) % 16) return (int)cudaErrorMisalignedAddress;
  auto kernel = double_kernel<T>;
  long long blocks = (nvec + kTile - 1) / kTile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;  // the scalar head and tail
  kernel<<<(unsigned)blocks, kAThreads, 0, st>>>((const T*)in, (float*)out, n, head);
  return (int)cudaGetLastError();
}

}  // namespace

// variant_A: out = float32(c_prev) * 2, n elements; c_prev float32 or
// bfloat16 (c_prev_bf16 != 0).  out must sit as many float32 elements
// (mod 4) past a 16-byte boundary as c_prev sits elements of its type, so
// that both reach one after the same scalar head; otherwise it returns
// cudaErrorMisalignedAddress and launches nothing.
extern "C" int eigen_bisect_a(const void* c_prev, int c_prev_bf16, void* out, long long n,
                              void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (c_prev_bf16) return launch_double<__nv_bfloat16>(c_prev, out, n, st);
  return launch_double<float>(c_prev, out, n, st);
}

// The conv rungs.  xp: (B, H + 2, pitch, cin) bfloat16, the zero-padded
// input (pitch = W + 2, or Wp for J); wt: (9, C, 4, cin) bfloat16,
// [tap][channel][gate][input channel]; bias: (4C,) float32; c_prev and
// h_out: (B, H, W, C) float32 or bfloat16 (state_bf16 != 0); c_out: (B, H,
// W, C) float32.  All contiguous.  Each launches on `stream` and returns the
// CUDA error of the launch.
extern "C" int eigen_bisect_e(const void* xp, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, void* stream) {
  const Geometry g{B, H, W, cin, C, rows, W + 2, 0, 0};
  return launch_fused(xp, wt, bias, c_prev, state_bf16, h_out, c_out, g, stream);
}

extern "C" int eigen_bisect_j(const void* xp, const void* wt, const void* bias, const void* c_prev,
                              int state_bf16, void* h_out, void* c_out, int B, int H, int W,
                              int cin, int C, int rows, int wp, void* stream) {
  const Geometry g{B, H, W, cin, C, rows, wp, 0, 0};
  return launch_fused(xp, wt, bias, c_prev, state_bf16, h_out, c_out, g, stream);
}
