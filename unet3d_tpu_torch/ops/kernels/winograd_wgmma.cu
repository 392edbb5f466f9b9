// Winograd-DH 3x3x3 stride-1 SAME convolution over NDHWC bf16 activations,
// the Hopper (sm_90a) form: F(2,3) x F(2,3) on the D and H axes and a direct
// 3-tap W axis, the channel products on wgmma. Two variants of one template:
//
//   winograd        y = conv(x, w). Replaces
//                   unet3d_tpu/ops/pallas/winograd_kernel.py _winograd_batched
//                   (the pallas_call at :229).
//   winograd_stats  y plus per-(n, cout) f32 sum(y) and sum(y^2) of y as
//                   rounded to bf16. Replaces _winograd_batched_stats (:274).
//
// It takes every bf16 call with Cin and Cout multiples of 8 (every Winograd
// site of the BraTS DynUNet: Cin 96, 128, 192, Cout 64, 96, 192);
// winograd_tf32x3.cu takes the f32 calls, winograd.cu's WMMA form the bf16
// calls of other channel counts.
//
// Math (the JAX kernel's, winograd_kernel.py:143-193): output rows (2t, 2t+1)
// in D and (2s, 2s+1) in H of one column come from the padded input rows
// 2t..2t+3 x 2s..2s+3. B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] over
// D, rounded to bf16, then over H, rounded to bf16; each of the 16 (jd, jh)
// points is a product over (dx, channel) with U2 = G w G^T over (dz, dy),
// rounded to bf16; A^T = [[1,1,1,0],[0,1,-1,-1]] folds each point's f32
// product into four (od, oh) f32 accumulators after each channel chunk (the
// JAX kernel folds after the whole channel sum: the same f32 sums in another
// order). One rounding at the store.
//
// What bounds it (989 TFLOP/s bf16, 3.35 TB/s): the operations, 48 of the
// direct conv's 108 products per output. 192 -> 96 @ 64^3 is 0.117 ms of
// products against 0.045 ms of bytes; 128 -> 64 @ 128^3 0.417 against 0.16.
// Inside the SM three things press on it:
// * U2 is 48 distinct Cin x Cout matrices, none shared between points, so
//   each block re-reads 48 * Cin * BN * 2 bytes of it from L2: 1 / BM bytes
//   per flop with BM positions per block. BM = 128 (two warpgroups of 64
//   positions; the older form had 64) halves that against the older form:
//   32 bytes per clock per SM at the full tensor rate, about what L2 feeds.
// * Registers: a warpgroup keeps one point's product (BN / 2 f32 a thread)
//   and the four output accumulators (2 BN) beside its A fragments (24), so
//   5 BN / 2 <= 160 at BN <= 64: BN = 64 (Cout 64 and 192) or 48 (Cout 96,
//   two N tiles), one block of 256 threads per SM.
// * Shared memory: the raw window of one chunk is 4 x (2 BHT + 2) x (BW + 2)
//   rows of CK channels: 87,040 bytes at BHT = 4, BW = 32, CK = 32, so two
//   fit beside a 7-slab B ring (232,448 bytes at BN = 64; 8 slabs below).
//   CK = 32 also runs Cin = 96 as three whole chunks, with no zero half chunk.
//
// Design:
// * A block owns one item, one depth tile (2 output rows), BHT = 4 H tiles,
//   BW = 32 columns (128 positions) and BN output channels; blocks run in any
//   order, N tiles of one window neighbours in launch order (L2).
// * Per 32-channel chunk, the raw window is staged once by cp.async, zero-
//   filled outside the volume (SAME padding) and past Cin, double-buffered
//   (the next chunk loads while this one's 16 points run). Each thread then
//   replaces the four D rows of the columns it staged by their D transform,
//   in place and in bf16x2 arithmetic (one rounding, as the f32 sum rounded
//   to bf16: the sum of two bf16 values is exact in f32 or far from a tie).
// * The H transform is done in registers: for point (jd, jh) and tap dx the
//   A fragment of position (t, w) is row (jd, 2t + a, w + dx) -/+ row (jd,
//   2t + b, w + dx) of the D-transformed window; both come by ldmatrix from
//   any row address (the RS form of wgmma), and one bf16x2 add or subtract
//   rounds them. No V tile is written, no barrier per transform. Rows are
//   64 bytes; the 16-byte chunk j of window column wr sits at j ^ (wr / 2 % 4),
//   so the eight rows of one ldmatrix read hit eight bank groups.
// * B: the wrapper packs U2 once per call (winograd_kernel.pack_u2) as
//   (N tile, chunk, slab, BN, 64) with K ordered (point, dx, channel): each
//   128-byte slab holds two (point, dx) pairs of 32 channels, so a point's six
//   k16 steps span 1.5 slabs, read through the 128-byte-swizzle descriptor.
//   Slabs run through a 7- or 8-deep cp.async ring, loaded three points
//   ahead.
// * Per point: one barrier (the ring), the six wgmmas into the point's
//   accumulator (the first with scale-d 0), wgmma.wait_group 0, the next
//   point's A fragments loaded (their latency behind the fold), then the fold
//   with A^T's signs into the four output accumulators; the other warpgroup's
//   products run meanwhile. jd runs as a loop, jh unrolled: the fold's H
//   signs and the slab offsets are constants and four points' code stays in
//   the instruction cache. Register fences (fence_operands) keep the fold's
//   reads and the A loads out of the wgmmas' pipeline stage: ptxas serializes
//   the wgmmas otherwise. A fold overlapped with the next point's products
//   (two accumulators, wait_group 1) is serialized by ptxas all the same.
// * Epilogue: the four (od, oh) tiles go to shared memory as bf16 and out as
//   16-byte stores; STATS sums those rounded values per channel in registers
//   and warp shuffles, then one atomicAdd per (item, channel) per block into
//   the caller-zeroed (N, 2, Cout) buffer (the add order changes run to run).
//
// Measured on an H100 (PERF.md; tools/winograd_variants.py): 16-23% of the
// bound, 5-7x the WMMA form; no one part sets the pace. Left out one at a
// time, the products save 39-42%, the second H-transform read of each A
// fragment 9-12%, the barrier 8-12%, the U2 slab loads 6-10%, the fold 4-7%,
// the window loads 1-6%: the two warpgroups wait, load A (two rows a
// fragment, most of the shared-memory traffic) and fold in step.
//
// Built by nvcc with the other sources (kernels/build.py) and called through
// ctypes; ops/winograd_kernel.wgmma_plan picks the configuration and is
// checked against CONFIGS when the library loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BHT = 4;                  // H tiles (2 output rows each) per block
constexpr int BW = 32;                  // output columns per block
constexpr int BM = BHT * BW;            // positions per (od, oh)
constexpr int CK = 32;                  // input channels per chunk
constexpr int ROW_BYTES = CK * 2;       // one staged row
constexpr int RAW_H = 2 * BHT + 2;      // input rows of the H window
constexpr int RAW_W = BW + 2;           // input columns of the W window
constexpr int PLANE = RAW_H * RAW_W;    // rows of one D plane of the window
constexpr int RAW_BYTES = 4 * PLANE * ROW_BYTES;
constexpr int ITEMS = PLANE * (ROW_BYTES / 16);  // (column, 16-byte chunk) pairs
constexpr int POINTS = 16;
constexpr int SLAB_STEPS = 4;           // k16 steps per 128-byte slab
constexpr int SLABS = POINTS * 3 * CK / 16 / SLAB_STEPS;  // per chunk: 24
constexpr int LEAD = 3;                 // points whose slabs load ahead
constexpr int WARPGROUPS = 2;
constexpr int THREADS = WARPGROUPS * 128;

static_assert(RAW_BYTES % 1024 == 0, "the ring stays 1024-byte aligned");
static_assert(BM == WARPGROUPS * 64, "each warpgroup owns 64 positions");
static_assert(BW == 32 && RAW_W % 2 == 0, "a warp's 16 rows lie on one window line");
// the slabs in use at point g, from the first of point g (point g - 1's
// products are done) to the last of point g + LEAD:
// floor((6 (g + LEAD) + 5) / 4) - floor(6 g / 4), the most at odd g
constexpr int RING_SPAN = (6 * (1 + LEAD) + 5) / 4 - 6 / 4 + 1;

// A^T[o][j]: the sign with which point j enters output row o
__host__ __device__ constexpr int at_sign(int o, int j) {
  return o == 0 ? (j == 3 ? 0 : 1) : (j == 0 ? 0 : (j == 1 ? 1 : -1));
}
// B^T point j of rows r0..r3: r[bt_a(j)] + bt_s(j) * r[bt_b(j)]
__host__ __device__ constexpr int bt_a(int j) { return j == 0 ? 0 : (j == 2 ? 2 : 1); }
__host__ __device__ constexpr int bt_b(int j) { return j == 0 || j == 1 ? 2 : (j == 2 ? 1 : 3); }
__host__ __device__ constexpr bool bt_add(int j) { return j == 1; }

__device__ __forceinline__ uint32_t bf2_op(uint32_t x, uint32_t y, bool add) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&y);
  const __nv_bfloat162 r = add ? __hadd2(a, b) : __hsub2(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// byte offset of 16-byte chunk j of window row `row`, whose column is wr
__device__ __forceinline__ uint32_t swz(int row, int wr, int j) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((j ^ ((wr >> 1) & 3)) << 4));
}

struct Args {
  const bf16* x;      // (N, D, H, W, Cin)
  const bf16* u2;     // packed (n_tiles, chunks, SLABS, BN, 64)
  bf16* y;            // (N, D, H, W, Cout)
  float* stats;       // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;
  int h_tiles, w_tiles, n_tiles, chunks;
};

template <int BN, int STAGES>
struct Tile {
  static constexpr int SLAB_BYTES = BN * 128;
  static constexpr int C_PITCH = BN * 2 + 16;  // staged bf16 output row, bytes
  static constexpr int SMEM = 2 * RAW_BYTES + STAGES * SLAB_BYTES + 1024;
  static_assert(BN % 16 == 0 && BN <= 64, "5 BN / 2 accumulators a thread");
  static_assert(STAGES >= RING_SPAN, "ring depth");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(4 * BM * C_PITCH <= 2 * RAW_BYTES, "the output tile fits the windows");
  static_assert(2 * 8 * BN * 4 <= STAGES * SLAB_BYTES, "statistics fit the ring");
};

template <int BN, int STAGES, bool STATS>
__global__ void __launch_bounds__(THREADS, 1) winograd_wgmma(const Args a) {
  using Cfg = Tile<BN, STAGES>;
  constexpr int NACC = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t win0 = smem_u32(smem);
  const uint32_t ring = win0 + 2 * RAW_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;

  // block -> (n tile, W tile, H tile group, depth tile, item), n tile fastest
  int bid = blockIdx.x;
  const int nt = bid % a.n_tiles; bid /= a.n_tiles;
  const int w0 = (bid % a.w_tiles) * BW; bid /= a.w_tiles;
  const int th0 = (bid % a.h_tiles) * BHT; bid /= a.h_tiles;
  const int td = bid % (a.d / 2);
  const int item = bid / (a.d / 2);

  // the window of chunk c: D rows 2td-1 .. 2td+2, H rows 2th0-1 .. 2th0+2BHT,
  // W columns w0-1 .. w0+BW; thread -> items tid, tid + THREADS, ... of
  // (column, 16-byte chunk), each in all four D rows
  auto load_window = [&](int c, uint32_t buf) {
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int col = i >> 2, j = i & 3;
      const int hr = col / RAW_W, wr = col - hr * RAW_W;
      const int iy = 2 * th0 - 1 + hr, ix = w0 - 1 + wr, ch = c * CK + j * 8;
      const bool in_hw = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_ && ch < a.cin;
#pragma unroll
      for (int dz = 0; dz < 4; ++dz) {
        const int iz = 2 * td - 1 + dz;
        const bool ok = in_hw && iz >= 0 && iz < a.d;
        const bf16* src =
            ok ? a.x + (((static_cast<long long>(item) * a.d + iz) * a.h + iy) * a.w_ + ix) *
                           a.cin + ch
               : a.x;
        cp_async16(buf + swz(dz * PLANE + col, wr, j), src, ok);
      }
    }
  };
  // D transform of the items this thread staged, in place: plane jd becomes
  // B^T_D point jd, rounded to bf16 (its own cp.async wait suffices)
  auto d_transform = [&](uint32_t buf) {
    uint8_t* const base = smem + (buf - win0);
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int col = i >> 2, j = i & 3;
      const int wr = col % RAW_W;
      uint4 r[4];
#pragma unroll
      for (int dz = 0; dz < 4; ++dz)
        r[dz] = *reinterpret_cast<const uint4*>(base + swz(dz * PLANE + col, wr, j));
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        const uint32_t* ra = reinterpret_cast<const uint32_t*>(&r[bt_a(jd)]);
        const uint32_t* rb = reinterpret_cast<const uint32_t*>(&r[bt_b(jd)]);
        uint4 v;
        v.x = bf2_op(ra[0], rb[0], bt_add(jd));
        v.y = bf2_op(ra[1], rb[1], bt_add(jd));
        v.z = bf2_op(ra[2], rb[2], bt_add(jd));
        v.w = bf2_op(ra[3], rb[3], bt_add(jd));
        *reinterpret_cast<uint4*>(base + swz(jd * PLANE + col, wr, j)) = v;
      }
    }
  };
  const int total_slabs = a.chunks * SLABS;
  const bf16* const u2 = a.u2 + static_cast<long long>(nt) * total_slabs * BN * 64;
  // this thread's 16-byte groups of a slab: group i = tid + r * THREADS is
  // row i / 8, chunk i % 8 (swizzled)
  constexpr int SLAB_PASSES = (BN * 8 + THREADS - 1) / THREADS;
  uint32_t slab_dst[SLAB_PASSES];
#pragma unroll
  for (int r = 0; r < SLAB_PASSES; ++r) {
    const int i = tid + r * THREADS;
    slab_dst[r] = (i >> 3) * 128 + (((i & 7) ^ ((i >> 3) & 7)) << 4);
  }
  auto load_slab = [&](int s) {
    if (s >= total_slabs) return;
    const bf16* src = u2 + static_cast<long long>(s) * BN * 64 + tid * 8;
    const uint32_t base = ring + (s % STAGES) * Cfg::SLAB_BYTES;
#pragma unroll
    for (int r = 0; r < SLAB_PASSES; ++r)
      if (tid + r * THREADS < BN * 8) cp_async16(base + slab_dst[r], src + r * THREADS * 8, true);
  };

  // this lane's A rows: position (t, w) of its warp's 16; lb[dx][ks] is the
  // address of its ldmatrix row at window row (0, 2t, w + dx), chunk ks*2 + lane/16
  const int t = wg * 2 + (wq >> 1), w = (wq & 1) * 16 + (lane & 15);
  const int row0 = 2 * t * RAW_W + w;
  uint32_t lb[3][2];
  // the A fragments of point (jd, jh), all three taps: V = B^T_H over the
  // D-transformed rows, one rounding per bf16x2 add or subtract
  auto load_a = [&](int jd, int jh, uint32_t (&af)[3][2][4]) {
    const uint32_t ra = (jd * PLANE + bt_a(jh) * RAW_W) * ROW_BYTES;
    const uint32_t rb = (jd * PLANE + bt_b(jh) * RAW_W) * ROW_BYTES;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t u[4], v[4];
        ldmatrix_x4(lb[dx][ks] + ra, u);
        ldmatrix_x4(lb[dx][ks] + rb, v);
#pragma unroll
        for (int r = 0; r < 4; ++r) af[dx][ks][r] = bf2_op(u[r], v[r], bt_add(jh));
      }
  };

  // out[od * 2 + oh]: the four output tiles; pacc: one point's product
  float out[4][NACC], pacc[NACC];
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < NACC; ++i) out[o][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NACC; ++i) pacc[i] = 0.f;
  uint32_t afrag[3][2][4];  // the A fragments of one point
  auto fence_a = [&]() {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) fence_operands(afrag[dx][ks]);
  };
  // fold point (jd, jh)'s product into the tiles with sign A^T[od][jd] *
  // A^T[oh][jh]; jh is a constant, the zero halves of jd are skipped
  auto fold = [&](int jd, int jh) {
#pragma unroll
    for (int oh = 0; oh < 2; ++oh) {
      const int ch = at_sign(oh, jh);
      if (ch == 0) continue;
      if (jd < 3) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) out[oh][i] += ch > 0 ? pacc[i] : -pacc[i];
      }
      if (jd > 0) {
        const float c1 = static_cast<float>(at_sign(1, jd) * ch);
#pragma unroll
        for (int i = 0; i < NACC; ++i) out[2 + oh][i] = fmaf(c1, pacc[i], out[2 + oh][i]);
      }
    }
  };

  load_window(0, win0);
#pragma unroll
  for (int g = 0; g < LEAD; ++g) {
    for (int s = (6 * g + 3) / 4; s <= (6 * g + 5) / 4; ++s) load_slab(s);
    cp_async_commit();
  }
  const uint64_t desc0 = desc_sw128(ring);

  for (int c = 0; c < a.chunks; ++c) {
    const uint32_t buf = win0 + (c & 1) * RAW_BYTES;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) lb[dx][ks] = buf + swz(row0 + dx, w + dx, ks * 2 + (lane >> 4));
    // points (jd, jh), g = 16 c + 4 jd + jh: jd at run time, jh unrolled, so
    // the slab offsets within a jd and the signs of H's fold are constants
    // and the code of four points stays in the instruction cache
#pragma unroll 1
    for (int jd = 0; jd < 4; ++jd) {
      const int sb = c * SLABS + jd * 6;  // the first slab of point (c, jd, 0)
#pragma unroll
      for (int jh = 0; jh < 4; ++jh) {
        const int first = jd == 0 && jh == 0;  // the chunk's first point
        cp_async_wait<LEAD - 1>();  // this thread's copies for this point landed
        if (first) d_transform(buf);
        fence_proxy_async();
        __syncthreads();
        // the slabs point g + LEAD reads first: sb + (6 (jh + LEAD) + 3) / 4 ..
        for (int k = (6 * (jh + LEAD) + 3) / 4; k <= (6 * (jh + LEAD) + 5) / 4; ++k)
          load_slab(sb + k);
        if (first && c + 1 < a.chunks) load_window(c + 1, win0 + ((c + 1) & 1) * RAW_BYTES);
        cp_async_commit();
        if (first) load_a(jd, jh, afrag);

        fence_a();
        fence_operands(pacc);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int q = 6 * jh + 2 * dx + ks;  // k16 step from slab sb
            const uint32_t off =
                ((sb + q / SLAB_STEPS) % STAGES) * Cfg::SLAB_BYTES + (q % SLAB_STEPS) * 32;
            Wgmma<BN>::mma(afrag[dx][ks], desc0 + (off >> 4), pacc, dx + ks > 0);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(pacc);
        fence_a();
        // the next point's A loads (their latency hidden by the fold), then
        // the fold; the other warpgroup's products run meanwhile
        if (jh < 3) load_a(jd, jh + 1, afrag);
        else if (jd < 3) load_a(jd + 1, 0, afrag);
        fold(jd, jh);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue. Accumulator i of a thread is row wq * 16 + lane / 4 + 8 hi of
  // its warpgroup's 64 positions, column 8 (i / 4) + 2 (lane % 4) + e, with
  // i = 4 (i / 4) + 2 hi + e; output tile (od, oh) = o is staged at row
  // o * BM + wg * 64 + that row
  uint8_t* const ctile = smem;  // the windows, now free
  float* const red = reinterpret_cast<float*>(smem + 2 * RAW_BYTES);  // [2][8 warps][BN]
  bool row_ok[4][2];
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int m = wq * 16 + (lane >> 2) + 8 * hi;
      const int oy = 2 * (th0 + wg * 2 + (m >> 5)) + (o & 1), ox = w0 + (m & 31);
      row_ok[o][hi] = oy < a.h && ox < a.w_;
    }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = o * BM + wg * 64 + wq * 16 + (lane >> 2) + 8 * hi;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(out[o][4 * i + 2 * hi], out[o][4 * i + 2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ctile + r * Cfg::C_PITCH +
                                           (8 * i + 2 * (lane & 3)) * 2) = v;
        if constexpr (STATS) {
          if (row_ok[o][hi]) {
            const float2 f = __bfloat1622float2(v);
            s1[0] += f.x; s2[0] += f.x * f.x;
            s1[1] += f.y; s2[1] += f.y * f.y;
          }
        }
      }
    }
    if constexpr (STATS) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[warp * BN + 8 * i + 2 * lane + e] = s1[e];
          red[(8 + warp) * BN + 8 * i + 2 * lane + e] = s2[e];
        }
      }
    }
  }
  __syncthreads();

  // y: consecutive threads store consecutive 16-byte groups of channels
  constexpr int GROUPS = BN / 8;
  for (int i = tid; i < 4 * BM * GROUPS; i += THREADS) {
    const int r = i / GROUPS, q = i - r * GROUPS;
    const int o = r / BM, pm = r % BM;
    const int oz = 2 * td + (o >> 1), oy = 2 * (th0 + (pm >> 5)) + (o & 1), ox = w0 + (pm & 31);
    const int co = nt * BN + q * 8;
    if (oy < a.h && ox < a.w_ && co < a.cout) {
      const long long vox = ((static_cast<long long>(item) * a.d + oz) * a.h + oy) * a.w_ + ox;
      *reinterpret_cast<uint4*>(a.y + vox * a.cout + co) =
          *reinterpret_cast<const uint4*>(ctile + r * Cfg::C_PITCH + q * 16);
    }
  }
  if constexpr (STATS) {
    for (int col = tid; col < BN; col += THREADS) {
      const int co = nt * BN + col;
      if (co >= a.cout) continue;
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        t1 += red[q * BN + col];
        t2 += red[(8 + q) * BN + col];
      }
      atomicAdd(a.stats + (2LL * item) * a.cout + co, t1);
      atomicAdd(a.stats + (2LL * item + 1) * a.cout + co, t2);
    }
  }
}

template <int BN, int STAGES, bool STATS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Cfg = Tile<BN, STAGES>;
  auto kernel = winograd_wgmma<BN, STAGES, STATS>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  if (a.h_tiles != (a.h / 2 + BHT - 1) / BHT || a.w_tiles != (a.w_ + BW - 1) / BW ||
      a.n_tiles != (a.cout + BN - 1) / BN || a.chunks != (a.cin + CK - 1) / CK)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(a.n) * (a.d / 2) * a.h_tiles *
                           a.w_tiles * a.n_tiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int BN, int STAGES>
cudaError_t dispatch(int stats, const Args& a, cudaStream_t stream) {
  return stats ? launch<BN, STAGES, true>(a, stream) : launch<BN, STAGES, false>(a, stream);
}

// the tile configurations, by index: H tiles and columns per block (BHT, BW),
// output channels per block (BN), input channels per chunk (CK), ring slabs.
// ops/winograd_kernel.py (WGMMA_CONFIGS) picks one per call and checks this
// table against its own when the library loads.
constexpr int CONFIGS[][5] = {
    {BHT, BW, 64, CK, 7},
    {BHT, BW, 48, CK, 8},
};
constexpr int N_CONFIGS = sizeof(CONFIGS) / sizeof(CONFIGS[0]);

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// stats: 0 = winograd, 1 = winograd_stats; config: an index of CONFIGS. u2 is
// the packed transformed weight (n_tiles, chunks, 24, BN, 64); x, u2 and y
// 16-byte aligned, Cin and Cout multiples of 8, D and H even; h_tiles, w_tiles,
// n_tiles and chunks as the configuration cuts the shape. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int unet3d_winograd_wgmma(int stats, int config, const void* x, const void* u2,
                                     void* y, float* stats_buf, int n, int d, int h, int w_,
                                     int cin, int cout, int h_tiles, int w_tiles, int n_tiles,
                                     int chunks, void* stream) {
  if (cin % 8 != 0 || cout % 8 != 0 || d % 2 != 0 || h % 2 != 0 || !aligned16(x) ||
      !aligned16(u2) || !aligned16(y) || (stats && !stats_buf))
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(u2), static_cast<bf16*>(y),
         stats_buf, n, d, h, w_, cin, cout, h_tiles, w_tiles, n_tiles, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return dispatch<64, 7>(stats, a, s);
    case 1: return dispatch<48, 8>(stats, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the five numbers of tile configuration `config` into out; -1 past the table
extern "C" int unet3d_winograd_wgmma_config(int config, int* out) {
  if (config < 0 || config >= N_CONFIGS) return -1;
  for (int i = 0; i < 5; ++i) out[i] = CONFIGS[config][i];
  return 0;
}
