// Winograd-DH 3x3x3 stride-1 SAME convolution over NDHWC f32 activations,
// the Hopper (sm_90a) form in 3xTF32 on wgmma: F(2,3) x F(2,3) on the D and
// H axes and a direct 3-tap W axis, the channel products on the tensor cores
// at f32 accuracy. Two variants of one template:
//
//   winograd        y = conv(x, w). Replaces
//                   unet3d_tpu/ops/pallas/winograd_kernel.py _winograd_batched
//                   (:199, the pallas_call at :229), and its input gradient
//                   through _dgrad (:363).
//   winograd_stats  y plus per-(n, cout) f32 sum(y) and sum(y^2) of y as
//                   stored (f32). Replaces _winograd_batched_stats (:254,
//                   the pallas_call at :274).
//
// It takes every f32 call: any Cin and Cout, any alignment of x (4 bytes),
// D and H even. winograd_wgmma.cu takes the bf16 calls with Cin and Cout
// multiples of 8, winograd.cu the other bf16 calls.
//
// Math (winograd_kernel.winograd_reference in f32): output rows (2t, 2t+1)
// in D and (2s, 2s+1) in H of one column come from the padded input rows
// 2t..2t+3 x 2s..2s+3. B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
// over D, then over H, each one f32 add or subtract (the reference's own
// roundings, bit for bit); each of the 16 (jd, jh) points is a product over
// (dx, channel) with U2 = G w G^T over (dz, dy) in f32; A^T =
// [[1,1,1,0],[0,1,-1,-1]] folds each point's product into four (od, oh) f32
// accumulators after each channel chunk. No rounding at the store.
//
// What bounds it: the operations. Winograd-DH issues 48 of the direct
// conv's 108 products per output; in f32 on the CUDA cores (67 TFLOP/s)
// 192 -> 96 @ 64^3 takes >= 1.56 ms. On the tensor cores each product runs
// as three TF32 products (the 3xTF32 split, conv3d_tf32x3.cu's note: v = hi
// + lo, both TF32, hi = rna(v), lo = rna(v - hi); the product is lo*hi +
// hi*lo + hi*hi in f32, within 2^-22 of f32's), 495 / 3 TFLOP/s of f32-exact
// work: 0.703 ms at 192 -> 96 @ 64^3, 2.499 ms at 128 -> 64 @ 128^3.
//
// Design (winograd_wgmma.cu's pipeline, the bf16 form):
// * A block owns one item, one depth tile (2 output rows), BHT = 4 H tiles,
//   BW = 32 columns (128 positions, 64 per warpgroup) and BN output
//   channels (48, or 32 for Cout <= 32 and Cout 64).
// * Per 16-channel chunk the raw window (4 D rows x 10 H rows x 34 columns
//   of 16 f32 channels: 64-byte rows, 87,040 bytes, the bf16 form's rows,
//   swizzle and size) is staged once by cp.async, zero-filled outside the
//   volume (SAME padding) and past Cin, double-buffered (the next chunk
//   loads while this one's 16 points run): 16-byte copies where Cin % 4 ==
//   0 and x is 16-byte aligned, else four 4-byte copies per 16 bytes. Each
//   thread then replaces the four D rows of the columns it staged by their
//   D transform, in place, in f32.
// * The H transform is done in registers: the A fragment of point (jd, jh),
//   tap dx is row (jd, 2t + a, w + dx) -/+ row (jd, 2t + b, w + dx) of the
//   D-transformed window, both read by ldmatrix (an 8x8 b16 matrix is an
//   8x4 f32 one, and lane t receives row t / 4, column t % 4: the tf32 A
//   fragment), one f32 add or subtract, then split into its TF32 hi and lo
//   parts with cvt.rna.tf32.f32. No V tile is written.
// * B: tf32 wgmma reads B K-major only. The wrapper packs U2 once per call
//   (winograd_kernel.pack_u2_tf32) as (N tile, chunk, slab, {hi, lo}, BN,
//   32) with K ordered (point, dx, channel): each 128-byte row of a slab
//   holds four k8 steps, a point's six k8 steps span 1.5 slabs, read through
//   the 128-byte-swizzle descriptor. The hi and lo slabs of four steps travel
//   together through a STAGES-deep cp.async ring, loaded LEAD points ahead.
// * Per point: one barrier (the ring), eighteen wgmma m64nBNk8 tf32 (six k8
//   steps of lo*hi, hi*lo, hi*hi) into the point's accumulator, the first
//   with scale-d 0, wgmma.wait_group 0, the next point's A fragments loaded
//   and split, then the fold with A^T's signs into the four output
//   accumulators in f32 adds: the tensor cores never sum more than 18
//   products in a row. The other warpgroup's products run meanwhile.
// * Registers: one point's product (BN / 2 f32 a thread), the four output
//   tiles (2 BN) and the split A fragments of a point (48) stay live: BN <=
//   48 keeps them below 255. Shared memory: two windows (174,080 bytes) leave
//   57,344 for the ring: 4 slab pairs at BN = 48 (one point ahead), 7 at BN
//   = 32 (three points ahead).
// * Epilogue: the four (od, oh) tiles go to shared memory and out as
//   16-byte stores (4-byte ones where Cout % 4 != 0); STATS sums those f32
//   values per channel in registers and warp shuffles, then one atomicAdd
//   per (item, channel) per block into the caller-zeroed (N, 2, Cout)
//   buffer (the add order changes run to run).
//
// Built by nvcc with the other sources (kernels/build.py) and called through
// ctypes; ops/winograd_kernel.tf32_plan picks the configuration and is
// checked against CONFIGS when the library loads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90_wgmma.cuh"

namespace {

constexpr int BHT = 4;                  // H tiles (2 output rows each) per block
constexpr int BW = 32;                  // output columns per block
constexpr int BM = BHT * BW;            // positions per (od, oh)
constexpr int CK = 16;                  // input channels per chunk
constexpr int ROW_BYTES = CK * 4;       // one staged row
constexpr int RAW_H = 2 * BHT + 2;      // input rows of the H window
constexpr int RAW_W = BW + 2;           // input columns of the W window
constexpr int PLANE = RAW_H * RAW_W;    // rows of one D plane of the window
constexpr int RAW_BYTES = 4 * PLANE * ROW_BYTES;
constexpr int ITEMS = PLANE * (ROW_BYTES / 16);  // (column, 16-byte chunk) pairs
constexpr int POINTS = 16;
constexpr int SLAB_STEPS = 4;           // k8 steps per 128-byte slab row
constexpr int SLABS = POINTS * 3 * CK / 8 / SLAB_STEPS;  // per chunk: 24
constexpr int WARPGROUPS = 2;
constexpr int THREADS = WARPGROUPS * 128;

static_assert(RAW_BYTES % 1024 == 0, "the ring stays 1024-byte aligned");
static_assert(BM == WARPGROUPS * 64, "each warpgroup owns 64 positions");
static_assert(BW == 32 && RAW_W % 2 == 0, "a warp's 16 rows lie on one window line");

// the slab pairs in use at point g, from the first of point g (point g - 1's
// products are done) to the last of point g + lead, at their most
constexpr int ring_span(int lead) {
  int most = 0;
  for (int g = 0; g < 4; ++g) {  // 6 g mod 4 repeats every two points
    const int span = (6 * (g + lead) + 5) / 4 - (6 * g) / 4 + 1;
    most = span > most ? span : most;
  }
  return most;
}

// A^T[o][j]: the sign with which point j enters output row o
__host__ __device__ constexpr int at_sign(int o, int j) {
  return o == 0 ? (j == 3 ? 0 : 1) : (j == 0 ? 0 : (j == 1 ? 1 : -1));
}
// B^T point j of rows r0..r3: r[bt_a(j)] + bt_s(j) * r[bt_b(j)]
__host__ __device__ constexpr int bt_a(int j) { return j == 0 ? 0 : (j == 2 ? 2 : 1); }
__host__ __device__ constexpr int bt_b(int j) { return j == 0 || j == 1 ? 2 : (j == 2 ? 1 : 3); }
__host__ __device__ constexpr bool bt_add(int j) { return j == 1; }

__device__ __forceinline__ float f_op(float x, float y, bool add) { return add ? x + y : x - y; }

// byte offset of 16-byte chunk j of window row `row`, whose column is wr
__device__ __forceinline__ uint32_t swz(int row, int wr, int j) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((j ^ ((wr >> 1) & 3)) << 4));
}

struct Args {
  const float* x;     // (N, D, H, W, Cin)
  const float* u2;    // packed (n_tiles, chunks, SLABS, 2, BN, 32)
  float* y;           // (N, D, H, W, Cout)
  float* stats;       // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;
  int h_tiles, w_tiles, n_tiles, chunks;
  int vec_x;          // 16-byte copies of x: Cin % 4 == 0 and x 16-byte aligned
};

template <int BN, int STAGES, int LEAD>
struct Tile {
  static constexpr int SLAB_BYTES = 2 * BN * 128;  // the hi slab, then the lo slab
  static constexpr int C_PITCH = BN * 4 + 16;      // staged f32 output row, bytes
  static constexpr int SMEM = 2 * RAW_BYTES + STAGES * SLAB_BYTES + 1024;
  static_assert(BN % 16 == 0 && BN <= 48, "registers: 5 BN / 2 accumulators and 48 A parts");
  static_assert(LEAD >= 1 && STAGES >= ring_span(LEAD), "ring depth");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(4 * BM * C_PITCH <= 2 * RAW_BYTES, "the output tile fits the windows");
  static_assert(2 * 8 * BN * 4 <= STAGES * SLAB_BYTES, "statistics fit the ring");
};

template <int BN, int STAGES, int LEAD, bool STATS>
__global__ void __launch_bounds__(THREADS, 1) winograd_tf32x3(const Args a) {
  using Cfg = Tile<BN, STAGES, LEAD>;
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
  // (column, 16-byte chunk of 4 channels), each in all four D rows
  auto load_window = [&](int c, uint32_t buf) {
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int col = i >> 2, j = i & 3;
      const int hr = col / RAW_W, wr = col - hr * RAW_W;
      const int iy = 2 * th0 - 1 + hr, ix = w0 - 1 + wr, ch = c * CK + j * 4;
      const bool in_hw = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_;
#pragma unroll
      for (int dz = 0; dz < 4; ++dz) {
        const int iz = 2 * td - 1 + dz;
        const bool in = in_hw && iz >= 0 && iz < a.d;
        const float* src =
            in ? a.x + (((static_cast<long long>(item) * a.d + iz) * a.h + iy) * a.w_ + ix) *
                           a.cin + ch
               : a.x;
        const uint32_t dst = buf + swz(dz * PLANE + col, wr, j);
        if (a.vec_x) {
          const bool ok = in && ch < a.cin;  // Cin % 4 == 0: the group lies inside Cin
          cp_async16(dst, ok ? src : a.x, ok);
        } else {  // any Cin and alignment: one 4-byte copy per channel
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = in && ch + e < a.cin;
            cp_async4(dst + 4 * e, ok ? src + e : a.x, ok);
          }
        }
      }
    }
  };
  // D transform of the items this thread staged, in place: plane jd becomes
  // B^T_D point jd, in f32 (its own cp.async wait suffices)
  auto d_transform = [&](uint32_t buf) {
    uint8_t* const base = smem + (buf - win0);
    for (int i = tid; i < ITEMS; i += THREADS) {
      const int col = i >> 2, j = i & 3;
      const int wr = col % RAW_W;
      float4 r[4];
#pragma unroll
      for (int dz = 0; dz < 4; ++dz)
        r[dz] = *reinterpret_cast<const float4*>(base + swz(dz * PLANE + col, wr, j));
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        const float4 ra = r[bt_a(jd)], rb = r[bt_b(jd)];
        float4 v;
        v.x = f_op(ra.x, rb.x, bt_add(jd));
        v.y = f_op(ra.y, rb.y, bt_add(jd));
        v.z = f_op(ra.z, rb.z, bt_add(jd));
        v.w = f_op(ra.w, rb.w, bt_add(jd));
        *reinterpret_cast<float4*>(base + swz(jd * PLANE + col, wr, j)) = v;
      }
    }
  };
  const int total_slabs = a.chunks * SLABS;
  const float* const u2 = a.u2 + static_cast<long long>(nt) * total_slabs * 2 * BN * 32;
  // this thread's 16-byte groups of a slab pair (2 BN rows of 128 bytes):
  // group i = tid + r * THREADS is row i / 8, chunk i % 8 (swizzled)
  constexpr int PAIR_GROUPS = 2 * BN * 8;
  constexpr int SLAB_PASSES = (PAIR_GROUPS + THREADS - 1) / THREADS;
  uint32_t slab_dst[SLAB_PASSES];
#pragma unroll
  for (int r = 0; r < SLAB_PASSES; ++r) {
    const int i = tid + r * THREADS;
    slab_dst[r] = (i >> 3) * 128 + (((i & 7) ^ ((i >> 3) & 7)) << 4);
  }
  auto load_slab = [&](int s) {
    if (s >= total_slabs) return;
    const float* src = u2 + static_cast<long long>(s) * 2 * BN * 32 + tid * 4;
    const uint32_t base = ring + (s % STAGES) * Cfg::SLAB_BYTES;
#pragma unroll
    for (int r = 0; r < SLAB_PASSES; ++r)
      if (tid + r * THREADS < PAIR_GROUPS)
        cp_async16(base + slab_dst[r], src + r * THREADS * 4, true);
  };

  // this lane's A rows: position (t, w) of its warp's 16; lb[dx][ks] is the
  // address of its ldmatrix row at window row (0, 2t, w + dx), chunk ks*2 + lane/16
  const int t = wg * 2 + (wq >> 1), w = (wq & 1) * 16 + (lane & 15);
  const int row0 = 2 * t * RAW_W + w;
  uint32_t lb[3][2];
  // the A fragments of point (jd, jh), all three taps: V = B^T_H over the
  // D-transformed rows in f32, split into TF32 hi and lo
  uint32_t ahi[3][2][4], alo[3][2][4];
  auto load_a = [&](int jd, int jh) {
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
        for (int r = 0; r < 4; ++r)
          tf32_split(f_op(__uint_as_float(u[r]), __uint_as_float(v[r]), bt_add(jh)),
                     ahi[dx][ks][r], alo[dx][ks][r]);
      }
  };
  auto fence_a = [&]() {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        fence_operands(ahi[dx][ks]);
        fence_operands(alo[dx][ks]);
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
        if (first) load_a(jd, jh);

        fence_a();
        fence_operands(pacc);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int q = 6 * jh + 2 * dx + ks;  // k8 step from slab sb
            const uint32_t off =
                ((sb + q / SLAB_STEPS) % STAGES) * Cfg::SLAB_BYTES + (q % SLAB_STEPS) * 32;
            const uint64_t dhi = desc0 + (off >> 4);
            const uint64_t dlo = desc0 + ((off + BN * 128) >> 4);
            WgmmaTf32<BN>::mma(alo[dx][ks], dhi, pacc, dx + ks > 0);
            WgmmaTf32<BN>::mma(ahi[dx][ks], dlo, pacc);
            WgmmaTf32<BN>::mma(ahi[dx][ks], dhi, pacc);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(pacc);
        fence_a();
        // the next point's A loads and splits, then the fold; the other
        // warpgroup's products run meanwhile
        if (jh < 3) load_a(jd, jh + 1);
        else if (jd < 3) load_a(jd + 1, 0);
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
        const float2 v = make_float2(out[o][4 * i + 2 * hi], out[o][4 * i + 2 * hi + 1]);
        *reinterpret_cast<float2*>(ctile + r * Cfg::C_PITCH + (8 * i + 2 * (lane & 3)) * 4) = v;
        if constexpr (STATS) {
          if (row_ok[o][hi]) {
            s1[0] += v.x; s2[0] += v.x * v.x;
            s1[1] += v.y; s2[1] += v.y * v.y;
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

  auto voxel_of = [&](int r, long long& vox) {
    const int o = r / BM, pm = r % BM;
    const int oz = 2 * td + (o >> 1), oy = 2 * (th0 + (pm >> 5)) + (o & 1), ox = w0 + (pm & 31);
    vox = ((static_cast<long long>(item) * a.d + oz) * a.h + oy) * a.w_ + ox;
    return oy < a.h && ox < a.w_;
  };
  if (a.cout % 4 == 0) {
    // y: consecutive threads store consecutive 16-byte groups of channels
    constexpr int GROUPS = BN / 4;
    for (int i = tid; i < 4 * BM * GROUPS; i += THREADS) {
      const int r = i / GROUPS, q = i - r * GROUPS;
      const int co = nt * BN + q * 4;
      long long vox;
      if (voxel_of(r, vox) && co < a.cout)
        *reinterpret_cast<uint4*>(a.y + vox * a.cout + co) =
            *reinterpret_cast<const uint4*>(ctile + r * Cfg::C_PITCH + q * 16);
    }
  } else {  // rows of Cout f32 are not 16-byte aligned
    for (int i = tid; i < 4 * BM * BN; i += THREADS) {
      const int r = i / BN, q = i - r * BN;
      const int co = nt * BN + q;
      long long vox;
      if (voxel_of(r, vox) && co < a.cout)
        a.y[vox * a.cout + co] = *reinterpret_cast<const float*>(ctile + r * Cfg::C_PITCH + q * 4);
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

template <int BN, int STAGES, int LEAD, bool STATS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Cfg = Tile<BN, STAGES, LEAD>;
  auto kernel = winograd_tf32x3<BN, STAGES, LEAD, STATS>;
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

template <int BN, int STAGES, int LEAD>
cudaError_t dispatch(int stats, const Args& a, cudaStream_t stream) {
  return stats ? launch<BN, STAGES, LEAD, true>(a, stream)
               : launch<BN, STAGES, LEAD, false>(a, stream);
}

// the tile configurations, by index: H tiles and columns per block (BHT, BW),
// output channels per block (BN), input channels per chunk (CK), slab pairs
// in the ring, points whose slabs load ahead. ops/winograd_kernel.py
// (TF32_CONFIGS) picks one per call and checks this table against its own
// when the library loads.
constexpr int CONFIGS[][6] = {
    {BHT, BW, 48, CK, 4, 1},
    {BHT, BW, 32, CK, 7, 3},
};
constexpr int N_CONFIGS = sizeof(CONFIGS) / sizeof(CONFIGS[0]);

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

// stats: 0 = winograd, 1 = winograd_stats; config: an index of CONFIGS. u2 is
// the packed transformed weight (n_tiles, chunks, 24, 2, BN, 32) and y are
// 16-byte aligned; x (N, D, H, W, Cin) f32, 4-byte aligned, any Cin and
// Cout, D and H even; h_tiles, w_tiles, n_tiles and chunks as the
// configuration cuts the shape. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int unet3d_winograd_tf32x3(int stats, int config, const void* x, const void* u2,
                                      void* y, float* stats_buf, int n, int d, int h, int w_,
                                      int cin, int cout, int h_tiles, int w_tiles, int n_tiles,
                                      int chunks, void* stream) {
  if (cin < 1 || cout < 1 || d % 2 != 0 || h % 2 != 0 || !aligned(x, 4) || !aligned(u2, 16) ||
      !aligned(y, 16) || (stats && !stats_buf))
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x), static_cast<const float*>(u2), static_cast<float*>(y),
         stats_buf, n, d, h, w_, cin, cout, h_tiles, w_tiles, n_tiles, chunks,
         cin % 4 == 0 && aligned(x, 16)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return dispatch<48, 4, 1>(stats, a, s);
    case 1: return dispatch<32, 7, 3>(stats, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the six numbers of tile configuration `config` into out; -1 past the table
extern "C" int unet3d_winograd_tf32x3_config(int config, int* out) {
  if (config < 0 || config >= N_CONFIGS) return -1;
  for (int i = 0; i < 6; ++i) out[i] = CONFIGS[config][i];
  return 0;
}
