// Weight gradient of the 3x3x3 stride-2 convolution with symmetric pads of 1
// over NDHWC bf16 activations, the Hopper (sm_90a) form:
//
//   dw[kd, kh, kw, ci, co] = sum_{n, od, oh, ow}
//       xp[n, 2od + kd, 2oh + kh, 2ow + kw, ci] * g[n, od, oh, ow, co]
//
// with xp the input padded by one voxel of zeros on every side (on D, by
// pad_lo below: 0 in the D-halo mode, where x's first plane is the slab's
// neighbour below). Replaces
// unet3d_tpu/ops/pallas/s2_wgrad_kernel.py:158 (s2_wgrad_pallas, whose
// pallas_call is at :177) for every bf16 call with Cin and Cout multiples of
// 8, which is every stride-2 site of the DynUNet; s2_wgrad.cu keeps the f32
// form and a bf16 WMMA form for other channel counts.
//
// What bounds it (inputs read once, the f32 dw written once; 989 TFLOP/s
// bf16, 3.35 TB/s): at the BraTS level 0 (x 128^3, 64 -> 96) the bytes, 319
// MB against 87 GFLOP (0.095 ms against 0.088); at 64^3 (96 -> 128) and 32^3
// (128 -> 192) the operations (0.022 and 0.0055 ms); at 16^3 and 8^3 the
// bytes again, mostly the dw write (0.0021 and 0.0033 ms). The older form
// gathered every (tap, ci) row of A from device memory for every output
// voxel, 6.75x the bytes of x at level 0, with no overlap of loads and math.
//
// Design. A GEMM with M = 27 * Cin rows ordered (tap, ci), N = Cout and K =
// the output voxels:
// * A block owns the three kw taps of one (kd, kh) pair for one 64-channel
//   chunk of Cin (three 64-row M tiles, one per warpgroup) and BN output
//   channels (BN = Cout where Cout <= 192, else 128- or 192-wide tiles), and
//   walks its share of K in segments of 64 output voxels: `lines` output
//   x-lines of `sw` voxels each (sw = 64 at level 0, down to 4 at 8^3; both
//   powers of two, chosen by the wrapper, s2_wgrad_kernel.wgmma_plan).
// * Each segment stages, once, the input x-line segment of each of its
//   output lines (2 sw + 1 voxels x 64 channels, 128-byte rows, zero-filled in
//   the padding, off the volume and past Cin) and the g tile (64 voxels x BN,
//   zero past Wo, the last line and Cout), with cp.async. The three kw taps
//   read the same staged line: tap kw of voxel ow is row 2 ow + kw. So x moves
//   9 x (2 sw + 1) / (2 sw) times its size per 64-channel chunk instead of 27
//   times, and most of that hits L2 (the nine (kd, kh) blocks of one split
//   run together over the same lines).
// * A (M = channels, K = voxels) goes from shared memory to registers with
//   ldmatrix.trans from arbitrary row addresses (the stride-2 row step rules
//   out a descriptor), into wgmma's register-A form; rows are swizzled by XOR
//   of the 16-byte chunk with (row / 2) % 8, so the eight rows 2 ow + kw of an
//   8x8 read hit eight bank groups. B (g, N-contiguous) comes from shared
//   memory through an MN-major 128-byte-swizzle descriptor (transpose bit).
// * Overlap: a STAGES-deep cp.async ring of (x lines, g tile) segments loaded
//   STAGES - 2 ahead, one __syncthreads per segment, one wgmma group in
//   flight (wait_group 1) while the next segment's A fragments load (A
//   registers double-buffered by segment parity); the four k16 steps of a
//   segment are unrolled at compile time.
// * Split-K, deterministic: the wrapper splits the segments into `splits`
//   contiguous ranges so that tiles x splits fill about one wave of the SMs;
//   each split writes its f32 partial tile to its own slice of a (splits, M,
//   N) scratch and the split-K sum of s2_wgrad.cu adds the slices in a
//   fixed order. The deep sites take one or two splits, and narrower N
//   tiles where their few segments cannot fill the card. Splits also bound
//   the rounding: the tensor cores' f32 accumulation loses precision with
//   the length of the sum, so one split over all 262,144 level-0 voxels
//   errs an order of magnitude more than the plan's (PERF.md).
// * Segments are staged strictly in order, so a cursor of (x-block, output
//   line) advanced by carries replaces the per-segment divisions.
//
// Three warpgroups of 128 threads, one block per SM, 157-211 KB of shared
// memory. Measured on an H100 (PERF.md, tools/s2_wgrad_variants.py), the
// staging bounds it, the x lines more than the g tiles: at level 0 the loads
// alone take most of its time, the products and barriers alone about a
// third. Built by nvcc with the other sources (kernels/build.py) and called
// through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90_wgmma.cuh"

// the split-K sum, in a fixed order (s2_wgrad.cu)
cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int CK = 64;                      // input channels per chunk
constexpr int ROW_BYTES = CK * 2;           // one staged row: 64 bf16
constexpr int SEG = 64;                     // output voxels per segment
constexpr int KSTEPS = SEG / 16;            // k16 steps per segment
constexpr int MIN_SW = 4;                   // least voxels per line in a segment
constexpr int XROWS = (SEG / MIN_SW) * (2 * MIN_SW + 1);  // staged rows, most
constexpr int X_BYTES = (XROWS * ROW_BYTES + 1023) / 1024 * 1024;
constexpr int WARPGROUPS = 3;               // one per kw tap
constexpr int THREADS = WARPGROUPS * 128;

struct Args {
  const bf16* x;  // (N, D, H, W, Cin)
  const bf16* g;  // (N, Do, Ho, Wo, Cout)
  float* out;     // (splits, 27 * Cin, Cout) f32, or dw with one split
  int n, d, h, w_, cin;
  int do_, ho, wo, cout;
  int pad_lo;  // output plane od, tap kd reads x plane 2 od + kd - pad_lo
  int n_tiles, chunks, sw_log2, ow_blocks, segments, per_split;
};

template <int BN, int STAGES>
struct Tile {
  static constexpr int N_BLOCKS = (BN + 63) / 64;            // 64-wide B atoms
  static constexpr int N_BLOCK_BYTES = SEG * ROW_BYTES;      // one atom column
  static constexpr int G_BYTES = N_BLOCKS * N_BLOCK_BYTES;
  static constexpr int STAGE_BYTES = X_BYTES + G_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
  static constexpr int G_GROUPS = SEG * BN / 8;              // 16-byte groups
  static constexpr int G_PASSES = (G_GROUPS + THREADS - 1) / THREADS;
  static constexpr int X_PASSES = (XROWS * 8 + THREADS - 1) / THREADS;
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma width");
  static_assert(STAGES >= 3, "one segment in flight at least");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(STAGE_BYTES % 1024 == 0, "B tiles stay 1024-byte aligned");
};

template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1) s2_wgrad_wgmma(const Args a) {
  using Cfg = Tile<BN, STAGES>;
  constexpr int LEAD = STAGES - 2;  // segments loaded ahead of the current one
  constexpr int NACC = BN / 2;
  constexpr int ROWS_PER_PASS = THREADS / 8;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp >> 2, wq = warp & 3;  // warpgroup = kw tap

  // block -> (n tile, chunk, kh, kd), n tile fastest; blockIdx.y = split
  int bid = blockIdx.x;
  const int nt = bid % a.n_tiles; bid /= a.n_tiles;
  const int c = bid % a.chunks; bid /= a.chunks;
  const int kh = bid % 3, kd = bid / 3;
  const int seg0 = blockIdx.y * a.per_split;
  const int steps = min(a.per_split, a.segments - seg0);

  const int sw = 1 << a.sw_log2, lines = SEG >> a.sw_log2;
  const int pitch = 2 * sw + 1;  // staged rows per output line
  const int rows = lines * pitch;
  const int total_lines = a.n * a.do_ * a.ho;

  // x staging: thread -> 16-byte chunk xj of rows tid / 8 + p * ROWS_PER_PASS,
  // each row (line li of the segment, input voxel 2 ow0 - 1 + xq)
  const int xj = tid & 7;
  const int xch = c * CK + xj * 8;
  int xli[Cfg::X_PASSES], xq[Cfg::X_PASSES];
#pragma unroll
  for (int p = 0; p < Cfg::X_PASSES; ++p) {
    const int r = (tid >> 3) + p * ROWS_PER_PASS;
    xli[p] = r < rows ? r / pitch : -1;
    xq[p] = r < rows ? r % pitch : 0;
  }
  // the segment the next load_segment call stages (segments are staged in
  // order, one per call): x-block om of output line l0 = (n, od, oh), kept
  // by carries instead of divisions
  int cur_om, cur_l0, cur_n, cur_od, cur_oh;
  {
    const int lb = seg0 / a.ow_blocks;
    cur_om = seg0 - lb * a.ow_blocks;
    cur_l0 = lb * lines;
    const int t = cur_l0 / a.ho;
    cur_oh = cur_l0 - t * a.ho;
    cur_od = t % a.do_;
    cur_n = t / a.do_;
  }
  // g staging: thread -> 16-byte group jn of segment voxel v, per pass
  constexpr int GPR = BN / 8;  // groups per g row
  auto load_segment = [&](int slot) {
    const int l0 = cur_l0, ow0 = cur_om * sw;
    const uint32_t xbase = smem_u32(smem + slot * Cfg::STAGE_BYTES);
    const uint32_t gbase = xbase + X_BYTES;
#pragma unroll
    for (int p = 0; p < Cfg::X_PASSES; ++p) {
      if (xli[p] < 0) continue;  // past the staged rows: never read
      int oh = cur_oh + xli[p], od = cur_od, nn = cur_n;
      while (oh >= a.ho) {
        oh -= a.ho;
        if (++od == a.do_) { od = 0; ++nn; }
      }
      const int iz = 2 * od + kd - a.pad_lo, iy = 2 * oh + kh - 1, ix = 2 * ow0 - 1 + xq[p];
      const bool ok = xch < a.cin && nn < a.n && iz >= 0 && iz < a.d && iy >= 0 &&
                      iy < a.h && ix >= 0 && ix < a.w_;
      const bf16* src =
          ok ? a.x + (((static_cast<long long>(nn) * a.d + iz) * a.h + iy) * a.w_ + ix) *
                         a.cin + xch
             : a.x;
      const int r = (tid >> 3) + p * ROWS_PER_PASS;
      cp_async16(xbase + r * ROW_BYTES + ((xj ^ ((r >> 1) & 7)) << 4), src, ok);
    }
#pragma unroll
    for (int p = 0; p < Cfg::G_PASSES; ++p) {
      const int i = tid + p * THREADS;
      if (i >= Cfg::G_GROUPS) break;
      const int v = i / GPR, jn = i % GPR;
      const int line = l0 + (v >> a.sw_log2), ow = ow0 + (v & (sw - 1));
      const int co = nt * BN + jn * 8;
      const bool ok = line < total_lines && ow < a.wo && co < a.cout;
      const bf16* src =
          ok ? a.g + (static_cast<long long>(line) * a.wo + ow) * a.cout + co : a.g;
      cp_async16(gbase + (jn >> 3) * Cfg::N_BLOCK_BYTES + v * ROW_BYTES +
                     (((jn & 7) ^ (v & 7)) << 4),
                 src, ok);
    }
    if (++cur_om == a.ow_blocks) {  // on to the next segment
      cur_om = 0;
      cur_l0 += lines;
      cur_oh += lines;
      while (cur_oh >= a.ho) {
        cur_oh -= a.ho;
        if (++cur_od == a.do_) { cur_od = 0; ++cur_n; }
      }
    }
  };

  // this lane's ldmatrix.trans row in each k16 step: matrix j = lane / 8
  // holds voxels 8 (j / 2) .. + 7 (its rows) of channels 8 (j % 2) .. + 7 of
  // the warp's 16; voxel v of tap kw is row (v / sw) * pitch + 2 (v % sw) + kw
  uint32_t aoff[KSTEPS];
  {
    const int chunk = 2 * wq + ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int v = ks * 16 + (lane & 7) + 8 * (lane >> 4);
      const int r = (v >> a.sw_log2) * pitch + 2 * (v & (sw - 1)) + kw;
      aoff[ks] = static_cast<uint32_t>(r * ROW_BYTES + ((chunk ^ ((r >> 1) & 7)) << 4));
    }
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  uint32_t afrag[2][KSTEPS][4];

#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    if (s < steps) load_segment(s);
    cp_async_commit();
  }

  auto step = [&](int s, auto parity) {
    constexpr int P = decltype(parity)::value;
    cp_async_wait<LEAD - 1>();  // this thread's copies of segment s landed
    fence_proxy_async();
    __syncthreads();
    if (s + LEAD < steps) load_segment((s + LEAD) % STAGES);
    cp_async_commit();
    const uint32_t xbase = smem_u32(smem + (s % STAGES) * Cfg::STAGE_BYTES);
    const uint32_t gbase = xbase + X_BYTES;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4_trans(xbase + aoff[ks], afrag[P][ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      Wgmma<BN, 1>::mma(afrag[P][ks],
                        desc_sw128_mn(gbase + ks * 16 * ROW_BYTES, Cfg::N_BLOCK_BYTES), acc);
    wgmma_commit();
    wgmma_wait<1>();  // segment s - 1's products are done with their operands
  };
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, std::integral_constant<int, 0>{});
    step(s + 1, std::integral_constant<int, 1>{});
  }
  if (s < steps) step(s, std::integral_constant<int, 0>{});
  wgmma_wait<0>();
  cp_async_wait<0>();

  // accumulator d[4 i + 2 hi + e] is row wq * 16 + lane / 4 + 8 hi of this
  // warpgroup's tile (channel c * 64 + that row of tap (kd, kh, kw)), column
  // 8 i + 2 (lane % 4) + e of the N tile
  float* const out = a.out + static_cast<long long>(blockIdx.y) * 27 * a.cin * a.cout;
  const int tap = (kd * 3 + kh) * 3 + kw;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int ci = c * CK + wq * 16 + (lane >> 2) + 8 * hi;
    if (ci >= a.cin) continue;
    float* const row = out + (static_cast<long long>(tap) * a.cin + ci) * a.cout;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int co = nt * BN + 8 * i + 2 * (lane & 3);
      if (co < a.cout)
        *reinterpret_cast<float2*>(row + co) =
            make_float2(acc[4 * i + 2 * hi], acc[4 * i + 2 * hi + 1]);
    }
  }
}

template <int BN, int STAGES>
cudaError_t launch(Args a, int splits, float* part, float* dw, cudaStream_t stream) {
  using Cfg = Tile<BN, STAGES>;
  auto kernel = s2_wgrad_wgmma<BN, STAGES>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  if (a.n_tiles != (a.cout + BN - 1) / BN) return cudaErrorInvalidValue;
  const long long tiles = 9LL * a.chunks * a.n_tiles;
  a.out = splits == 1 ? dw : part;
  kernel<<<dim3(static_cast<unsigned>(tiles), splits), THREADS, Cfg::SMEM, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return unet3d_s2_wgrad_sum_splits(part, dw, 27LL * a.cin * a.cout, splits, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// The plan of s2_wgrad_kernel.wgmma_plan: bn, stages (an instantiated pair,
// s2_wgrad_kernel.WGMMA_CONFIGS), n_tiles of bn output channels, chunks of
// 64 input channels, sw output voxels per line in a segment (a power of two
// in [4, 64]), segments in all, splits of per_split segments. x (N, D, H, W,
// Cin), g (N, Do, Ho, Wo, Cout) bf16, 16-byte aligned, Cin and Cout
// multiples of 8; dw (3, 3, 3, Cin, Cout) f32; part an f32 (splits, 27 * Cin,
// Cout) scratch when splits > 1. Returns cudaErrorInvalidValue for a plan
// that does not match the shape or is not instantiated, else the
// cudaError_t of the launches (0 on success). pad_lo is the zero planes
// below x on D: 1 for the SAME conv, 0 for a D slab whose first plane is
// the one below it (the D-halo mode; no high pad is in reach there).
extern "C" int unet3d_s2_wgrad_wgmma(int bn, int stages, const void* x, const void* g,
                                     float* part, float* dw, int n, int d, int h, int w_,
                                     int cin, int do_, int ho, int wo, int cout, int n_tiles,
                                     int chunks, int sw, int segments, int splits,
                                     int per_split, int pad_lo, void* stream) {
  int sw_log2 = 0;
  while ((1 << sw_log2) < sw) ++sw_log2;
  const long long lines = static_cast<long long>(n) * do_ * ho;
  const long long ow_blocks = (wo + sw - 1) / sw;
  if (cin % 8 != 0 || cout % 8 != 0 || !aligned16(x) || !aligned16(g) ||
      pad_lo < 0 || pad_lo > 1 || do_ != (d + pad_lo) / 2 || ho != (h + 1) / 2 ||
      wo != (w_ + 1) / 2 ||
      (1 << sw_log2) != sw || sw < MIN_SW || sw > SEG || chunks != (cin + CK - 1) / CK ||
      segments != (lines + (SEG / sw) - 1) / (SEG / sw) * ow_blocks || splits < 1 ||
      splits > 65535 || per_split < 1 ||
      static_cast<long long>(splits - 1) * per_split >= segments ||
      static_cast<long long>(splits) * per_split < segments || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(g), nullptr, n, d, h, w_,
         cin, do_, ho, wo, cout, pad_lo, n_tiles, chunks, sw_log2,
         static_cast<int>(ow_blocks), segments, per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64 && stages == 6) return launch<64, 6>(a, splits, part, dw, s);
  if (bn == 96 && stages == 6) return launch<96, 6>(a, splits, part, dw, s);
  if (bn == 128 && stages == 6) return launch<128, 6>(a, splits, part, dw, s);
  if (bn == 192 && stages == 5) return launch<192, 5>(a, splits, part, dw, s);
  return cudaErrorInvalidValue;
}
