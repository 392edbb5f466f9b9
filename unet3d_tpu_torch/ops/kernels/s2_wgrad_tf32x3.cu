// Weight gradient of the 3x3x3 stride-2 convolution with symmetric pads of 1
// over NDHWC f32 activations, the Hopper (sm_90a) form in 3xTF32 on wgmma:
//
//   dw[kd, kh, kw, ci, co] = sum_{n, od, oh, ow}
//       xp[n, 2od + kd, 2oh + kh, 2ow + kw, ci] * g[n, od, oh, ow, co]
//
// with xp the input padded by one voxel of zeros on every side (on D, by
// pad_lo below: 0 in the D-halo mode, where x's first plane is the slab's
// neighbour below). Replaces unet3d_tpu/ops/pallas/s2_wgrad_kernel.py:158
// (s2_wgrad_pallas, whose pallas_call is at :177) for every f32 call, any
// Cin and Cout and any alignment of x and g (4 bytes): the stride-2 sites
// of DynUNet's, SegResNetVAE's and every other net's f32 steps.
// s2_wgrad_wgmma.cu (bf16, Cin and Cout multiples of 8) and s2_wgrad.cu
// (bf16, other channel counts) take the bf16 calls.
//
// What bounds it: 2 * 27 * Cin * Cout flops per output voxel. On the CUDA
// cores (67 TFLOP/s of f32) the BraTS level 0 (x 128^3, 64 -> 96) takes
// >= 1.3 ms. TF32 on the tensor cores runs at 495 TFLOP/s but keeps 10
// mantissa bits; the 3xTF32 split keeps f32 accuracy (each operand v =
// hi + lo, both TF32, hi = rna(v), lo = rna(v - hi); the product is
// lo*hi + hi*lo + hi*hi, conv3d_tf32x3.cu's note), three products per
// product: 0.53 ms at level 0. At 16^3 and 8^3 the f32 dw write (5.3 and
// 10.6 MB) is most of the bound.
//
// Design. A GEMM with M = 27 * Cin rows ordered (tap, ci), N = Cout and K =
// the output voxels, after s2_wgrad_wgmma.cu:
// * A block owns the three kw taps of one (kd, kh) pair for one 64-channel
//   chunk of Cin (one warpgroup per tap, 64 rows) and BN output channels
//   (BN = 32, 64 or 96, and 128 where a block walks a single segment; wider
//   Cout in equal tiles), and walks its share of K
//   in segments of 64 output voxels: `lines` output x-lines of `sw` voxels
//   each (sw = 64 at level 0, down to 4 at 8^3; both powers of two, chosen by
//   the wrapper, s2_wgrad_kernel.tf32_plan).
// * Each segment stages, once, the input x-line segment of each of its
//   output lines (2 sw + 1 voxels x 64 channels in rows of 68 floats,
//   zero-filled in the padding, off the volume and past Cin) and the g tile
//   (64 voxels x BN, zero past Wo, the last line and Cout), with cp.async:
//   16 bytes a copy where Cin (Cout) is a multiple of 4 and x (g) is 16-byte
//   aligned, else 4. The three kw taps read the same staged line: tap kw of
//   voxel ow is row 2 ow + kw.
// * Operands. tf32 wgmma reads B from shared memory K-major only (the
//   transpose bit is for 16-bit types), and g is N-contiguous: a pass over
//   the staged g tile writes it transposed, split into its TF32 hi and lo
//   parts, as two K-major 128-byte-swizzled tiles (BN rows of 32 voxels per
//   K block, 16-byte stores), once per segment for all three taps. A (M =
//   channels, K = voxels) goes to registers by 32-bit shared loads in
//   wgmma's register-A form (ldmatrix.trans, which builds the bf16 form's A,
//   moves 16-bit elements only), split into hi and lo there; rows 2 q apart
//   fall 8 banks apart (a 68-float pitch), so the 32 lanes of a load hit 32
//   banks.
// * Products: three wgmma m64nBNk8 tf32 per k8 step (lo*hi, hi*lo, then
//   hi*hi), one group in flight while the next step's A loads and splits
//   (double-buffered registers, wgmma.wait_group 1).
// * Overlap: a 2-deep cp.async ring of (x lines, raw g tile) segments, the
//   next one loading while this one is transposed and multiplied; two
//   barriers per segment (the raw tile landed; the split tiles written).
// * Precision: each segment's products (eight k8 steps, three products
//   each) sum in a partial accumulator that f32 adds fold into the total at
//   the segment's end, so the tensor cores' own accumulation never runs
//   longer than 24 products, whatever the split. A block of one segment
//   (the 8^3 site: K = 64 voxels) needs no total, and the registers it
//   frees hold BN = 128, so its tiles fit one wave of the SMs.
// * Split-K, deterministic: the wrapper splits the segments into `splits`
//   contiguous ranges so that tiles x splits fill about one wave of the SMs;
//   each split writes its f32 partial tile to its own slice of a (splits, M,
//   N) scratch and the split-K sum of s2_wgrad.cu adds the slices in a
//   fixed order.
//
// Three warpgroups of 128 threads, one block per SM, 116-214 KB of shared
// memory. Built by nvcc with the other sources (kernels/build.py) and called
// through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90_wgmma.cuh"

// the split-K sum, in a fixed order (s2_wgrad.cu)
cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream);

namespace {

constexpr int CK = 64;                       // input channels per block
constexpr int XP = CK + 4;                   // staged x row pitch (floats)
constexpr int SEG = 64;                      // output voxels per segment
constexpr int KSTEPS = SEG / 8;              // k8 steps per segment
constexpr int KB = 32;                       // voxels per K block of a B tile (128 bytes)
constexpr int MIN_SW = 4;                    // least voxels per line in a segment
constexpr int XROWS = (SEG / MIN_SW) * (2 * MIN_SW + 1);  // staged rows, most
constexpr int STAGES = 2;
constexpr int LEAD = STAGES - 1;             // segments loaded ahead of the current one
constexpr int WARPGROUPS = 3;                // one per kw tap
constexpr int THREADS = WARPGROUPS * 128;
constexpr int X_ROWS_PER_PASS = THREADS / (CK / 4);  // 16-byte copies: 16 a row
constexpr int X_PASSES = (XROWS + X_ROWS_PER_PASS - 1) / X_ROWS_PER_PASS;

constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

struct Args {
  const float* x;  // (N, D, H, W, Cin)
  const float* g;  // (N, Do, Ho, Wo, Cout)
  float* out;      // (splits, 27 * Cin, Cout) f32, or dw with one split
  int n, d, h, w_, cin;
  int do_, ho, wo, cout;
  int pad_lo;  // output plane od, tap kd reads x plane 2 od + kd - pad_lo
  int n_tiles, chunks, sw_log2, ow_blocks, segments, per_split;
  int vec_x, vec_g;  // 16-byte copies: Cin (Cout) % 4 == 0 and x (g) 16-byte aligned
};

template <int BN>
struct Tile {
  static constexpr int GP = BN + 4;                         // raw g row pitch (floats)
  static constexpr int X_BYTES = align1024(XROWS * XP * 4);
  static constexpr int G_BYTES = align1024(SEG * GP * 4);
  static constexpr int STAGE_BYTES = X_BYTES + G_BYTES;
  static constexpr int B_TILE = BN * 128;                   // one K block of one part
  static constexpr int B_BYTES = 4 * B_TILE;                // (hi, lo) x 2 K blocks
  static constexpr int SMEM = STAGES * STAGE_BYTES + B_BYTES + 1024;
  static constexpr int NACC = BN / 2;
  static constexpr bool PROMOTE = BN <= 96;  // BN = 128: one segment, no total
  static_assert(BN % 32 == 0 && BN <= 128, "wgmma N, and registers for the accumulators");
  static_assert(B_TILE % 1024 == 0, "B tiles stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// byte offset of 16-byte chunk j (4 voxels) of row r of a K-major B tile in
// the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) s2_wgrad_tf32x3(const Args a) {
  using Cfg = Tile<BN>;
  constexpr int GP = Cfg::GP, NACC = Cfg::NACC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const btiles = smem + STAGES * Cfg::STAGE_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp >> 2, wq = warp & 3;  // warpgroup = kw tap; warp = 16 rows of it
  const int q = lane & 3, r0 = lane >> 2;

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

  // 16-byte x staging: thread -> chunk xj of rows tid / 16 + p * X_ROWS_PER_PASS,
  // each row (line li of the segment, input voxel 2 ow0 - 1 + xq)
  const int xj = tid & 15;
  int xli[X_PASSES], xq[X_PASSES];
#pragma unroll
  for (int p = 0; p < X_PASSES; ++p) {
    const int r = (tid >> 4) + p * X_ROWS_PER_PASS;
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
  // line li of the current segment, input voxel 2 ow0 - 1 + xq -> its first
  // channel of this chunk in x, or nullptr in the padding
  auto x_row = [&](int li, int xqq) -> const float* {
    int oh = cur_oh + li, od = cur_od, nn = cur_n;
    while (oh >= a.ho) {
      oh -= a.ho;
      if (++od == a.do_) { od = 0; ++nn; }
    }
    const int iz = 2 * od + kd - a.pad_lo, iy = 2 * oh + kh - 1,
              ix = 2 * cur_om * sw - 1 + xqq;
    if (nn >= a.n || iz < 0 || iz >= a.d || iy < 0 || iy >= a.h || ix < 0 || ix >= a.w_)
      return nullptr;
    return a.x + (((static_cast<long long>(nn) * a.d + iz) * a.h + iy) * a.w_ + ix) * a.cin +
           c * CK;
  };
  // g row v of the current segment -> its first channel of this N tile, or nullptr
  auto g_row = [&](int v) -> const float* {
    const int line = cur_l0 + (v >> a.sw_log2), ow = cur_om * sw + (v & (sw - 1));
    if (line >= total_lines || ow >= a.wo) return nullptr;
    return a.g + (static_cast<long long>(line) * a.wo + ow) * a.cout + nt * BN;
  };
  const int ch_left = a.cin - c * CK, co_left = a.cout - nt * BN;  // valid channels
  auto load_segment = [&](int slot) {
    const uint32_t xbase = smem_u32(smem + slot * Cfg::STAGE_BYTES);
    const uint32_t gbase = xbase + Cfg::X_BYTES;
    if (a.vec_x) {
#pragma unroll
      for (int p = 0; p < X_PASSES; ++p) {
        if (xli[p] < 0) continue;  // past the staged rows: never read
        const float* src = x_row(xli[p], xq[p]);
        const bool ok = src != nullptr && 4 * xj < ch_left;
        const int r = (tid >> 4) + p * X_ROWS_PER_PASS;
        cp_async16(xbase + (r * XP + 4 * xj) * 4, ok ? src + 4 * xj : a.x, ok);
      }
    } else {  // any Cin and alignment: 64 copies of 4 bytes a row
      for (int i = tid; i < rows * CK; i += THREADS) {
        const int r = i / CK, j = i % CK, li = r / pitch;
        const float* src = x_row(li, r - li * pitch);
        const bool ok = src != nullptr && j < ch_left;
        cp_async4(xbase + (r * XP + j) * 4, ok ? src + j : a.x, ok);
      }
    }
    if (a.vec_g) {
      for (int i = tid; i < SEG * (BN / 4); i += THREADS) {
        const int v = i / (BN / 4), j = i % (BN / 4);
        const float* src = g_row(v);
        const bool ok = src != nullptr && 4 * j < co_left;
        cp_async16(gbase + (v * GP + 4 * j) * 4, ok ? src + 4 * j : a.g, ok);
      }
    } else {
      for (int i = tid; i < SEG * BN; i += THREADS) {
        const int v = i / BN, j = i % BN;
        const float* src = g_row(v);
        const bool ok = src != nullptr && j < co_left;
        cp_async4(gbase + (v * GP + j) * 4, ok ? src + j : a.g, ok);
      }
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
  // the staged g tile of `slot`, transposed and split: element (voxel v,
  // channel co) to row co of K block v / 32 of the hi and the lo tile; a
  // thread takes 4 voxels of one channel (one 16-byte store per part)
  auto split_g = [&](int slot) {
    const float* const graw =
        reinterpret_cast<const float*>(smem + slot * Cfg::STAGE_BYTES + Cfg::X_BYTES);
    for (int i = tid; i < (SEG / 4) * BN; i += THREADS) {
      const int co = i % BN, v4 = i / BN;
      uint4 hi, lo;
      uint32_t* const h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* const l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(graw[(4 * v4 + e) * GP + co], h[e], l[e]);
      const uint32_t off = (v4 / (KB / 4)) * Cfg::B_TILE + swz(co, v4 % (KB / 4));
      *reinterpret_cast<uint4*>(btiles + off) = hi;
      *reinterpret_cast<uint4*>(btiles + 2 * Cfg::B_TILE + off) = lo;
    }
  };

  // this lane's A rows: channel wq * 16 + r0 (+ 8) of voxel v = 8 ks + q (and
  // v + 4) of tap kw, staged row (v / sw) * pitch + 2 (v % sw) + kw
  int arow[KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = 8 * ks + q + 4 * hh;
      arow[ks][hh] = ((v >> a.sw_log2) * pitch + 2 * (v & (sw - 1)) + kw) * XP + wq * 16 + r0;
    }

  float total[Cfg::PROMOTE ? NACC : 1], part[NACC];
#pragma unroll
  for (int i = 0; i < (Cfg::PROMOTE ? NACC : 1); ++i) total[i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];  // the TF32 parts of A, double-buffered across k8 steps
  const uint32_t bhi = smem_u32(btiles), blo = bhi + 2 * Cfg::B_TILE;

  if (steps > 0) load_segment(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<LEAD - 1>();  // this thread's copies of segment s landed
    __syncthreads();            // everyone's; segment s - 1's products are done
    if (s + LEAD < steps) load_segment((s + LEAD) % STAGES);
    cp_async_commit();
    split_g(s % STAGES);
    fence_proxy_async();  // the split tiles, written here, are read by wgmma
    __syncthreads();
    const float* const xs = reinterpret_cast<const float*>(smem + (s % STAGES) * Cfg::STAGE_BYTES);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int p = ks & 1;
      const float v[4] = {xs[arow[ks][0]], xs[arow[ks][0] + 8], xs[arow[ks][1]],
                          xs[arow[ks][1] + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(v[e], ahi[p][e], alo[p][e]);
      wgmma_fence();
      const uint32_t koff = (ks / 4) * Cfg::B_TILE + (ks % 4) * 32;
      const uint64_t dhi = desc_sw128(bhi + koff), dlo = desc_sw128(blo + koff);
      WgmmaTf32<BN>::mma(alo[p], dhi, part, ks == 0 ? 0 : 1);  // a segment starts part anew
      WgmmaTf32<BN>::mma(ahi[p], dlo, part);
      WgmmaTf32<BN>::mma(ahi[p], dhi, part);
      wgmma_commit();
      // the previous k8 step's products are done with their operands; at the
      // segment's end, all of them
      if (ks + 1 == KSTEPS)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
    }
    if constexpr (Cfg::PROMOTE) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) total[i] += part[i];  // the segment's sum into the total
    }
  }
  auto sum = [&](int i) {
    if constexpr (Cfg::PROMOTE) return total[i];
    else return part[i];
  };
  cp_async_wait<0>();

  // sum(4 i + 2 hh + e) is channel c * 64 + wq * 16 + r0 + 8 hh of tap
  // (kd, kh, kw), output channel nt * BN + 8 i + 2 q + e
  float* const out = a.out + static_cast<long long>(blockIdx.y) * 27 * a.cin * a.cout;
  const int tap = (kd * 3 + kh) * 3 + kw;
  const bool even = (a.cout & 1) == 0;  // out is the wrapper's, 8-byte aligned
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ci = c * CK + wq * 16 + r0 + 8 * hh;
    if (ci >= a.cin) continue;
    float* const row = out + (static_cast<long long>(tap) * a.cin + ci) * a.cout;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int co = nt * BN + 8 * i + 2 * q;
      const float v0 = sum(4 * i + 2 * hh), v1 = sum(4 * i + 2 * hh + 1);
      if (even && co < a.cout) {
        *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
      } else {
        if (co < a.cout) row[co] = v0;
        if (co + 1 < a.cout) row[co + 1] = v1;
      }
    }
  }
}

template <int BN>
cudaError_t launch(Args a, int splits, float* part, float* dw, cudaStream_t stream) {
  using Cfg = Tile<BN>;
  auto kernel = s2_wgrad_tf32x3<BN>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  if (a.n_tiles != (a.cout + BN - 1) / BN || (!Cfg::PROMOTE && a.per_split != 1))
    return cudaErrorInvalidValue;
  const long long tiles = 9LL * a.chunks * a.n_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  a.out = splits == 1 ? dw : part;
  kernel<<<dim3(static_cast<unsigned>(tiles), splits), THREADS, Cfg::SMEM, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return unet3d_s2_wgrad_sum_splits(part, dw, 27LL * a.cin * a.cout, splits, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The plan of s2_wgrad_kernel.tf32_plan: bn (32, 64 or 96,
// s2_wgrad_kernel.TF32_CONFIGS; 128 with one segment a split), n_tiles of
// bn output channels, chunks of
// 64 input channels, sw output voxels per line in a segment (a power of two
// in [4, 64]), segments in all, splits of per_split segments. x (N, D, H, W,
// Cin), g (N, Do, Ho, Wo, Cout) f32, 4-byte aligned, any Cin and Cout; dw
// (3, 3, 3, Cin, Cout) f32, 8-byte aligned; part an f32 (splits, 27 * Cin,
// Cout) scratch when splits > 1. Returns cudaErrorInvalidValue for a plan
// that does not match the shape or is not instantiated, else the cudaError_t
// of the launches (0 on success). pad_lo is the zero planes below x on D: 1
// for the SAME conv, 0 for a D slab whose first plane is the one below it
// (the D-halo mode; no high pad is in reach there).
extern "C" int unet3d_s2_wgrad_tf32x3(int bn, const void* x, const void* g, float* part,
                                      float* dw, int n, int d, int h, int w_, int cin, int do_,
                                      int ho, int wo, int cout, int n_tiles, int chunks, int sw,
                                      int segments, int splits, int per_split, int pad_lo,
                                      void* stream) {
  int sw_log2 = 0;
  while ((1 << sw_log2) < sw) ++sw_log2;
  const long long lines = static_cast<long long>(n) * do_ * ho;
  const long long ow_blocks = (wo + sw - 1) / sw;
  if (cin < 1 || cout < 1 || !aligned(x, 4) || !aligned(g, 4) || !aligned(dw, 8) ||
      (part && !aligned(part, 8)) || pad_lo < 0 || pad_lo > 1 || do_ != (d + pad_lo) / 2 ||
      ho != (h + 1) / 2 || wo != (w_ + 1) / 2 || (1 << sw_log2) != sw || sw < MIN_SW ||
      sw > SEG || chunks != (cin + CK - 1) / CK ||
      segments != (lines + (SEG / sw) - 1) / (SEG / sw) * ow_blocks || splits < 1 ||
      splits > 65535 || per_split < 1 ||
      static_cast<long long>(splits - 1) * per_split >= segments ||
      static_cast<long long>(splits) * per_split < segments || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x), static_cast<const float*>(g), nullptr, n, d, h, w_,
         cin, do_, ho, wo, cout, pad_lo, n_tiles, chunks, sw_log2,
         static_cast<int>(ow_blocks), segments, per_split,
         cin % 4 == 0 && aligned(x, 16), cout % 4 == 0 && aligned(g, 16)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch<32>(a, splits, part, dw, s);
    case 64: return launch<64>(a, splits, part, dw, s);
    case 96: return launch<96>(a, splits, part, dw, s);
    case 128: return launch<128>(a, splits, part, dw, s);
    default: return cudaErrorInvalidValue;
  }
}
