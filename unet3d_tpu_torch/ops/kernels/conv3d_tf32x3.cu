// 3x3x3 stride-1 SAME convolution over NDHWC f32 activations, the Hopper
// (sm_90a) form: brick-staged implicit GEMM on the tensor cores in 3xTF32.
// It computes the three variants of conv3d_narrow.cu (conv, conv_stats,
// block_stats; what each replaces is in that file's note) for every f32 call
// whose Cin is a multiple of 4 (16-byte rows) and whose x is 16-byte aligned,
// any Cout: every f32 site of the DynUNet and of the Myronenko family's
// decoder, which AMP runs in f32. conv3d_narrow.cu's f32 form takes the f32
// calls with another Cin or alignment.
//
// What bounds it: 2 * 27 * Cin * Cout flops per voxel. On the CUDA cores
// (67 TFLOP/s in f32) SegResNetVAE's three decoder sites take >= 6.06 ms a
// 128^3 window even at the peak. The tensor cores run TF32 at 495 TFLOP/s,
// but TF32 keeps 10 mantissa bits, about 3 decimal digits. The 3xTF32 split
// keeps f32 accuracy: each f32 operand v is a TF32 high part hi = rna(v) plus
// a TF32 low part lo = rna(v - hi) (|v - hi - lo| <= 2^-22 |v|), and the
// product is hi*hi + hi*lo + lo*hi accumulated in f32 (the lo*lo term is
// below 2^-22 of it). Three products per k8 step: 165 TFLOP/s of f32-exact
// work, which is the bound this form is held to.
//
// Design (from conv3d_wgmma.cu, the bf16 form):
// * M tile = a BZ x BY x BX brick of output voxels inside one batch item
//   (256 = 4x4x16 rows, two M tiles of 64 per warpgroup, for BN <= 64; 128 =
//   2x4x16 above); bricks at the volume's edges are masked. N tile = BN
//   output channels: Cout rounded up to a configured width up to 128, else
//   tiles of up to 128 (an f32 B tile takes twice a bf16 one's bytes, and
//   twice again for hi and lo). The wrapper picks one of CONFIGS per call
//   (conv3d_kernel.tf32_plan).
// * K runs as (32-channel chunk, tap). For each chunk the brick plus its
//   one-voxel halo ((BZ+2) x (BY+2) x (BX+2) rows of 32 f32 channels, 128
//   bytes) is staged once in shared memory with cp.async, zero-filled outside
//   the volume and past Cin, and all 27 taps read it: tap (dz, dy, dx)'s A
//   tile is the brick's rows shifted by that offset. Rows are swizzled by XOR
//   of the 16-byte chunk with (row & 7), so the eight row reads of one
//   ldmatrix hit eight distinct bank groups.
// * A goes from shared memory to registers with ldmatrix: an 8x8 b16 matrix
//   is an 8x4 f32 one, and lane t receives row t / 4, column t % 4, which is
//   the tf32 wgmma A fragment. Each value is split there into hi and lo with
//   cvt.rna.tf32.f32. B comes from shared memory through 128-byte-swizzled
//   K-major descriptors, as tf32 wgmma requires: the wrapper packs the weight
//   per call (conv3d_kernel.pack_tf32) into (n tile, chunk, tap, {hi, lo},
//   BN, 32) tiles, split with the same rounding and zero-padded, so each
//   step's B is one contiguous 2 x BN x 128-byte block.
// * Each k8 step issues wgmma m64nBNk8 three times per M tile into one
//   partial accumulator: lo*hi and hi*lo first, then hi*hi. Each k8 step's
//   products are one wgmma group that stays in flight while the next step's
//   A loads and splits (double-buffered registers, wgmma.wait_group 1).
//   Every two taps the partial sum is added into the f32 accumulator with
//   f32 adds and started anew: the tensor cores' own adds drift from f32 in
//   proportion to K, past 1e-5 of y beyond 64 input channels.
// * Overlap: B tiles run through a STAGES-deep cp.async ring (STAGES - 2
//   ahead); with two halo buffers the next chunk's halo loads while this
//   chunk's taps run. Where Cin fits one chunk, one halo buffer frees room
//   for a second block per SM (BN = 32).
// * PROLOGUE (block_stats): every staged element is replaced in shared
//   memory by lrelu(x * inv[n, c] + shift[n, c]) in f32; voxels outside the
//   volume stay zero (SAME padding pads the activation: lrelu(shift) != 0).
//   Once per element, not per tap.
// * D-halo mode (the space axis of unet3d_tpu_torch/parallel/): x holds
//   d_in planes, a slab of the volume with up to one neighbour plane on each
//   side, and the output d planes; output plane z's tap kd reads x plane
//   z + kd - pad_lo, staged as zero outside [0, d_in): the SAME conv's
//   bound check (d_in = d, pad_lo = 1) with an offset. A neighbour plane is
//   staged, and activated by the prologue, like any other; a missing one
//   (the volume's edge) is padding. The statistics sum the d output planes.
// * Epilogue: f32 accumulators, no rounding (y is f32); STATS sums y per
//   channel in registers and warp shuffles, then one atomicAdd per (item,
//   channel) per block into the caller-zeroed (N, 2, Cout) f32 buffer (the
//   add order changes run to run). y goes out through shared memory as
//   16-byte stores (4-byte ones where Cout is no multiple of 4).
//
// Two warpgroups of 128 threads; 106-227 KB of shared memory, one or two
// blocks per SM. Built by nvcc with the other sources (kernels/build.py) and
// called through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "sm90_wgmma.cuh"

namespace {

constexpr int CK = 32;             // input channels per staged chunk
constexpr int ROW_BYTES = CK * 4;  // one staged row: 32 f32
constexpr int TAPS = 27;
constexpr int WARPGROUPS = 2;
constexpr int THREADS = WARPGROUPS * 128;

struct Args {
  const float* x;       // (N, D, H, W, Cin)
  const float* w;       // packed (n_tiles, chunks, 27, 2, BN, 32)
  float* y;             // (N, D, H, W, Cout)
  const float* inv;     // (N, Cin), PROLOGUE only
  const float* shift;   // (N, Cin), PROLOGUE only
  float* stats;         // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;  // d: the output's depth
  int d_in, pad_lo;  // x's depth; output plane z, tap kd reads x plane z + kd - pad_lo
  int bricks_z, bricks_y, bricks_x, n_tiles, chunks;
  float alpha;
};

// byte offset of 16-byte chunk j of staged row r (swizzled)
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * ROW_BYTES + ((j ^ (r & 7)) << 4));
}

constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS>
struct Tile {
  static constexpr int BM = BZ * BY * BX;
  static constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;
  static constexpr int HALO_ROWS = HZ * HY * HX;
  static constexpr int HALO_BYTES = align1024(HALO_ROWS * ROW_BYTES);
  static constexpr int B_BYTES = 2 * BN * ROW_BYTES;  // the hi tile, then the lo tile
  static constexpr int C_PITCH = BN * 4 + 32;  // staged f32 output row, bytes
  static constexpr int SMEM = HALOS * HALO_BYTES + STAGES * B_BYTES + 1024;
  static_assert(BM == WARPGROUPS * MT * 64, "each warpgroup owns MT 64-row tiles");
  static_assert(BX % 8 == 0, "an 8-row ldmatrix read stays on one x-line");
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma N");
  static_assert(BM * C_PITCH <= HALOS * HALO_BYTES, "C tile fits the halo buffers");
  static_assert(HALOS == 1 || HALOS == 2, "one halo buffer, or two for a chunk ahead");
  static_assert(2 * 8 * BN * 4 <= STAGES * B_BYTES, "statistics fit the B ring");
  static_assert(STAGES >= 3, "one B tile in flight at least");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// an A fragment of f32 bits as its TF32 high and low parts
__device__ __forceinline__ void split(const uint32_t (&v)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float f = __uint_as_float(v[e]);
    hi[e] = tf32_rna(f);
    lo[e] = tf32_rna(f - __uint_as_float(hi[e]));
  }
}

// KSTEPS: the k8 steps per tap, 4 (32 channels) or 1 (Cin <= 8)
template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS, int MIN_BLOCKS,
          int KSTEPS, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) conv3x3x3_tf32x3(const Args a) {
  using Cfg = Tile<BZ, BY, BX, BN, MT, STAGES, HALOS>;
  // an SM holds 233472 bytes of shared memory, 1024 of them reserved per block
  static_assert(MIN_BLOCKS * (Cfg::SMEM + 1024) <= 233472, "blocks per SM");
  constexpr int HX = Cfg::HX, HY = Cfg::HY, HALO_ROWS = Cfg::HALO_ROWS;
  constexpr int LEAD = STAGES - 2;  // B tiles loaded ahead of the current step
  constexpr int NACC = BN / 2;
  constexpr int B_GROUPS = 2 * BN * 8;  // 16-byte groups of one step's B

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const halo0 = smem;
  uint8_t* const ring = smem + HALOS * Cfg::HALO_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;

  // block -> (n tile, brick x, brick y, brick z, item), n tile fastest so
  // the tiles of one brick find its input in L2
  int bid = blockIdx.x;
  const int nt = bid % a.n_tiles; bid /= a.n_tiles;
  const int x0 = (bid % a.bricks_x) * BX; bid /= a.bricks_x;
  const int y0 = (bid % a.bricks_y) * BY; bid /= a.bricks_y;
  const int z0 = (bid % a.bricks_z) * BZ;
  const int item = bid / a.bricks_z;

  // staging: thread -> 16-byte chunk j (4 channels) of every (THREADS / 8)-th
  // halo row
  const int sj = tid & 7;
  // the halo lies inside the volume (no padding rows)
  const bool interior = z0 >= a.pad_lo && y0 >= 1 && x0 >= 1 &&
                        z0 + BZ + 1 - a.pad_lo < a.d_in &&
                        y0 + BY < a.h && x0 + BX < a.w_;
  auto halo_voxel = [&](int hr, int& zz, int& yy, int& xx) {
    xx = x0 + hr % HX - 1;
    yy = y0 + (hr / HX) % HY - 1;
    zz = z0 + hr / (HX * HY) - a.pad_lo;  // a plane of x
    return zz >= 0 && zz < a.d_in && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w_;
  };
  auto load_halo = [&](int c, uint8_t* buf) {
    const int ch = c * CK + sj * 4;
    const uint32_t base = smem_u32(buf);
    for (int hr = tid >> 3; hr < HALO_ROWS; hr += THREADS / 8) {
      int zz, yy, xx;
      const bool ok = halo_voxel(hr, zz, yy, xx) && ch < a.cin;
      const float* src =
          ok ? a.x + (((static_cast<long long>(item) * a.d_in + zz) * a.h + yy) * a.w_ + xx) *
                             a.cin + ch
             : a.x;
      cp_async16(base + swz(hr, sj), src, ok);
    }
  };
  const float* const wtiles =
      a.w + static_cast<long long>(nt) * a.chunks * TAPS * 2 * BN * CK;
  auto load_b = [&](int s) {  // step s = chunk * 27 + tap, in packed order
    const float* src = wtiles + static_cast<long long>(s) * 2 * BN * CK;
    const uint32_t base = smem_u32(ring + (s % STAGES) * Cfg::B_BYTES);
#pragma unroll
    for (int k = 0; k < (B_GROUPS + THREADS - 1) / THREADS; ++k) {
      const int i = tid + k * THREADS;  // 16-byte group i: row i / 8, chunk i % 8
      if (B_GROUPS % THREADS == 0 || i < B_GROUPS)
        cp_async16(base + swz(i >> 3, i & 7), src + i * 4, true);
    }
  };
  // block_stats: z = lrelu(x * inv + shift) in place, once per staged
  // element; a thread transforms the rows it staged itself, so its own
  // cp.async wait suffices
  auto activate = [&](int c, uint8_t* buf) {
    const int ch = c * CK + sj * 4;
    if (ch >= a.cin) return;  // zero-filled channels meet zero weights
    float sc[4], sh[4];       // Cin % 4 == 0: the group lies inside Cin
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = a.inv[item * a.cin + ch + e];
      sh[e] = a.shift[item * a.cin + ch + e];
    }
#pragma unroll 4
    for (int hr = tid >> 3; hr < HALO_ROWS; hr += THREADS / 8) {
      int zz, yy, xx;
      if (!interior && !halo_voxel(hr, zz, yy, xx)) continue;  // padding stays zero
      float4* p = reinterpret_cast<float4*>(buf + swz(hr, sj));
      float4 v = *p;
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = fmaf(f[e], sc[e], sh[e]);
        f[e] = z >= 0.f ? z : z * a.alpha;
      }
      *p = v;
    }
  };

  // this lane's ldmatrix row in each of its M tiles, as a halo row at tap 0
  int hrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = (wg * MT + mt) * 64 + wq * 16 + (lane & 15);
    hrow[mt] = ((r / (BX * BY)) * HY + (r / BX) % BY) * HX + r % BX;
  }
  const int khalf = lane >> 4;

  // part: a pair of steps' products, summed by the tensor cores, whose adds
  // are not round-to-nearest: summed by them over all of K, y drifts from
  // the f32 conv in proportion to K (relative 1.2e-5 at K = 27 * 64, 7e-5 at
  // 27 * 384). acc: the pairs' parts in f32 adds, which keeps y within
  // 4.3e-6 up to 27 * 384 at 2.4% of the time at 32 -> 32 @128^3
  // (tools/tf32x3_variants.py, on the H100)
  float acc[MT][NACC], part[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.f;
  // the TF32 parts of A, double-buffered across k8 steps
  uint32_t ahi[2][MT][4], alo[2][MT][4];

  const int steps = a.chunks * TAPS;
  load_halo(0, halo0);
#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    load_b(s);
    cp_async_commit();
  }

  // parity: the step's place in its pair (the first starts part anew);
  // fold: add part into acc after it
  auto step = [&](int s, auto parity, auto fold) {
    constexpr int PARITY = decltype(parity)::value;
    constexpr bool FOLD = decltype(fold)::value;
    cp_async_wait<LEAD - 1>();  // this thread's copies of step s landed
    if (PROLOGUE && s == 0) activate(0, halo0);
    fence_proxy_async();
    __syncthreads();
    const int c = s / TAPS, tap = s - c * TAPS;
    uint8_t* const hb = halo0 + (HALOS == 2 ? (c & 1) * Cfg::HALO_BYTES : 0);
    if (s + LEAD < steps) load_b(s + LEAD);
    if (HALOS == 2 && tap == 0 && c + 1 < a.chunks)
      load_halo(c + 1, halo0 + ((c + 1) & 1) * Cfg::HALO_BYTES);
    cp_async_commit();

    const int toff = ((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
    const uint32_t hbase = smem_u32(hb);
    const uint32_t bhi = smem_u32(ring + (s % STAGES) * Cfg::B_BYTES);
    const uint32_t blo = bhi + BN * ROW_BYTES;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int p = (PARITY * KSTEPS + ks) & 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t raw[4];
        ldmatrix_x4(hbase + swz(hrow[mt] + toff, ks * 2 + khalf), raw);
        split(raw, ahi[p][mt], alo[p][mt]);
      }
      wgmma_fence();
      const uint64_t dhi = desc_sw128(bhi + ks * 32), dlo = desc_sw128(blo + ks * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)  // a pair's first product starts part anew
        WgmmaTf32<BN>::mma(alo[p][mt], dhi, part[mt], PARITY == 0 && ks == 0 ? 0 : 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) WgmmaTf32<BN>::mma(ahi[p][mt], dlo, part[mt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) WgmmaTf32<BN>::mma(ahi[p][mt], dhi, part[mt]);
      wgmma_commit();
      // the next chunk's halo landed with step s - LEAD's copies (issued at
      // tap 0): transform it while these products run
      if (PROLOGUE && HALOS == 2 && ks == 0 && tap == LEAD && c + 1 < a.chunks)
        activate(c + 1, halo0 + ((c + 1) & 1) * Cfg::HALO_BYTES);
      // the previous k8 step's products are done with their operands; before
      // a fold, all of them
      if (FOLD && ks + 1 == KSTEPS)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
    }
    if constexpr (FOLD) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[mt][i] += part[mt][i];
    }
  };
  using First = std::integral_constant<int, 0>;
  using Second = std::integral_constant<int, 1>;
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, First{}, std::false_type{});
    step(s + 1, Second{}, std::true_type{});
  }
  if (s < steps) step(s, First{}, std::true_type{});
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();

  // epilogue. Accumulator d[4 * i + 2 * hi + e] of M tile mt is row
  // (wg * MT + mt) * 64 + wq * 16 + lane / 4 + 8 * hi, column 8 * i +
  // 2 * (lane % 4) + e.
  auto voxel_of = [&](int r, long long& v) {
    const int zz = z0 + r / (BX * BY), yy = y0 + (r / BX) % BY, xx = x0 + r % BX;
    v = ((static_cast<long long>(item) * a.d + zz) * a.h + yy) * a.w_ + xx;
    return zz < a.d && yy < a.h && xx < a.w_;
  };
  bool row_ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      long long vx;
      row_ok[mt][hi] =
          voxel_of((wg * MT + mt) * 64 + wq * 16 + (lane >> 2) + 8 * hi, vx);
    }
  uint8_t* const ctile = smem;  // the halo buffers, now free
  float* const red = reinterpret_cast<float*>(ring);  // [2][8 warps][BN]
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = (wg * MT + mt) * 64 + wq * 16 + (lane >> 2) + 8 * hi;
        const float2 v = make_float2(acc[mt][4 * i + 2 * hi], acc[mt][4 * i + 2 * hi + 1]);
        *reinterpret_cast<float2*>(ctile + r * Cfg::C_PITCH +
                                   (8 * i + 2 * (lane & 3)) * 4) = v;
        if constexpr (STATS) {
          if (row_ok[mt][hi]) {
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

  if (a.cout % 4 == 0) {
    // y: consecutive threads store consecutive 16-byte groups of channels
    constexpr int GROUPS = BN / 4;
    for (int i = tid; i < Cfg::BM * GROUPS; i += THREADS) {
      const int r = i / GROUPS, q = i % GROUPS;
      const int co = nt * BN + q * 4;
      long long vx;
      if (voxel_of(r, vx) && co < a.cout)
        *reinterpret_cast<uint4*>(a.y + vx * a.cout + co) =
            *reinterpret_cast<const uint4*>(ctile + r * Cfg::C_PITCH + q * 16);
    }
  } else {  // rows of Cout f32 are not 16-byte aligned
    for (int i = tid; i < Cfg::BM * BN; i += THREADS) {
      const int r = i / BN, q = i % BN;
      const int co = nt * BN + q;
      long long vx;
      if (voxel_of(r, vx) && co < a.cout)
        a.y[vx * a.cout + co] = *reinterpret_cast<const float*>(ctile + r * Cfg::C_PITCH + q * 4);
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

template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS, int MIN_BLOCKS,
          int KSTEPS, bool PROLOGUE, bool STATS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Cfg = Tile<BZ, BY, BX, BN, MT, STAGES, HALOS>;
  auto kernel = conv3x3x3_tf32x3<BZ, BY, BX, BN, MT, STAGES, HALOS, MIN_BLOCKS, KSTEPS,
                                 PROLOGUE, STATS>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  if (a.bricks_z != (a.d + BZ - 1) / BZ || a.bricks_y != (a.h + BY - 1) / BY ||
      a.bricks_x != (a.w_ + BX - 1) / BX || a.n_tiles != (a.cout + BN - 1) / BN ||
      a.chunks != (a.cin + CK - 1) / CK || (HALOS == 1 && a.chunks != 1) ||
      (KSTEPS == 1 && a.cin > 8))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(a.n) * a.bricks_z * a.bricks_y *
                           a.bricks_x * a.n_tiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS, int MIN_BLOCKS,
          int KSTEPS = 4>
cudaError_t dispatch(int variant, const Args& a, cudaStream_t stream) {
  switch (variant) {
    case 0:
      return launch<BZ, BY, BX, BN, MT, STAGES, HALOS, MIN_BLOCKS, KSTEPS, false, false>(
          a, stream);
    case 1:
      return launch<BZ, BY, BX, BN, MT, STAGES, HALOS, MIN_BLOCKS, KSTEPS, false, true>(
          a, stream);
    case 2:
      return launch<BZ, BY, BX, BN, MT, STAGES, HALOS, MIN_BLOCKS, KSTEPS, true, true>(
          a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the tile configurations, by index: brick z, y, x; BN; M tiles of 64 rows
// per warpgroup; B stages; halo buffers (2: the next chunk's loads while
// this one's taps run; 1: Cin <= 32 only); blocks per SM the registers are
// bounded for. ops/conv3d_kernel.py (TF32_CONFIGS) picks one per call and
// checks this table against its own when the library loads.
constexpr int CONFIGS[][8] = {
    {4, 4, 16, 8, 2, 4, 2, 1},
    {4, 4, 16, 16, 2, 4, 2, 1},
    {4, 4, 16, 32, 2, 4, 2, 1},
    {4, 4, 16, 64, 2, 4, 2, 1},
    {2, 4, 16, 96, 1, 4, 2, 1},
    {2, 4, 16, 128, 1, 3, 2, 1},
    {2, 4, 16, 32, 1, 4, 1, 2},
    {4, 4, 16, 64, 2, 3, 1, 1},
};
constexpr int N_CONFIGS = sizeof(CONFIGS) / sizeof(CONFIGS[0]);

}  // namespace

// variant: 0 = conv, 1 = conv_stats, 2 = block_stats; config: an index of
// CONFIGS. w is the packed weight (n_tiles, chunks, 27, 2, BN, 32); x, w and y
// 16-byte aligned, Cin a multiple of 4. Returns the cudaError_t of the launch
// (0 on success). d is the output's depth and d_in x's (D-halo mode: output
// plane z, tap kd reads x plane z + kd - pad_lo, zero outside [0, d_in); the
// SAME conv is d_in = d, pad_lo = 1).
extern "C" int unet3d_conv3x3x3_tf32x3(int variant, int config, const void* x,
                                       const void* w, void* y, const float* inv,
                                       const float* shift, float* stats, int n,
                                       int d, int h, int w_, int cin, int cout,
                                       int d_in, int pad_lo, int bricks_z, int bricks_y,
                                       int bricks_x, int n_tiles, int chunks, float alpha,
                                       void* stream) {
  if (cin % 4 != 0 || d_in < 1 || pad_lo < 0 || pad_lo > 2)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x), static_cast<const float*>(w),
         static_cast<float*>(y), inv, shift, stats, n, d, h, w_, cin, cout,
         d_in, pad_lo, bricks_z, bricks_y, bricks_x, n_tiles, chunks, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return dispatch<4, 4, 16, 8, 2, 4, 2, 1>(variant, a, s);
    case 1: return dispatch<4, 4, 16, 16, 2, 4, 2, 1>(variant, a, s);
    case 2: return dispatch<4, 4, 16, 32, 2, 4, 2, 1>(variant, a, s);
    case 3: return dispatch<4, 4, 16, 64, 2, 4, 2, 1>(variant, a, s);
    case 4: return dispatch<2, 4, 16, 96, 1, 4, 2, 1>(variant, a, s);
    case 5: return dispatch<2, 4, 16, 128, 1, 3, 2, 1>(variant, a, s);
    case 6:  // a 4-channel input conv runs one k8 step per tap
      return cin <= 8 ? dispatch<2, 4, 16, 32, 1, 4, 1, 2, 1>(variant, a, s)
                      : dispatch<2, 4, 16, 32, 1, 4, 1, 2>(variant, a, s);
    case 7:
      return cin <= 8 ? dispatch<4, 4, 16, 64, 2, 3, 1, 1, 1>(variant, a, s)
                      : dispatch<4, 4, 16, 64, 2, 3, 1, 1>(variant, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the eight numbers of tile configuration `config` into out; -1 past the table
extern "C" int unet3d_conv3x3x3_tf32x3_config(int config, int* out) {
  if (config < 0 || config >= N_CONFIGS) return -1;
  for (int i = 0; i < 8; ++i) out[i] = CONFIGS[config][i];
  return 0;
}
