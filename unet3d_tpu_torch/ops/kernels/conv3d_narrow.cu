// 3x3x3 stride-1 SAME convolution over NDHWC activations, the Hopper
// (sm_90a) form for narrow and ragged channel counts, in two element types:
//
// * bf16 (ops/conv3d_kernel.kernel_form's "narrow"): every bf16 call whose
//   Cin is not a multiple of 4, or Cout not of 8, or whose x is not 16-byte
//   aligned. The sites: the U-Nets' first conv and its input gradient (1 ->
//   32, 32 -> 4), the registration heads (16 -> 3, 3 -> 16), MONAI UNet's
//   last unit (3 -> 3).
// * f32 in 3xTF32 ("tf32x3_narrow"): every f32 call whose Cin is not a
//   multiple of 4, or whose x is not 16-byte aligned (conv3d_tf32x3.cu takes
//   the others). The sites: MONAI UNet's last unit (3 -> 3) and RegUNet's
//   extraction-head input gradient (3 -> 16) in their f32 steps, the
//   Generator's head.
//
// Both compute the three variants of conv3d_wgmma.cu (conv, conv_stats,
// block_stats) and replace the same TPU kernels:
// unet3d_tpu/ops/pallas/conv3d_kernel.py _conv_batched / pallas_conv3d, the
// statistics epilogue of winograd_kernel.py _winograd_batched_stats, and
// block_kernel.py pallas_block_conv3d.
//
// What bounds it: bytes. At 3 or 4 outputs a voxel moves (Cin + Cout)
// elements for 54 * Cin * Cout flops, far below the card's ~295 bf16 flops a
// byte; the 128^3 sites' bounds are 8-45 us of memory traffic in bf16 and
// 15-48 us in f32. The f32 form's three TF32 products per product count too:
// at 3 -> 3 the padded 3xTF32 work is ~11 GFLOP, ~0.023 ms at 495 TFLOP/s.
// So the design moves each input byte into the SM once and wastes as little
// tensor-core work on padding as the mma shapes allow:
//
// * M tile = a 4 x 8 x 16 brick of output voxels inside one batch item
//   (512 rows, one x-line of 16 voxels per m16 tile, four lines per warp).
//   The brick plus its one-voxel halo (6 x 10 x 18 voxels) is staged once
//   in shared memory and every tap reads it there. Voxels outside the
//   volume, or outside [0, d_in) on D, and channels past Cin stay zero.
//   Staging (bf16): with Cin a multiple of 8 and x 16-byte aligned, one
//   cp.async of 16 bytes per 8 channels of a voxel; otherwise coalesced
//   2-byte loads (any Cin, x at 2-byte alignment: microbatch slices, odd
//   Cin). f32: 4-byte cp.async, consecutive threads on consecutive elements
//   (any Cin, x at 4-byte alignment).
// * N tile = 8 output channels per mma (A and B from registers, f32
//   accumulators): bf16 m16n8k16; f32 m16n8k8 tf32, three products per k8
//   step (lo*hi, hi*lo, then hi*hi of the TF32 high and low parts, the
//   3xTF32 split of conv3d_tf32x3.cu, which keeps f32 accuracy). A block
//   takes NT = 1, 2, 4 or 8 such tiles (Cout up to 8, 16, 32, then 64-wide
//   blocks along Cout; f32 stops at 4, 32-wide blocks, for its registers), so
//   3 or 4 outputs pad to 8, not to a 64-wide tile.
// * K, below 16 input channels (FOLD): the taps are folded into K. The
//   staged voxel holds CS channels (bf16: Cin rounded up to even; f32: Cin),
//   K = 27 * CS rounded up to the mma's depth (16; f32 8): at 3 -> 3, 7 k16
//   or 11 k8 steps in place of 27 taps at 3/16 use. A fragments are
//   gathered from the brick by 32-bit shared loads (bf16: two channels of one
//   tap; f32: one element) through a per-block table of each k word's
//   offset. From 16 channels up (TAP): K = (chunk, tap, k step) with chunks
//   of 16 or 32 bf16 channels or 16 f32 channels (32 bytes per k step), as
//   in conv3d_wgmma.cu; A comes by ldmatrix from voxel rows padded by 16
//   bytes (48 or 80 bytes: eight rows of one ldmatrix fall in eight distinct
//   bank groups). An 8x8 b16 ldmatrix matrix is an 8x4 f32 one, and lane t
//   receives row t / 4, element t % 4: the m16n8k8 tf32 A fragment.
// * f32: each A element is split into TF32 hi and lo in registers once per
//   k8 step (cvt.rna.tf32.f32). In TAP mode the tensor cores' sum of one
//   chunk is added into an f32 total with f32 adds (their own accumulation
//   drifts from f32 with the length of K, conv3d_tf32x3.cu's note).
// * B: the weight is packed per call by the wrapper
//   (conv3d_kernel.pack_narrow) into the B fragments in the kernel's K order,
//   zero past Cin and Cout (f32: the TF32 hi and lo parts, split by the
//   wrapper with the kernel's rounding); each lane reads its 8 (f32: 16)
//   bytes per (k step, N tile) from L1. The next step's A and B fragments
//   load while this step's products run.
// * PROLOGUE (block_stats): lrelu(x * inv[n, c] + shift[n, c]) in f32
//   (bf16: rounded to bf16), once per staged element; padding stays zero
//   (SAME padding pads the activation).
// * D-halo mode (the space axis of unet3d_tpu_torch/parallel/): x holds d_in
//   planes, the output d; output plane z's tap kd reads x plane
//   z + kd - pad_lo, zero outside [0, d_in) (the SAME conv: d_in = d,
//   pad_lo = 1).
// * Epilogue: accumulators (bf16: rounded to bf16) stored from registers,
//   two channels a store where Cout is even (at 17-32 outputs through shared
//   memory, each x-line's 16 x Cout values in 16-byte stores); STATS sums the
//   stored values per channel in registers and warp shuffles, then one
//   atomicAdd per (item, channel) per block into the caller-zeroed (N, 2,
//   Cout) f32 buffer (the add order changes from run to run).
//
// What it costs beyond the bytes (tools/conv3d_narrow_variants.py, PERF.md):
// a block stages its brick, then computes, so the staging is not hidden
// behind the products (a fifth to a third of the time at the 128^3
// sites); A fragments are read from shared memory once per (voxel, k step)
// and feed only 8 (or NT * 8) columns, so at 32 -> 4 those reads take longer
// than the device-memory traffic; the f32 form splits each A element in
// registers at every k8 step it is read.
//
// 256 threads; 35-90 KB of shared memory. Built by nvcc with the other
// sources (kernels/build.py) and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BZ = 4, BY = 8, BX = 16;       // output brick (z, y, x)
constexpr int MW = BZ * BY / WARPS;          // x-lines (m16 tiles) per warp
constexpr int HZ = BZ + 2, HY = BY + 2, HX = BX + 2;
constexpr int HALO = HZ * HY * HX;           // staged voxels
constexpr int TAPS = 27;
// FOLD: a staged x-line of HX voxels takes LINE elements whatever CS is, so
// a warp's x-lines (consecutive along y) lie LINE apart and its A loads
// take their line from an immediate offset
constexpr int LINE = HX * 16;
static_assert(BX == 16, "one m16 tile is one x-line");
static_assert(BY % MW == 0, "a warp's x-lines are consecutive along y");

// the element type's mma: KD elements of K per step (32 bytes of bf16 pairs
// or of f32), WORD elements per 32-bit A register, the B fragment of one
// lane per (k step, N tile), the widest N block in 8-wide tiles
template <typename T> struct Form;
template <> struct Form<bf16> {
  static constexpr int KD = 16, WORD = 2, MAX_NT = 8;
  using B = uint2;  // rows 2q, 2q + 1, 2q + 8, 2q + 9 of column n
};
template <> struct Form<float> {
  static constexpr int KD = 8, WORD = 1, MAX_NT = 4;
  using B = uint4;  // rows q, q + 4 of column n: TF32 hi, then lo
};

// the epilogue's bf16 output lines (up to 32 channels) fit the smallest brick
static_assert(WARPS * MW * BX * 32 * 2 <= HZ * HY * LINE * 2 &&
                  WARPS * MW * BX * 32 * 2 <= HALO * 24 * 2,
              "output lines fit the brick");

template <typename T>
struct Args {
  const T* x;           // (N, D_in, H, W, Cin)
  const typename Form<T>::B* w;  // packed B fragments (n_blocks, ksteps, NT, 32 lanes)
  T* y;                 // (N, D, H, W, Cout)
  const float* inv;     // (N, Cin), PROLOGUE only
  const float* shift;   // (N, Cin), PROLOGUE only
  float* stats;         // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;  // d: the output's depth
  int d_in, pad_lo;  // x's depth; output plane z, tap kd reads x plane z + kd - pad_lo
  int cs;            // staged channels per voxel (elements)
  int kh;            // TAP: k steps per tap and chunk (1 or 2)
  int chunks;        // TAP: staged chunks of kh * KD channels
  int ksteps;        // k steps in all
  int n_blocks;      // blocks along Cout, NT * 8 channels each
  int bricks_z, bricks_y, bricks_x;
  int vec;           // bf16, Cin % 8 == 0 and x 16-byte aligned: stage by cp.async
  float alpha;
};

// the tiling of a call, as ops/conv3d_kernel.narrow_plan computes it
struct Plan {
  int fold, cs, kh, chunks, ksteps, nt, n_blocks;
};

template <typename T>
Plan plan_of(int cin, int cout) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int KD = Form<T>::KD;
  Plan p{};
  p.fold = cin < 16;
  if (p.fold) {
    p.cs = F32 ? cin : cin + (cin & 1);
    p.kh = 0;
    p.chunks = 1;
    p.ksteps = (TAPS * p.cs + KD - 1) / KD;
  } else {
    p.kh = F32 || cin > 16 ? 2 : 1;
    const int width = p.kh * KD;  // channels per chunk
    p.cs = width + 16 / static_cast<int>(sizeof(T));  // rows padded by 16 bytes
    p.chunks = (cin + width - 1) / width;
    p.ksteps = p.chunks * TAPS * p.kh;
  }
  const int tiles = (cout + 7) / 8;
  p.nt = tiles <= 1 ? 1 : tiles <= 2 ? 2 : tiles <= 4 ? 4 : Form<T>::MAX_NT;
  p.n_blocks = (tiles + p.nt - 1) / p.nt;
  return p;
}

// c += a * b for one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ unsigned short activate(unsigned short bits, float inv, float shift,
                                                   float alpha) {
  float f = fmaf(__bfloat162float(__ushort_as_bfloat16(bits)), inv, shift);
  f = f >= 0.f ? f : f * alpha;
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// the staged brick: FOLD, HZ * HY lines of LINE elements (voxel hx of a
// line at hx * CS); else HALO voxels of CS elements
template <typename T, bool FOLD>
__host__ __device__ constexpr int halo_bytes(int cs) {
  return align16((FOLD ? HZ * HY * LINE : HALO * cs) * static_cast<int>(sizeof(T)));
}

// the brick, then each halo line's first voxel in x, then FOLD's k-word
// offsets, then STATS's per-warp sums
template <typename T, bool FOLD, int NT, bool STATS>
__host__ __device__ constexpr int smem_bytes(int cs, int ksteps) {
  return halo_bytes<T, FOLD>(cs) + HZ * HY * 8 + (FOLD ? ksteps * 8 * 4 : 0) +
         (STATS ? 2 * WARPS * NT * 8 * 4 : 0);
}

// blocks an SM the registers are bounded for: the products wait on shared
// loads, so more warps in flight pay (bf16: faster on an H100 than the
// compiler's own choice at the folded sites, no slower at the others; f32
// holds twice the B fragments, splits A, and in TAP mode keeps a second set
// of accumulators, the chunks' f32 total)
template <typename T, bool FOLD, int NT>
constexpr int min_blocks() {
  return std::is_same<T, float>::value
             ? (FOLD ? (NT == 1 ? 3 : NT == 2 ? 2 : 1) : (NT == 1 ? 2 : 1))
             : (FOLD && NT == 1 ? 4 : NT <= 2 ? 3 : NT == 4 ? 2 : 1);
}

template <typename T, bool FOLD, int NT, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, FOLD, NT>()))
    conv3x3x3_narrow(const Args<T> a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int WORD = Form<T>::WORD;
  constexpr int BN = NT * 8;
  constexpr bool PROMOTE = F32 && !FOLD;  // an f32 total of the chunks' sums
  using BFrag = typename Form<T>::B;
  extern __shared__ __align__(128) uint8_t smem[];
  T* const halo = reinterpret_cast<T*>(smem);
  const int hbytes = halo_bytes<T, FOLD>(a.cs);
  long long* const lines = reinterpret_cast<long long*>(smem + hbytes);
  int* const koff = reinterpret_cast<int*>(lines + HZ * HY);  // FOLD: word offset per k word
  float* const red = reinterpret_cast<float*>(koff + (FOLD ? a.ksteps * 8 : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // block -> (N block, brick x, brick y, brick z, item), N block fastest so
  // the N blocks of one brick find its input in L2
  int bid = blockIdx.x;
  const int nb = bid % a.n_blocks; bid /= a.n_blocks;
  const int x0 = (bid % a.bricks_x) * BX; bid /= a.bricks_x;
  const int y0 = (bid % a.bricks_y) * BY; bid /= a.bricks_y;
  const int z0 = (bid % a.bricks_z) * BZ;
  const int item = bid / a.bricks_z;

  // halo line l (hz * HY + hy) -> x's voxel at x = 0 of it, or -1 outside x
  for (int l = tid; l < HZ * HY; l += THREADS) {
    const int zz = z0 + l / HY - a.pad_lo, yy = y0 + l % HY - 1;
    lines[l] = zz >= 0 && zz < a.d_in && yy >= 0 && yy < a.h
                   ? ((static_cast<long long>(item) * a.d_in + zz) * a.h + yy) * a.w_
                   : -1;
  }
  __syncthreads();
  // halo voxel v -> its voxel of x; false outside x
  auto source = [&](int v, long long& vox) {
    const int l = v / HX, xx = x0 - 1 + (v - l * HX);
    const long long base = lines[l];
    vox = base + xx;
    return base >= 0 && xx >= 0 && xx < a.w_;
  };
  // halo voxel v's first element in the brick
  auto elem = [&](int v) { return FOLD ? (v / HX) * LINE + (v % HX) * a.cs : v * a.cs; };
  // channels [c0, c0 + nch) of every halo voxel into the brick (bf16: nch even)
  auto stage = [&](int c0, int nch) {
    if constexpr (F32) {
      // 4-byte copies, consecutive threads on consecutive elements, zero
      // past the volume and Cin; asynchronous, so a thread's copies are in
      // flight together
      for (int i = tid; i < HALO * nch; i += THREADS) {
        const int v = i / nch, c = i - v * nch, ch = c0 + c;
        long long vox;
        const bool ok = source(v, vox) && ch < a.cin;
        cp_async4(smem_u32(halo + elem(v) + c), ok ? a.x + vox * a.cin + ch : a.x, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      if (PROLOGUE) {  // each thread activates what it copied; padding stays zero
        for (int i = tid; i < HALO * nch; i += THREADS) {
          const int v = i / nch, c = i - v * nch, ch = c0 + c;
          long long vox;
          if (!source(v, vox) || ch >= a.cin) continue;
          float* const p = halo + elem(v) + c;
          const float f = fmaf(*p, a.inv[item * a.cin + ch], a.shift[item * a.cin + ch]);
          *p = f >= 0.f ? f : f * a.alpha;
        }
      }
    } else if (a.vec) {  // 8 channels a 16-byte copy; a thread keeps its group
      const int groups = nch >> 3, glog = groups >> 1;  // 1, 2 or 4 groups
      const int g = tid & (groups - 1), ch = c0 + g * 8;
      for (int i = tid; i < HALO * groups; i += THREADS) {
        const int v = i >> glog;
        long long vox;
        const bool ok = source(v, vox) && ch < a.cin;
        cp_async16(smem_u32(halo + elem(v) + g * 8), ok ? a.x + vox * a.cin + ch : a.x, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      if (PROLOGUE && ch < a.cin) {  // each thread activates what it copied
        float sc[8], sh[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[e] = a.inv[item * a.cin + ch + e];
          sh[e] = a.shift[item * a.cin + ch + e];
        }
        for (int i = tid; i < HALO * groups; i += THREADS) {
          const int v = i >> glog;
          long long vox;
          if (!source(v, vox)) continue;  // padding stays zero
          uint4* const p = reinterpret_cast<uint4*>(halo + elem(v) + g * 8);
          uint4 val = *p;
          __nv_bfloat162* const h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float2 f = __bfloat1622float2(h2[e]);
            f.x = fmaf(f.x, sc[2 * e], sh[2 * e]);
            f.y = fmaf(f.y, sc[2 * e + 1], sh[2 * e + 1]);
            h2[e] = __floats2bfloat162_rn(f.x >= 0.f ? f.x : f.x * a.alpha,
                                          f.y >= 0.f ? f.y : f.y * a.alpha);
          }
          *p = val;
        }
      }
    } else {  // any Cin and alignment: a thread stages whole voxels, two channels a store
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(a.x);
      for (int v = tid; v < HALO; v += THREADS) {
        long long vox;
        const bool in = source(v, vox);
        const unsigned short* src = xs + (in ? vox * a.cin : 0);
        uint32_t* dst = reinterpret_cast<uint32_t*>(halo + elem(v));
        for (int c = 0; c < nch; c += 2) {
          uint32_t pair = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = c0 + c + e;
            if (in && ch < a.cin) {
              unsigned short bits = __ldg(src + ch);
              if (PROLOGUE)
                bits = activate(bits, a.inv[item * a.cin + ch], a.shift[item * a.cin + ch],
                                a.alpha);
              pair |= static_cast<uint32_t>(bits) << (16 * e);
            }
          }
          dst[c >> 1] = pair;
        }
      }
    }
  };

  float acc[MW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // this warp's x-lines: line L = warp * MW + mt of the brick, (L / BY, L % BY)
  auto line_of = [&](int mt, int& lz, int& ly) {
    const int L = warp * MW + mt;
    lz = L / BY;
    ly = L % BY;
  };
  const BFrag* const wfrag = a.w + static_cast<long long>(nb) * a.ksteps * NT * 32 + lane;
  auto load_b = [&](int s, BFrag (&b)[NT]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = __ldg(wfrag + (static_cast<long long>(s) * NT + j) * 32);
  };
  auto products = [&](const uint32_t (&fa)[MW][4], const BFrag (&fb)[NT]) {
    if constexpr (F32) {
      uint32_t hi[MW][4], lo[MW][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(fa[mt][e]), hi[mt][e], lo[mt][e]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
          mma_tf32x3_m16n8k8(acc[mt][j], hi[mt], lo[mt], fb[j].x, fb[j].y, fb[j].z, fb[j].w);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) mma16816(acc[mt][j], fa[mt], fb[j]);
    }
  };
  uint32_t af[2][MW][4];
  BFrag bf[2][NT];

  if constexpr (FOLD) {
    // k = tap * CS + c; the word of k (bf16: the pair k, k + 1) lies at word
    // offset koff[k / WORD] from the row's own voxel; words past 27 * CS
    // point at the first word (finite values that meet zero weights)
    for (int kp = tid; kp < a.ksteps * 8; kp += THREADS) {
      const int k = WORD * kp;
      int off = 0;
      if (k < TAPS * a.cs) {
        const int tap = k / a.cs, c = k - tap * a.cs;
        off = (((tap / 9) * HY + (tap / 3) % 3) * LINE + (tap % 3) * a.cs + c) / WORD;
      }
      koff[kp] = off;
    }
    stage(0, a.cs);
    __syncthreads();
    const int q = lane & 3, r0 = lane >> 2;
    int lz, ly;
    line_of(0, lz, ly);
    // row r0 of this warp's first line at tap 0; line mt is mt * LINE
    // elements on, row r0 + 8 another 8 * CS
    const uint32_t* const words =
        reinterpret_cast<const uint32_t*>(halo + (lz * HY + ly) * LINE + r0 * a.cs);
    const int h8 = 8 * a.cs / WORD;  // words from row r0 to row r0 + 8
    auto load_a = [&](int s, uint32_t (&f)[MW][4]) {
      const uint32_t* const p0 = words + koff[s * 8 + q];
      const uint32_t* const p1 = words + koff[s * 8 + 4 + q];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        f[mt][0] = p0[mt * LINE / WORD];
        f[mt][1] = p0[mt * LINE / WORD + h8];
        f[mt][2] = p1[mt * LINE / WORD];
        f[mt][3] = p1[mt * LINE / WORD + h8];
      }
    };
    auto step = [&](int s, auto parity) {
      constexpr int P = decltype(parity)::value;
      if (s + 1 < a.ksteps) {
        load_a(s + 1, af[P ^ 1]);
        load_b(s + 1, bf[P ^ 1]);
      }
      products(af[P], bf[P]);
    };
    load_a(0, af[0]);
    load_b(0, bf[0]);
    int s = 0;
    for (; s + 1 < a.ksteps; s += 2) {
      step(s, std::integral_constant<int, 0>{});
      step(s + 1, std::integral_constant<int, 1>{});
    }
    if (s < a.ksteps) step(s, std::integral_constant<int, 0>{});
  } else {
    // this lane's ldmatrix row of each line at tap 0, k step 0 (bytes): an
    // 8x8 b16 matrix of 16-byte rows, rows (lane & 15), bytes (lane >> 4) * 16
    uint32_t ra[MW];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      int lz, ly;
      line_of(mt, lz, ly);
      ra[mt] = smem_u32(halo) +
               ((lz * HY + ly) * HX + (lane & 15)) * a.cs * static_cast<int>(sizeof(T)) +
               (lane >> 4) * 16;
    }
    const int steps = TAPS * a.kh;  // per chunk: (tap, k step)
    auto load_a = [&](int t, uint32_t (&f)[MW][4]) {
      const int tap = a.kh == 1 ? t : t >> 1, half = t & (a.kh - 1);
      const uint32_t off =
          (((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3) * a.cs * static_cast<int>(sizeof(T)) +
          half * 32;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) ldmatrix_x4(ra[mt] + off, f[mt]);
    };
    float total[PROMOTE ? MW : 1][NT][4];
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[mt][j][e] = 0.f;
    }
    for (int chunk = 0; chunk < a.chunks; ++chunk) {
      if (chunk > 0) __syncthreads();  // every warp is done with the last chunk
      stage(chunk * a.kh * Form<T>::KD, a.kh * Form<T>::KD);
      __syncthreads();
      const int s0 = chunk * steps;
      auto step = [&](int t, auto parity) {
        constexpr int P = decltype(parity)::value;
        if (t + 1 < steps) {
          load_a(t + 1, af[P ^ 1]);
          load_b(s0 + t + 1, bf[P ^ 1]);
        }
        products(af[P], bf[P]);
      };
      load_a(0, af[0]);
      load_b(s0, bf[0]);
      int t = 0;
      for (; t + 1 < steps; t += 2) {
        step(t, std::integral_constant<int, 0>{});
        step(t + 1, std::integral_constant<int, 1>{});
      }
      if (t < steps) step(t, std::integral_constant<int, 0>{});
      if constexpr (PROMOTE) {  // the chunk's sum into the f32 total
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[mt][j][e] += acc[mt][j][e];
              acc[mt][j][e] = 0.f;
            }
      }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = total[mt][j][e];
    }
  }

  // epilogue. acc[mt][j][2 * hh + e] is row r0 + 8 * hh of line mt (x =
  // x0 + r0 + 8 * hh), column j * 8 + 2 * q + e of this block's N range.
  // bf16 at 17-32 outputs (NT = 4, one N block) each warp's lines go out
  // through shared memory as whole runs of 16 voxels x Cout (contiguous in
  // y), 16 bytes a store where aligned (faster on an H100 at 1 -> 32);
  // otherwise each lane stores its channel pairs (no barrier: faster at NT =
  // 1, 2; f32's NT = 4 blocks also take Cout past 32 in several N blocks,
  // whose rows the staged runs would not hold).
  constexpr bool kStaged = NT == 4 && !F32;
  const int q = lane & 3, r0 = lane >> 2;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
  // y is the wrapper's (16-byte aligned): with Cout even a pair is one store
  const bool even = (a.cout & 1) == 0;
  T* const tile = halo + warp * (MW * 16 * BN);  // this warp's lines, rows of Cout
  if (kStaged) __syncthreads();  // every warp is done with the brick
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
    int lz, ly;
    line_of(mt, lz, ly);
    const int zz = z0 + lz, yy = y0 + ly;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int xx = x0 + r0 + 8 * hh;
      const bool ok = zz < a.d && yy < a.h && xx < a.w_;
      const bool store = kStaged || ok;
      T* const out =
          kStaged ? tile + (mt * 16 + r0 + 8 * hh) * a.cout
                  : a.y + (((static_cast<long long>(item) * a.d + zz) * a.h + yy) * a.w_ + xx) *
                              a.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = nb * BN + j * 8 + 2 * q;
        float2 f;  // the pair as stored
        if constexpr (F32) {
          f = make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
          if (store) {
            if (even && co < a.cout) {
              *reinterpret_cast<float2*>(out + co) = f;
            } else {
              if (co < a.cout) out[co] = f.x;
              if (co + 1 < a.cout) out[co + 1] = f.y;
            }
          }
        } else {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
          if (store) {
            if (even && co < a.cout) {
              *reinterpret_cast<__nv_bfloat162*>(out + co) = v;
            } else {
              if (co < a.cout) out[co] = v.x;
              if (co + 1 < a.cout) out[co + 1] = v.y;
            }
          }
          f = __bfloat1622float2(v);
        }
        if (STATS && ok) {
          s1[j][0] += f.x; s2[j][0] += f.x * f.x;
          s1[j][1] += f.y; s2[j][1] += f.y * f.y;
        }
      }
    }
  }
  if (kStaged) {
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte store
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      int lz, ly;
      line_of(mt, lz, ly);
      const int zz = z0 + lz, yy = y0 + ly, nx = min(BX, a.w_ - x0);
      if (zz >= a.d || yy >= a.h) continue;
      T* const dst =
          a.y + (((static_cast<long long>(item) * a.d + zz) * a.h + yy) * a.w_ + x0) * a.cout;
      const T* const src = tile + mt * 16 * a.cout;  // 16-byte aligned
      const int n = nx * a.cout;
      const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
      int done = 0;
      if (at % 16 == 0) {
        for (int i = lane; i < n / VEC; i += 32)
          reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
        done = n / VEC * VEC;
      } else if (!F32 && at % 4 == 0) {
        for (int i = lane; i < n / 2; i += 32)
          reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
        done = n / 2 * 2;
      }
      for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
    }
  }
  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
          s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], m);
        }
        if (lane < 4) {
          red[warp * BN + j * 8 + 2 * lane + e] = s1[j][e];
          red[(WARPS + warp) * BN + j * 8 + 2 * lane + e] = s2[j][e];
        }
      }
    __syncthreads();
    if (tid < BN) {
      const int co = nb * BN + tid;
      if (co < a.cout) {
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          t1 += red[w * BN + tid];
          t2 += red[(WARPS + w) * BN + tid];
        }
        atomicAdd(a.stats + (2LL * item) * a.cout + co, t1);
        atomicAdd(a.stats + (2LL * item + 1) * a.cout + co, t2);
      }
    }
  }
}

template <typename T, bool FOLD, int NT, bool PROLOGUE, bool STATS>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  auto kernel = conv3x3x3_narrow<T, FOLD, NT, PROLOGUE, STATS>;
  constexpr int KD = Form<T>::KD;
  static bool attribute_set = false;  // once per instantiation, at its largest
  if (!attribute_set) {
    const int most = FOLD ? smem_bytes<T, true, NT, STATS>(16, TAPS * 16 / KD)
                          : smem_bytes<T, false, NT, STATS>(
                                2 * KD + 16 / static_cast<int>(sizeof(T)), 0);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const long long blocks = static_cast<long long>(a.n) * a.bricks_z * a.bricks_y *
                           a.bricks_x * a.n_blocks;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes<T, FOLD, NT, STATS>(a.cs, a.ksteps),
           stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FOLD, int NT>
cudaError_t dispatch(int variant, const Args<T>& a, cudaStream_t stream) {
  switch (variant) {
    case 0: return launch<T, FOLD, NT, false, false>(a, stream);
    case 1: return launch<T, FOLD, NT, false, true>(a, stream);
    case 2: return launch<T, FOLD, NT, true, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool FOLD>
cudaError_t dispatch_nt(int nt, int variant, const Args<T>& a, cudaStream_t stream) {
  switch (nt) {
    case 1: return dispatch<T, FOLD, 1>(variant, a, stream);
    case 2: return dispatch<T, FOLD, 2>(variant, a, stream);
    case 4: return dispatch<T, FOLD, 4>(variant, a, stream);
    case 8:
      if constexpr (Form<T>::MAX_NT == 8) return dispatch<T, FOLD, 8>(variant, a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// the C entries' shared body: checks the alignments and the plan, then
// launches the instantiation of the plan
template <typename T>
int run(int variant, const void* x, const void* w, void* y, const float* inv,
        const float* shift, float* stats, int n, int d, int h, int w_, int cin, int cout,
        int d_in, int pad_lo, int fold, int cs, int kh, int chunks, int ksteps, int nt,
        int n_blocks, int bricks_z, int bricks_y, int bricks_x, float alpha, void* stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (cin < 1 || cout < 1 || d_in < 1 || pad_lo < 0 || pad_lo > 2 ||
      reinterpret_cast<std::uintptr_t>(x) % sizeof(T) != 0 ||
      reinterpret_cast<std::uintptr_t>(w) % sizeof(typename Form<T>::B) != 0 ||
      reinterpret_cast<std::uintptr_t>(y) % (2 * sizeof(T)) != 0)
    return cudaErrorInvalidValue;
  const Plan p = plan_of<T>(cin, cout);
  if (fold != p.fold || cs != p.cs || kh != p.kh || chunks != p.chunks || ksteps != p.ksteps ||
      nt != p.nt || n_blocks != p.n_blocks || bricks_z != (d + BZ - 1) / BZ ||
      bricks_y != (h + BY - 1) / BY || bricks_x != (w_ + BX - 1) / BX)
    return cudaErrorInvalidValue;
  const int vec = !F32 && cin % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  Args<T> a{static_cast<const T*>(x), static_cast<const typename Form<T>::B*>(w),
            static_cast<T*>(y), inv, shift, stats, n, d, h, w_, cin, cout, d_in, pad_lo, cs,
            kh, chunks, ksteps, n_blocks, bricks_z, bricks_y, bricks_x, vec, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fold ? dispatch_nt<T, true>(nt, variant, a, s) : dispatch_nt<T, false>(nt, variant, a, s);
}

}  // namespace

// variant: 0 = conv, 1 = conv_stats, 2 = block_stats. w is the packed weight
// of ops/conv3d_kernel.pack_narrow, (n_blocks, ksteps, nt, 32, 4) bf16; x at
// 2-byte alignment, w 8-byte and y 4-byte aligned, any Cin and Cout. fold ... n_blocks
// and the bricks are the wrapper's plan (conv3d_kernel.narrow_plan); a plan
// that differs from this file's returns cudaErrorInvalidValue. d is the
// output's depth and d_in x's (D-halo mode: output plane z, tap kd reads x
// plane z + kd - pad_lo, zero outside [0, d_in); the SAME conv is d_in = d,
// pad_lo = 1). Returns the cudaError_t of the launch (0 on success).
extern "C" int unet3d_conv3x3x3_narrow(int variant, const void* x, const void* w, void* y,
                                       const float* inv, const float* shift, float* stats,
                                       int n, int d, int h, int w_, int cin, int cout,
                                       int d_in, int pad_lo, int fold, int cs, int kh,
                                       int chunks, int ksteps, int nt, int n_blocks,
                                       int bricks_z, int bricks_y, int bricks_x, float alpha,
                                       void* stream) {
  return run<bf16>(variant, x, w, y, inv, shift, stats, n, d, h, w_, cin, cout, d_in, pad_lo,
                   fold, cs, kh, chunks, ksteps, nt, n_blocks, bricks_z, bricks_y, bricks_x,
                   alpha, stream);
}

// The f32 form, 3xTF32 on the tensor cores, with the arguments of
// unet3d_conv3x3x3_narrow: f32 x at 4-byte alignment, y 8-byte aligned; w the
// packed weight of ops/conv3d_kernel.pack_narrow for an f32 plan
// (narrow_plan(..., torch.float32)), (n_blocks, ksteps, nt, 32, 4) f32 (each
// lane's TF32 hi and lo parts of rows q and q + 4), 16-byte aligned.
extern "C" int unet3d_conv3x3x3_narrow_tf32x3(int variant, const void* x, const void* w,
                                              void* y, const float* inv, const float* shift,
                                              float* stats, int n, int d, int h, int w_,
                                              int cin, int cout, int d_in, int pad_lo, int fold,
                                              int cs, int kh, int chunks, int ksteps, int nt,
                                              int n_blocks, int bricks_z, int bricks_y,
                                              int bricks_x, float alpha, void* stream) {
  return run<float>(variant, x, w, y, inv, shift, stats, n, d, h, w_, cin, cout, d_in, pad_lo,
                    fold, cs, kh, chunks, ksteps, nt, n_blocks, bricks_z, bricks_y, bricks_x,
                    alpha, stream);
}

extern "C" const char* unet3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
