// Weight gradient of the 3x3x3 stride-2 convolution with symmetric pads of 1
// (NDHWC bf16 activations, DHWIO weights), the narrow form for Hopper
// (sm_90a): every bf16 call the wgmma form (s2_wgrad_wgmma.cu) does not take,
// Cin or Cout not a multiple of 8 or an operand not 16-byte aligned: the
// first stride-2 convs of MONAI's UNet (4 -> 16) and AutoEncoder (4 -> 4),
// any channel count, alignment and pad_lo:
//
//   dw[kd, kh, kw, ci, co] = sum_{n, od, oh, ow}
//       xp[n, 2od + kd, 2oh + kh, 2ow + kw, ci] * g[n, od, oh, ow, co]
//
// with xp the input padded by one voxel of zeros on every side (on D, by
// pad_lo below: 0 in the D-halo mode, where x's first plane is the slab's
// neighbour below). Replaces unet3d_tpu/ops/pallas/s2_wgrad_kernel.py:158
// (s2_wgrad_pallas, whose pallas_call is at :177) for those calls.
// s2_wgrad_tf32x3.cu takes the f32 calls. The fixed-order split-K sum below
// serves all three forms.
//
// What bounds it: the bytes. At 4 input channels a voxel of x is 8 bytes and
// the products are few (2 * 27 * 4 * 16 flops per output voxel at 4 -> 16):
// x 128^3 x 4 and g 64^3 x 16 in bf16 read once and dw written once are
// 0.008 ms at 3.35 TB/s, the products 0.001 ms on the tensor cores.
//
// Design. A GEMM with M = 27 * Cin rows ordered (tap, ci), N = Cout and K =
// the output voxels:
// * A block owns 8 input channels (one chunk of Cin: 27 taps x 8 channels =
//   14 m16 tiles, two per warp of seven), NT n8 tiles of output channels
//   (BN = 8 NT <= 32) and a contiguous range of segments of K. A segment is
//   `lines` output x-lines of `sw` voxels each (sw a multiple of 16, at most
//   128; lines * sw of 48 to 128 voxels; s2_wgrad_kernel.narrow_plan).
// * Staging: for each line of a segment and each (kd, kh), the input x-line
//   segment it reads (2 sw + 1 voxels x 8 channels, 16-byte rows) is staged
//   once with its W parity split: row j <= sw holds input column 2 j - 1
//   (even positions of the padded line), row sw + 1 + j column 2 j (odd).
//   Tap kw of output voxel ow then reads row ow (kw 0), sw + 1 + ow (kw 1)
//   or ow + 1 (kw 2): consecutive voxels read consecutive rows, the lane
//   merge the TPU kernel did on the host, here in shared memory. Zero in the
//   padding, off the volume and past Cin. g is staged as NT arrays of K
//   16-byte rows (8 output channels of one voxel), zero past Wo, the last
//   line and Cout. Copies by cp.async of 16, 8 or 4 bytes, the widest that
//   Cin (Cout) and x's (g's) alignment allow (Cin 4: 8 bytes a voxel), else
//   2-byte loads; a 3-deep ring, two segments loading ahead.
// * Operands: A (rows (tap, ci), K voxels) and B (K voxels, columns co) both
//   come from the staged rows by ldmatrix.trans (rows = voxels, 8 channels
//   of 16 bits: after the transpose each lane holds two consecutive voxels
//   of one channel, the m16n8k16 fragments); products by mma.sync m16n8k16
//   bf16 with f32 accumulation. A 28th tap (the last m16 tile's second
//   half) reads a zero row.
// * Split-K, deterministic: the wrapper splits the segments into `splits`
//   contiguous ranges so that chunks x N tiles x splits fill about two
//   blocks a SM; each split writes its f32 partial tile to its own slice of
//   a (splits, M, N) scratch and sum_splits adds the slices in a fixed
//   order, so the result does not depend on the order blocks run in.
//
// Built by nvcc into the same shared library as the other sources
// (unet3d_tpu_torch/kernels/build.py), called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90_wgmma.cuh"

// dw[i] = sum over s of part[s][i], s in order: the split-K sum of this form
// and of s2_wgrad_wgmma.cu's and s2_wgrad_tf32x3.cu's (defined below)
cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream);

namespace {

constexpr int CC = 8;                    // input channels per block (one 16-byte row)
constexpr int TAPS = 27;
constexpr int WARPS = 7;                 // two m16 tiles (4 taps x 8 channels) each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SW = 128;              // output voxels per line of a segment, at most
constexpr int MAX_K = 128;               // output voxels per segment, at most
constexpr int MAX_NT = 4;                // n8 tiles per block
constexpr int STAGES = 3;
constexpr int LEAD = STAGES - 1;         // segments loaded ahead of the current one
// the widest stage: one line of 128 voxels (9 x 257 x rows) and 4 x 128 g rows
constexpr int MAX_STAGE_ROWS = TAPS / 3 * (2 * MAX_SW + 1) + MAX_NT * MAX_K;
constexpr int MAX_SMEM = STAGES * MAX_STAGE_ROWS * 16 + 16;

struct Args {
  const __nv_bfloat16* x;  // (N, D, H, W, Cin)
  const __nv_bfloat16* g;  // (N, Do, Ho, Wo, Cout)
  float* out;              // (splits, 27 * Cin, Cout) f32, or dw with one split
  int n, d, h, w_, cin;
  int do_, ho, wo, cout;
  int pad_lo;  // output plane od, tap kd reads x plane 2 od + kd - pad_lo
  int n_tiles, chunks, sw, lines, ow_blocks, segments, per_split;
  int x_vec, g_vec;  // bytes per copy: 16, 8, 4 or 2
};

// c += a * b for one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8x8 b16 matrices, transposed; lanes 0-7 and 8-15 give their row
// addresses: lane t receives column t / 4, rows 2 (t % 4) and 2 (t % 4) + 1
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// one 16-byte staged row (8 channels) from `src`, zero where !valid, by
// copies of `vec` bytes (2: plain loads and one store, zero past `left`
// channels). A copy whose channels all lie past `left` (the same for every
// row a block stages in one place) is not issued: the block cleared it once.
__device__ __forceinline__ void stage_row(uint32_t dst, uint8_t* dst_ptr,
                                          const __nv_bfloat16* src,
                                          const __nv_bfloat16* any, bool valid, int left,
                                          int vec) {
  if (vec == 16) {
    if (left > 0) cp_async16(dst, valid ? src : any, valid);
  } else if (vec == 8) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (4 * q < left) cp_async8(dst + 8 * q, valid ? src + 4 * q : any, valid);
  } else if (vec == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (2 * q < left) cp_async4(dst + 4 * q, valid ? src + 2 * q : any, valid);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = valid && 2 * q < left ? __ldg(s + 2 * q) : 0u;
      const uint32_t hi = valid && 2 * q + 1 < left ? __ldg(s + 2 * q + 1) : 0u;
      v[q] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst_ptr) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS) s2_wgrad_narrow(const Args a) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // block -> (n tile, chunk), n tile fastest; blockIdx.y = split
  const int nt = blockIdx.x % a.n_tiles, c = blockIdx.x / a.n_tiles;
  const int seg0 = blockIdx.y * a.per_split;
  const int steps = min(a.per_split, a.segments - seg0);

  const int sw = a.sw, k_seg = a.lines * sw, pitch = 2 * sw + 1;
  const int line_rows = 9 * pitch;                 // staged x rows of one output line
  const int x_rows = a.lines * line_rows, g_rows = NT * k_seg;
  const int stage_bytes = (x_rows + g_rows) * 16;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t zero_row = sbase + STAGES * stage_bytes;
  // the stages and the zero row cleared once: the copies past Cin (Cout)
  // are never issued
  for (int i = tid; i < STAGES * stage_bytes / 16 + 1; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int total_lines = a.n * a.do_ * a.ho;
  const int ch_left = a.cin - c * CC;
  auto load_segment = [&](int seg, int slot) {
    const int lb = seg / a.ow_blocks, om = seg - lb * a.ow_blocks;
    const uint32_t xs = sbase + slot * stage_bytes;
    uint8_t* const xs_ptr = smem + slot * stage_bytes;
    // a warp stages one input line segment (line li, (kd, kh) = kk) at a
    // time, a lane every 32nd of its rows
    for (int arr = warp; arr < a.lines * 9; arr += WARPS) {
      const int li = arr / 9, kk = arr - li * 9;
      const int line = lb * a.lines + li;
      const int oh = line % a.ho, t = line / a.ho;
      const int od = t % a.do_, nn = t / a.do_;
      const int iz = 2 * od + kk / 3 - a.pad_lo, iy = 2 * oh + kk % 3 - 1;
      const bool line_ok = line < total_lines && iz >= 0 && iz < a.d && iy >= 0 && iy < a.h;
      const __nv_bfloat16* const base =
          line_ok ? a.x + ((static_cast<long long>(nn) * a.d + iz) * a.h + iy) *
                              static_cast<long long>(a.w_) * a.cin + c * CC
                  : a.x;
      const int iw0 = 2 * om * sw - 1;
      const uint32_t dst = xs + arr * pitch * 16;
      uint8_t* const dst_ptr = xs_ptr + arr * pitch * 16;
      for (int row = lane; row < pitch; row += 32) {
        const int iw = iw0 + (row <= sw ? 2 * row : 2 * (row - sw) - 1);
        const bool valid = line_ok && iw >= 0 && iw < a.w_;
        stage_row(dst + row * 16, dst_ptr + row * 16,
                  valid ? base + static_cast<long long>(iw) * a.cin : a.x, a.x, valid,
                  ch_left, a.x_vec);
      }
    }
    const uint32_t gs = xs + x_rows * 16;
    uint8_t* const gs_ptr = xs_ptr + x_rows * 16;
    for (int r = tid; r < g_rows; r += THREADS) {
      const int j = r / k_seg, kk = r - j * k_seg;
      const int li = kk / sw, ow = om * sw + (kk - li * sw);
      const int line = lb * a.lines + li, co = nt * BN + j * 8;
      const bool valid = line < total_lines && ow < a.wo;
      const __nv_bfloat16* src =
          valid ? a.g + (static_cast<long long>(line) * a.wo + ow) * a.cout + co : a.g;
      stage_row(gs + r * 16, gs_ptr + r * 16, src, a.g, valid, a.cout - co, a.g_vec);
    }
  };

  // this lane's A rows: m16 tile mt = 2 warp + i holds taps 2 mt (rows 0-7)
  // and 2 mt + 1 (rows 8-15); lane l gives the address of row l % 8 of
  // matrix l / 8: tap 2 mt + (l / 8) % 2, voxel (l / 16) * 8 + l % 8 of the
  // k16 step. tap_row: the tap's staged row at voxel 0 of line 0, or -1
  // (the 28th tap: the zero row)
  int tap_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tap = 2 * (2 * warp + i) + ((lane >> 3) & 1);
    const int kw = tap % 3;
    tap_row[i] = tap < TAPS ? (tap / 3) * pitch + (kw == 0 ? 0 : kw == 1 ? sw + 1 : 1) : -1;
  }
  const int lane_k = (lane >> 4) * 8 + (lane & 7);

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int p = 0; p < LEAD; ++p) {
    if (p < steps) load_segment(seg0 + p, p);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<LEAD - 1>();  // this thread's copies of segment s landed
    __syncthreads();            // everyone's; segment s - 1's products are done
    if (s + LEAD < steps) load_segment(seg0 + s + LEAD, (s + LEAD) % STAGES);
    cp_async_commit();
    const uint32_t xs = sbase + (s % STAGES) * stage_bytes;
    const uint32_t gs = xs + x_rows * 16;
    for (int li = 0; li < a.lines; ++li)
#pragma unroll 2
    for (int ow0 = 0; ow0 < sw; ow0 += 16) {  // a k16 step lies on one line
      const int k0 = li * sw + ow0;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t addr =
            tap_row[i] < 0 ? zero_row
                           : xs + (li * line_rows + tap_row[i] + ow0 + lane_k) * 16;
        ldmatrix_x4_trans(addr, af[i]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(gs + (j * k_seg + k0 + (lane & 15)) * 16, b0, b1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16816(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // acc[i][j][e]: row g + 8 (e / 2) of m16 tile 2 warp + i (tap 2 mt + (e /
  // 2), channel c * 8 + g), column 8 j + 2 (lane % 4) + e % 2 of the N tile
  float* const out = a.out + static_cast<long long>(blockIdx.y) * TAPS * a.cin * a.cout;
  const int gq = lane >> 2, tq = lane & 3, ci = c * CC + gq;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tap = 2 * (2 * warp + i) + (e >> 1);
        const int co = nt * BN + 8 * j + 2 * tq + (e & 1);
        if (tap < TAPS && ci < a.cin && co < a.cout)
          out[(static_cast<long long>(tap) * a.cin + ci) * a.cout + co] = acc[i][j][e];
      }
}

// out[i] = sum over s of part[s][i], s in order; the loads of BATCH splits
// are issued before their adds (the adds keep the order)
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, long long mn, int splits) {
  constexpr int BATCH = 16;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    int p = 0;
    for (; p + BATCH <= splits; p += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int e = 0; e < BATCH; ++e) v[e] = part[(p + e) * mn + i];
#pragma unroll
      for (int e = 0; e < BATCH; ++e) s += v[e];
    }
    for (; p < splits; ++p) s += part[p * mn + i];
    out[i] = s;
  }
}

template <int NT>
cudaError_t launch(Args a, int splits, float* part, float* dw, cudaStream_t stream) {
  auto kernel = s2_wgrad_narrow<NT>;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int k_seg = a.lines * a.sw;
  const int smem = STAGES * (a.lines * 9 * (2 * a.sw + 1) + NT * k_seg) * 16 + 16;
  if (a.n_tiles != (a.cout + 8 * NT - 1) / (8 * NT) || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(a.chunks) * a.n_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  a.out = splits == 1 ? dw : part;
  kernel<<<dim3(static_cast<unsigned>(tiles), splits), THREADS, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return unet3d_s2_wgrad_sum_splits(part, dw, 27LL * a.cin * a.cout, splits, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// the widest copy, in bytes, that rows of `channels` bf16 values at `p` allow
int copy_bytes(const void* p, int channels) {
  if (channels % 8 == 0 && aligned(p, 16)) return 16;
  if (channels % 4 == 0 && aligned(p, 8)) return 8;
  if (channels % 2 == 0 && aligned(p, 4)) return 4;
  return 2;
}

}  // namespace

cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream) {
  const long long blocks = (mn + 127) / 128 < 8192 ? (mn + 127) / 128 : 8192;
  sum_splits<<<static_cast<unsigned>(blocks), 128, 0, stream>>>(part, dw, mn, splits);
  return cudaGetLastError();
}

// The plan of s2_wgrad_kernel.narrow_plan: nt n8 tiles of output channels a
// block (1 to 4), n_tiles of 8 nt channels, chunks of 8 input channels, sw
// output voxels per line in a segment (a multiple of 16, at most 128), lines
// per segment (lines * sw at most 128), segments in all, splits of per_split
// segments. x (N, D, H, W, Cin), g (N, Do, Ho, Wo, Cout) bf16, 2-byte
// aligned, any Cin and Cout; dw (3, 3, 3, Cin, Cout) f32; part an f32
// (splits, 27 * Cin, Cout) scratch when splits > 1. Returns
// cudaErrorInvalidValue for a plan that does not match the shape, else the
// cudaError_t of the launches (0 on success). pad_lo is the zero planes
// below x on D: 1 for the SAME conv, 0 for a D slab whose first plane is the
// one below it (the D-halo mode).
extern "C" int unet3d_s2_wgrad_narrow(int nt, const void* x, const void* g, float* part,
                                      float* dw, int n, int d, int h, int w_, int cin, int do_,
                                      int ho, int wo, int cout, int n_tiles, int chunks, int sw,
                                      int lines, int segments, int splits, int per_split,
                                      int pad_lo, void* stream) {
  const long long total_lines = static_cast<long long>(n) * do_ * ho;
  const long long ow_blocks = sw > 0 ? (wo + sw - 1) / sw : 0;
  if (cin < 1 || cout < 1 || !aligned(x, 2) || !aligned(g, 2) || !aligned(dw, 4) ||
      pad_lo < 0 || pad_lo > 1 || do_ != (d + pad_lo) / 2 || ho != (h + 1) / 2 ||
      wo != (w_ + 1) / 2 || sw < 16 || sw % 16 != 0 || sw > MAX_SW || lines < 1 ||
      lines * sw > MAX_K || chunks != (cin + CC - 1) / CC ||
      segments != (total_lines + lines - 1) / lines * ow_blocks || splits < 1 ||
      splits > 65535 || per_split < 1 ||
      static_cast<long long>(splits - 1) * per_split >= segments ||
      static_cast<long long>(splits) * per_split < segments || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), nullptr,
         n, d, h, w_, cin, do_, ho, wo, cout, pad_lo, n_tiles, chunks, sw, lines,
         static_cast<int>(ow_blocks), segments, per_split, copy_bytes(x, cin),
         copy_bytes(g, cout)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch<1>(a, splits, part, dw, s);
    case 2: return launch<2>(a, splits, part, dw, s);
    case 3: return launch<3>(a, splits, part, dw, s);
    case 4: return launch<4>(a, splits, part, dw, s);
    default: return cudaErrorInvalidValue;
  }
}
