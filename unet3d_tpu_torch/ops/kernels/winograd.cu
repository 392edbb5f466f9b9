// Winograd-DH 3x3x3 stride-1 SAME convolution over NDHWC bf16 activations,
// for the bf16 calls the Hopper form (winograd_wgmma.cu) does not take: Cin
// or Cout not a multiple of 8, or an unaligned x, which no DynUNet site has.
// Winograd F(2,3) x F(2,3) on the D and H axes and a direct 3-tap W axis.
// One template, winograd3x3x3_ndhwc<STATS>, gives two variants:
//
//   winograd        y = conv(x, w). Replaces
//                   unet3d_tpu/ops/pallas/winograd_kernel.py
//                   (_kernel / _winograd_batched, the pallas_call at :229).
//   winograd_stats  y plus per-(n, cout) f32 sum(y) and sum(y^2) of y as
//                   rounded to bf16. Replaces _kernel_with_stats /
//                   _winograd_batched_stats (the pallas_call at :274).
//
// Math. Output rows (2t, 2t+1) in D and (2s, 2s+1) in H of one column come
// from the 4 x 4 padded input rows 2t..2t+3 x 2s..2s+3. The input is
// transformed by B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] over D and
// then over H, rounded to bf16 after each (as the Pallas kernel does);
// each of the 4 x 4 x 3 (jd, jh, dx) points is one channel contraction with
// the pre-transformed weight U2 = G w G^T over (dz, dy), (48, Cp, Cop) in bf16,
// zero-padded by the caller to BK | Cp and BN | Cop; the inverse transform
// A^T = [[1,1,1,0],[0,1,-1,-1]] is linear, so each (jd, jh) product of a
// channel chunk is folded at once, with its sign, into the four (od, oh)
// f32 output accumulators (four, not sixteen). One rounding at the store.
//
// Blocks. A block owns one item, one depth tile (2 output rows), BHT H tiles
// (2 rows each), BW columns and BN output channels: BM = BHT * BW output
// positions per (od, oh). Blocks run in any order and share nothing: each
// computes its own offsets from blockIdx, stages its 4-row D window with the
// H and W halos itself (zero outside the volume: the SAME padding), and adds
// its statistics into an (N, 2, Cout) f32 buffer that the caller zeroes, with
// atomicAdd (so they agree with a sequential sum only to f32 rounding). None
// of the Pallas kernel's TPU devices (batch folded into depth rows, the input
// passed four times as halo blocks, a stats block revisited across sequential
// grid steps) carries over. Any W; D and H even (the caller checks).
//
// This is the one bf16 form not yet redesigned for Hopper (the f32 calls
// take winograd_tf32x3.cu). It multiplies through WMMA 16x16x16 with f32
// accumulation: it stages each channel chunk's input window once and then,
// for each of the 16 (jd, jh) points, transforms it and stages U2's three dx
// slices through shared memory between barriers, with no overlap of loads
// and math.
//
// Built by nvcc into the port's shared library with a plain C interface
// (unet3d_tpu_torch/kernels/build.py) and called through ctypes with PyTorch's
// pointers and current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BHT = 4;             // H tiles (2 output rows each) per block
constexpr int BW = 16;             // output columns per block
constexpr int BM = BHT * BW;       // output positions per (od, oh)
constexpr int BN = 64;             // output channels per block
constexpr int THREADS = 256;
constexpr int RAW_H = 2 * BHT + 2;  // input rows of the H window
constexpr int RAW_W = BW + 2;       // input columns of the W window

// BK: channels per chunk. LDV / LDU: row strides of the transformed input
// and of the U2 slices in shared memory (WMMA needs 32-byte aligned
// fragment rows).
constexpr int BK = 16, LDV = 16, LDU = BN + 8;
using T = __nv_bfloat16;

struct WinoArgs {
  const void* x;   // (N, D, H, W, C)
  const void* u2;  // (48, Cp, Cop), row (jd * 4 + jh) * 3 + dx
  void* y;         // (N, D, H, W, Cout)
  float* stats;    // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, c, cout, cp, cop;
  int vec_x;       // 16-byte loads of x allowed
};

__device__ __forceinline__ float to_float(T v) { return __bfloat162float(v); }
__device__ __forceinline__ T from_float(float v) { return __float2bfloat16(v); }

// Transform point j of B^T: r[a] + s * r[b]
__device__ __forceinline__ void bt_row(int j, int& a, int& b, float& s) {
  switch (j) {
    case 0: a = 0; b = 2; s = -1.f; break;
    case 1: a = 1; b = 2; s = 1.f; break;
    case 2: a = 2; b = 1; s = -1.f; break;
    default: a = 1; b = 3; s = -1.f; break;
  }
}

// A^T[o][j]
__device__ __forceinline__ float at_coef(int o, int j) {
  if (o == 0) return j == 3 ? 0.f : 1.f;
  return j == 0 ? 0.f : (j == 1 ? 1.f : -1.f);
}

template <bool STATS>
__global__ void __launch_bounds__(THREADS) winograd3x3x3_ndhwc(const WinoArgs a) {
  using namespace nvcuda;
  constexpr int LDC = BN + 4;
  constexpr int G = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kRawBytes = 4 * RAW_H * RAW_W * BK * sizeof(T);
  constexpr int kVBytes = BHT * RAW_W * LDV * sizeof(T);
  constexpr int kUBytes = 3 * BK * LDU * sizeof(T);
  constexpr int kCBytes = BM * LDC * sizeof(float);
  static_assert(kCBytes <= kRawBytes, "the C tile reuses the raw window");
  static_assert(kRawBytes % 32 == 0 && kVBytes % 32 == 0,
                "V and U must stay 32-byte aligned");
  static_assert(BK % G == 0 && BN % G == 0, "whole 16-byte groups");
  __shared__ __align__(128) unsigned char smem[kRawBytes + kVBytes + kUBytes];
  T* raw = reinterpret_cast<T*>(smem);                        // [4][RAW_H][RAW_W][BK]
  T* Vs = reinterpret_cast<T*>(smem + kRawBytes);             // [BHT][RAW_W][LDV]
  T* Us = reinterpret_cast<T*>(smem + kRawBytes + kVBytes);   // [3 * BK][LDU]
  float* Cs = reinterpret_cast<float*>(smem);                 // [BM][LDC]

  const int tid = threadIdx.x;
  // block -> (item, depth tile, H tile group, W tile, channel tile); channel
  // tiles of one window are neighbours in launch order, so they share it in L2
  const int n_co = a.cop / BN, n_w = (a.w_ + BW - 1) / BW;
  const int n_h = (a.h / 2 + BHT - 1) / BHT, n_d = a.d / 2;
  long long b = blockIdx.x;
  const int co0 = static_cast<int>(b % n_co) * BN;
  b /= n_co;
  const int w0 = static_cast<int>(b % n_w) * BW;
  b /= n_w;
  const int th0 = static_cast<int>(b % n_h) * BHT;
  b /= n_h;
  const int td = static_cast<int>(b % n_d);
  const int nn = static_cast<int>(b / n_d);

  const int warp = tid / 32;
  const int wm = warp / 2;            // the warp's H tile: A rows = its BW columns
  const int wn = (warp % 2) * 32;     // the warp's two 16-channel fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2][2], part[2];
#pragma unroll
  for (int od = 0; od < 2; ++od)
#pragma unroll
    for (int oh = 0; oh < 2; ++oh)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[od][oh][j], 0.f);

  const T* xp = static_cast<const T*>(a.x);
  const T* up = static_cast<const T*>(a.u2);
  constexpr int kRawGroups = 4 * RAW_H * RAW_W * (BK / G);
  constexpr int kUGroups = 3 * BK * (BN / G);

  for (int c0 = 0; c0 < a.cp; c0 += BK) {
    // the input window of this channel chunk: D rows 2td-1 .. 2td+2, H rows
    // 2th0-1 .. 2th0+2BHT, W columns w0-1 .. w0+BW; zero outside the volume
    for (int g = tid; g < kRawGroups; g += THREADS) {
      const int kg = (g % (BK / G)) * G;
      int r = g / (BK / G);
      const int wr = r % RAW_W;
      r /= RAW_W;
      const int hr = r % RAW_H, dz = r / RAW_H;
      const int iz = 2 * td - 1 + dz, iy = 2 * th0 - 1 + hr, ix = w0 - 1 + wr;
      const bool in = iz >= 0 && iz < a.d && iy >= 0 && iy < a.h && ix >= 0 &&
                      ix < a.w_;
      const long long base =
          in ? (((static_cast<long long>(nn) * a.d + iz) * a.h + iy) * a.w_ + ix) *
                   a.c
             : 0;
      const int c = c0 + kg;
      T* dst = raw + ((dz * RAW_H + hr) * RAW_W + wr) * BK + kg;
      if (in && a.vec_x && c + G <= a.c) {
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(xp + base + c));
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          dst[e] = (in && c + e < a.c) ? xp[base + c + e] : from_float(0.f);
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int jd = 0; jd < 4; ++jd) {
#pragma unroll 1
      for (int jh = 0; jh < 4; ++jh) {
        // V = B^T_H (B^T_D x) at (jd, jh), rounded to T after each transform
        int da, db, ha, hb;
        float ds, hs;
        bt_row(jd, da, db, ds);
        bt_row(jh, ha, hb, hs);
        for (int e = tid; e < BHT * RAW_W * BK; e += THREADS) {
          const int k = e % BK, wr = (e / BK) % RAW_W, t = e / (BK * RAW_W);
          const int h1 = 2 * t + ha, h2 = 2 * t + hb;
          const T* col = raw + wr * BK + k;
          const float v1 = to_float(from_float(
              to_float(col[(da * RAW_H + h1) * RAW_W * BK]) +
              ds * to_float(col[(db * RAW_H + h1) * RAW_W * BK])));
          const float v2 = to_float(from_float(
              to_float(col[(da * RAW_H + h2) * RAW_W * BK]) +
              ds * to_float(col[(db * RAW_H + h2) * RAW_W * BK])));
          Vs[(t * RAW_W + wr) * LDV + k] = from_float(v1 + hs * v2);
        }
        // U2 rows (jd, jh, dx = 0..2) of this channel chunk and channel tile
        const long long u_row = static_cast<long long>((jd * 4 + jh) * 3) * a.cp + c0;
        for (int g = tid; g < kUGroups; g += THREADS) {
          const int col = (g % (BN / G)) * G, row = g / (BN / G);
          const int dx = row / BK, k = row % BK;
          const T* src = up + (u_row + static_cast<long long>(dx) * a.cp + k) * a.cop +
                         co0 + col;
          *reinterpret_cast<uint4*>(Us + row * LDU + col) =
              __ldg(reinterpret_cast<const uint4*>(src));
        }
        __syncthreads();

        wmma::fill_fragment(part[0], 0.f);
        wmma::fill_fragment(part[1], 0.f);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(fa, Vs + (wm * RAW_W + dx) * LDV, LDV);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fb, Us + dx * BK * LDU + wn + j * 16, LDU);
            wmma::mma_sync(part[j], fa, fb, part[j]);
          }
        }
#pragma unroll
        for (int od = 0; od < 2; ++od)
#pragma unroll
          for (int oh = 0; oh < 2; ++oh) {
            const float s = at_coef(od, jd) * at_coef(oh, jh);
            if (s != 0.f) {
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < part[j].num_elements; ++i)
                  acc[od][oh][j].x[i] += s * part[j].x[i];
            }
          }
        __syncthreads();
      }
    }
  }

  // store each (od, oh) phase through the C tile (the loop ended on a barrier)
  T* yp = static_cast<T*>(a.y);
  constexpr int kRows = THREADS / BN;
  const int col = tid % BN, r0 = tid / BN, co = co0 + col;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int od = 0; od < 2; ++od) {
#pragma unroll
    for (int oh = 0; oh < 2; ++oh) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn + j * 16, acc[od][oh][j],
                                LDC, wmma::mem_row_major);
      __syncthreads();
      const int oz = 2 * td + od;
      for (int r = r0; r < BM; r += kRows) {
        const int oy = 2 * (th0 + r / BW) + oh, ox = w0 + r % BW;
        if (oy < a.h && ox < a.w_ && co < a.cout) {
          const T v = from_float(Cs[r * LDC + col]);
          const long long vox =
              ((static_cast<long long>(nn) * a.d + oz) * a.h + oy) * a.w_ + ox;
          yp[vox * a.cout + co] = v;
          if (STATS) {
            const float f = to_float(v);
            s1 += f;
            s2 += f * f;
          }
        }
      }
      __syncthreads();
    }
  }

  if constexpr (STATS) {
    __shared__ float red[2][kRows][BN];
    red[0][r0][col] = s1;
    red[1][r0][col] = s2;
    __syncthreads();
    if (tid < BN && co0 + tid < a.cout) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        t1 += red[0][q][tid];
        t2 += red[1][q][tid];
      }
      atomicAdd(a.stats + (2LL * nn) * a.cout + co0 + tid, t1);
      atomicAdd(a.stats + (2LL * nn + 1) * a.cout + co0 + tid, t2);
    }
  }
}

template <bool STATS>
cudaError_t launch(const WinoArgs& a, cudaStream_t stream) {
  if (a.d % 2 || a.h % 2 || a.cp % BK || a.cop % BN || a.cp < a.c ||
      a.cop < a.cout)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(a.n) * (a.d / 2) *
                           ((a.h / 2 + BHT - 1) / BHT) * ((a.w_ + BW - 1) / BW) *
                           (a.cop / BN);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  winograd3x3x3_ndhwc<STATS>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// stats: 0 = winograd, 1 = winograd_stats. x bf16; u2 is the (48, cp, cop)
// bf16 transformed weight, zero beyond (cin, cout); cp a multiple of 16 and
// cop of 64. Returns the cudaError_t of the launch (0 on success).
extern "C" int unet3d_winograd3x3x3_ndhwc(int stats, const void* x, const void* u2,
                                          void* y, float* stats_buf, int n, int d,
                                          int h, int w_, int cin, int cout, int cp,
                                          int cop, void* stream) {
  WinoArgs a{x, u2, y, stats_buf, n, d, h, w_, cin, cout, cp, cop,
             cin % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stats ? launch<true>(a, s) : launch<false>(a, s);
}
