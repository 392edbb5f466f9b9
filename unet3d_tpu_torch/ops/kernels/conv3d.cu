// 3x3x3 stride-1 SAME convolution over NDHWC activations and DHWIO weights,
// written for Hopper (sm_90a), with two optional fusions. One template,
// conv3x3x3_ndhwc<T, PROLOGUE, STATS>, gives the three variants the DynUNet
// forward runs:
//
//   conv         y = conv(x, w)
//                replaces unet3d_tpu/ops/pallas/conv3d_kernel.py
//                (_conv_kernel / _conv_batched / pallas_conv3d).
//   conv_stats   y = conv(x, w) plus per-(n, cout) f32 sum(y) and sum(y^2) of y
//                as rounded to T: the instance-norm statistics. Replaces the
//                stats epilogue of unet3d_tpu/ops/pallas/winograd_kernel.py
//                (_kernel_with_stats / _winograd_batched_stats), here on the
//                direct conv rather than on Winograd.
//   block_stats  y = conv(lrelu(x * inv[n, c] + shift[n, c], alpha), w) plus the
//                same statistics. Replaces unet3d_tpu/ops/pallas/block_kernel.py
//                (_block_kernel / pallas_block_conv3d), with the affine per
//                (item, channel) because instance-norm statistics are per item.
//
// Form: a direct implicit GEMM. M = N*D*H*W output voxels, N = Cout,
// K = 27*Cin ordered (tap, cin), which is the row order of the DHWIO weight
// viewed as a (27*Cin, Cout) matrix. A block owns a BM x BN output tile and
// walks K in BK-deep stages; each stage gathers the A tile (BM voxels, each
// shifted by its tap, zero outside the volume) and the B tile (weight rows)
// into shared memory. Any Cin, Cout, D, H and W are taken: ragged edges are
// masked, and 16-byte loads are used where Cin (for A) or Cout (for B) is a
// multiple of 8 and the pointer is aligned.
//
// bf16 multiplies on the tensor cores through WMMA 16x16x16 with f32
// accumulation; f32 multiplies with FMA on the CUDA cores (TF32 would not
// reproduce the f32 reference). Both round once, at the store.
//
// PROLOGUE applies z = lrelu(x * inv + shift) in f32 to every staged element,
// then zeroes it where the source voxel lies outside the volume (SAME padding
// pads z, not x: lrelu(shift) != 0), then rounds it to T before the multiply.
//
// STATS reduces the stored (rounded) outputs of the tile per (item, channel)
// through shared memory and adds them into an (N, 2, Cout) f32 buffer that the
// caller zeroes, with atomicAdd. The order of those adds changes from run to
// run, so the statistics agree with a sequential sum only to f32 rounding.
//
// What bounds it: the level-0 conv2 of the BraTS DynUNet (128^3, 64 -> 64) is
// 2 * 128^3 * 27 * 64 * 64 = 0.46 TFLOP per call over ~0.5 GB of bf16
// activations, so it is compute-bound on this card. This first form stages
// through shared memory with no overlap of loads and math and uses mma.sync
// tiles, so it stays far from the tensor-core peak; wgmma, TMA and a
// multistage pipeline are left for later work.
//
// Built by nvcc into a shared library with a plain C interface
// (unet3d_tpu_torch/kernels/build.py) and called through ctypes with PyTorch's
// pointers and current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128;      // output voxels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K depth per stage
constexpr int THREADS = 256;
constexpr int GROUP = 8;     // consecutive elements one thread moves per load

struct ConvArgs {
  const void* x;        // (N, D, H, W, Cin)
  const void* w;        // (3, 3, 3, Cin, Cout) == (27 * Cin, Cout)
  void* y;              // (N, D, H, W, Cout)
  const float* inv;     // (N, Cin), PROLOGUE only
  const float* shift;   // (N, Cin), PROLOGUE only
  float* stats;         // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;
  float alpha;
  int vec_x, vec_w;     // 16-byte loads allowed for A / B groups
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory row padding: bf16 rows stay 16-byte aligned for WMMA loads;
// f32 A rows are padded by one word so the FMA loop's column reads spread
// over banks, and f32 B rows stay float4-aligned.
template <typename T> struct Pad { static constexpr int A = 8, B = 8; };
template <> struct Pad<float> { static constexpr int A = 1, B = 4; };

template <typename T>
__device__ __forceinline__ void load_group(const T* p, T (&v)[GROUP]) {
  constexpr int kVecs = GROUP * sizeof(T) / sizeof(uint4);
  const uint4* src = reinterpret_cast<const uint4*>(p);
  uint4* dst = reinterpret_cast<uint4*>(v);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ bool inside(const ConvArgs& a, int z, int y, int x) {
  return z >= 0 && z < a.d && y >= 0 && y < a.h && x >= 0 && x < a.w_;
}

__device__ __forceinline__ long long voxel(const ConvArgs& a, int n, int z,
                                           int y, int x) {
  return ((static_cast<long long>(n) * a.d + z) * a.h + y) * a.w_ + x;
}

__device__ __forceinline__ float prologue(const ConvArgs& a, float v, int n,
                                          int c) {
  const int i = n * a.cin + c;
  v = v * a.inv[i] + a.shift[i];
  return v >= 0.f ? v : v * a.alpha;
}

// A group: GROUP consecutive k of one output voxel (n, z, y, x), as T.
template <typename T, bool PROLOGUE>
__device__ __forceinline__ void load_a(const ConvArgs& a, int k, int n, int z,
                                       int y, int x, bool row_ok,
                                       T (&v)[GROUP]) {
  const T* xp = static_cast<const T*>(a.x);
  const int K = 27 * a.cin;
  if (a.vec_x && row_ok && k < K) {
    // Cin % GROUP == 0: the group lies in one tap, on contiguous channels
    const int tap = k / a.cin, c = k - tap * a.cin;
    const int iz = z + tap / 9 - 1, iy = y + (tap / 3) % 3 - 1,
              ix = x + tap % 3 - 1;
    if (inside(a, iz, iy, ix)) {
      load_group(xp + voxel(a, n, iz, iy, ix) * a.cin + c, v);
      if (PROLOGUE) {
#pragma unroll
        for (int e = 0; e < GROUP; ++e)
          v[e] = from_float<T>(prologue(a, to_float(v[e]), n, c + e));
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < GROUP; ++e) v[e] = from_float<T>(0.f);
    return;
  }
#pragma unroll
  for (int e = 0; e < GROUP; ++e) {
    const int ke = k + e;
    float val = 0.f;
    if (row_ok && ke < K) {
      const int tap = ke / a.cin, c = ke - tap * a.cin;
      const int iz = z + tap / 9 - 1, iy = y + (tap / 3) % 3 - 1,
                ix = x + tap % 3 - 1;
      if (inside(a, iz, iy, ix)) {
        val = to_float(xp[voxel(a, n, iz, iy, ix) * a.cin + c]);
        if (PROLOGUE) val = prologue(a, val, n, c);
      }
    }
    v[e] = from_float<T>(val);
  }
}

// B group: GROUP consecutive output channels of weight row k.
template <typename T>
__device__ __forceinline__ void load_b(const ConvArgs& a, int k, int co,
                                       T (&v)[GROUP]) {
  const T* wp = static_cast<const T*>(a.w);
  const int K = 27 * a.cin;
  if (a.vec_w && k < K && co < a.cout) {
    load_group(wp + static_cast<long long>(k) * a.cout + co, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < GROUP; ++e)
    v[e] = (k < K && co + e < a.cout)
               ? wp[static_cast<long long>(k) * a.cout + co + e]
               : from_float<T>(0.f);
}

template <typename T, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(THREADS) conv3x3x3_ndhwc(const ConvArgs a) {
  using namespace nvcuda;
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDA = BK + Pad<T>::A;
  constexpr int LDB = BN + Pad<T>::B;
  constexpr int LDC = BN + 4;
  constexpr int kABytes = BM * LDA * sizeof(T);
  constexpr int kBBytes = BK * LDB * sizeof(T);
  constexpr int kCBytes = BM * LDC * sizeof(float);
  constexpr int kSmem =
      kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes;
  static_assert(kABytes % 32 == 0, "B tile must stay 32-byte aligned");
  // the C tile reuses the A/B stage buffers after the K loop
  __shared__ __align__(128) unsigned char smem[kSmem];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kABytes);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long dhw = static_cast<long long>(a.d) * a.h * a.w_;
  const long long M = a.n * dhw;
  const int K = 27 * a.cin;
  const int n_tiles = (a.cout + BN - 1) / BN;
  // channel tiles of one voxel tile are neighbours in launch order, so they
  // find its input in L2
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int co0 = (blockIdx.x % n_tiles) * BN;

  // the A rows this thread stages, decoded once
  constexpr int kGroupsPerRow = BK / GROUP;
  constexpr int kRowStep = THREADS / kGroupsPerRow;
  constexpr int kAIters = BM / kRowStep;
  const int a_kg = (tid % kGroupsPerRow) * GROUP;
  int a_n[kAIters], a_z[kAIters], a_y[kAIters], a_x[kAIters];
  bool a_ok[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const long long m = m0 + tid / kGroupsPerRow + i * kRowStep;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    a_n[i] = static_cast<int>(mm / dhw);
    const long long r = mm - a_n[i] * dhw;
    a_z[i] = static_cast<int>(r / (a.h * a.w_));
    a_y[i] = static_cast<int>((r / a.w_) % a.h);
    a_x[i] = static_cast<int>(r % a.w_);
  }
  static_assert(BK * BN == THREADS * GROUP, "one B group per thread");
  const int b_row = tid / (BN / GROUP);
  const int b_col = (tid % (BN / GROUP)) * GROUP;

  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;  // 4 x 2 warps
  const int tx = tid % 16, ty = tid / 16;                   // 16 x 16 threads
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
  float acc[8][4];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      alignas(16) T v[GROUP];
      load_a<T, PROLOGUE>(a, k0 + a_kg, a_n[i], a_z[i], a_y[i], a_x[i],
                          a_ok[i], v);
      T* dst = As + (tid / kGroupsPerRow + i * kRowStep) * LDA + a_kg;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) dst[e] = v[e];
    }
    {
      alignas(16) T v[GROUP];
      load_b(a, k0 + b_row, co0 + b_col, v);
      T* dst = Bs + b_row * LDB + b_col;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) dst[e] = v[e];
    }
    __syncthreads();
    if constexpr (kTensorCores) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(cf[i][j], fa[i], fb[j], cf[i][j]);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_float(As[(ty * 8 + i) * LDA + kk]);
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + kk * LDB + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] += av[i] * bv.x;
          acc[i][1] += av[i] * bv.y;
          acc[i][2] += av[i] * bv.z;
          acc[i][3] += av[i] * bv.w;
        }
      }
    }
    __syncthreads();
  }

  // accumulators -> C tile in shared memory (the loop ended on a barrier)
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                cf[i][j], LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * LDC + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();

  // store: consecutive threads write consecutive channels of one voxel
  T* yp = static_cast<T*>(a.y);
  constexpr int kRows = THREADS / BN;
  const int col = tid % BN, r0 = tid / BN, co = co0 + col;
  for (int r = r0; r < BM; r += kRows) {
    const long long m = m0 + r;
    if (m < M && co < a.cout) yp[m * a.cout + co] = from_float<T>(Cs[r * LDC + col]);
  }

  if constexpr (STATS) {
    // one pass per batch item the tile touches (a tile may straddle items)
    __shared__ float red[2][kRows][BN];
    const long long m_end = m0 + BM < M ? m0 + BM : M;
    const int n_first = static_cast<int>(m0 / dhw);
    const int n_last = static_cast<int>((m_end - 1) / dhw);
    for (int nn = n_first; nn <= n_last; ++nn) {
      const long long lo = nn * dhw > m0 ? nn * dhw : m0;
      const long long hi = (nn + 1) * dhw < m_end ? (nn + 1) * dhw : m_end;
      float s1 = 0.f, s2 = 0.f;
      for (int r = r0; r < BM; r += kRows) {
        const long long m = m0 + r;
        if (m >= lo && m < hi) {
          const float v = to_float(from_float<T>(Cs[r * LDC + col]));
          s1 += v;
          s2 += v * v;
        }
      }
      red[0][r0][col] = s1;
      red[1][r0][col] = s2;
      __syncthreads();
      if (tid < BN && co < a.cout) {
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          t1 += red[0][q][tid];
          t2 += red[1][q][tid];
        }
        atomicAdd(a.stats + (2LL * nn) * a.cout + co, t1);
        atomicAdd(a.stats + (2LL * nn + 1) * a.cout + co, t2);
      }
      __syncthreads();
    }
  }
}

template <typename T, bool PROLOGUE, bool STATS>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const long long m = static_cast<long long>(a.n) * a.d * a.h * a.w_;
  const long long blocks = (m + BM - 1) / BM * ((a.cout + BN - 1) / BN);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  conv3x3x3_ndhwc<T, PROLOGUE, STATS>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const ConvArgs& a, cudaStream_t stream) {
  switch (variant) {
    case 0: return launch<T, false, false>(a, stream);
    case 1: return launch<T, false, true>(a, stream);
    case 2: return launch<T, true, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = conv, 1 = conv_stats,
// 2 = block_stats. Returns the cudaError_t of the launch (0 on success).
extern "C" int unet3d_conv3x3x3_ndhwc(int dtype, int variant, const void* x,
                                      const void* w, void* y, const float* inv,
                                      const float* shift, float* stats, int n,
                                      int d, int h, int w_, int cin, int cout,
                                      float alpha, void* stream) {
  ConvArgs a{x, w, y, inv, shift, stats, n, d, h, w_, cin, cout, alpha,
             cin % GROUP == 0 && aligned16(x), cout % GROUP == 0 && aligned16(w)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(variant, a, s);
    case 1: return dispatch<__nv_bfloat16>(variant, a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* unet3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
