// Weight gradient of the 3x3x3 stride-2 convolution with symmetric pads of 1
// (NDHWC bf16 activations, DHWIO weights), written for Hopper (sm_90a), for
// the channel counts the wgmma form does not take:
//
//   dw[kd, kh, kw, ci, co] = sum_{n, od, oh, ow}
//       xp[n, 2od + kd, 2oh + kh, 2ow + kw, ci] * g[n, od, oh, ow, co]
//
// with xp the input padded by one voxel of zeros on every side (on D, by
// pad_lo below: 0 in the D-halo mode, where x's first plane is the slab's
// neighbour below). Replaces
// unet3d_tpu/ops/pallas/s2_wgrad_kernel.py (_wgrad_kernel / s2_wgrad_pallas).
//
// Form: a GEMM with M = 27 * Cin rows ordered (tap, ci), which is the row
// order of the DHWIO weight viewed as a (27 * Cin, Cout) matrix, N = Cout
// columns, and K = N * Do * Ho * Wo output voxels. A block owns a BM x BN tile
// of dw and walks its share of K in BK-voxel stages. Each stage gathers the
// A tile (BK voxels x BM rows: every voxel's input shifted by the row's tap,
// zero in the padding) and the B tile (BK rows of g) into shared memory, and
// multiplies on the tensor cores through WMMA 16x16x16 with f32
// accumulation. Any Cin, Cout and any D, H, W are taken: ragged edges are
// masked, and 16-byte loads are used where Cin (for A) or Cout (for B) is a
// multiple of 8 and the pointer is aligned.
//
// Split-K. K is large and M x N small at the top of the DynUNet (BraTS level
// 0: M x N = 1728 x 96 over K = 262,144 voxels, 87 GFLOP), so the tiles alone
// would occupy a few dozen of the 132 SMs. The caller splits K into `splits`
// contiguous ranges, one per blockIdx.y, chosen from the shape; each split
// writes its partial tile to its own slice of an f32 (splits, M, N) scratch,
// and a second kernel sums the slices in a fixed order. The result does not
// depend on the order blocks run in. At the bottom (M x N = 6912 x 384 over
// K = 64) the tiles fill the card and there is one split, written straight
// to the output.
//
// What bounds it: at level 0 the bytes, 319 MB of bf16 x and g read once
// and the f32 dw written once (0.095 ms at 3.35 TB/s, against 0.088 ms for
// the 87 GFLOP); at 64^3 and 32^3 the operations; at 16^3 and 8^3 the dw
// write. This form gathers every (tap, ci) row of A from device memory for
// every output voxel (6.75x the bytes of x at level 0) and stages through
// shared memory with no overlap of loads and math, on WMMA. Every bf16 call
// with Cin and Cout multiples of 8 (every DynUNet site) takes the Hopper
// form instead, s2_wgrad_wgmma.cu, which stages each input line once, and
// every f32 call s2_wgrad_tf32x3.cu; this one keeps the other bf16 channel
// counts (UNet's 4 -> 16, RegUNet's 16 -> 16 and the AutoEncoder's 4 -> 4
// first stride-2 convs).
//
// Not carried over from the TPU kernel: the 128-lane (2 * C) gate, the W
// parity lane merge, the host-side H-parity deinterleave and the scanline DMA
// stack. They shaped x so that Mosaic could issue 2D dots; here the gather
// computes each tap's source voxel directly.
//
// Built by nvcc into the same shared library as the other sources
// (unet3d_tpu_torch/kernels/build.py), called through ctypes. The split-K
// sum below serves all three forms of the weight gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>
#include <type_traits>

// dw[i] = sum over s of part[s][i], s in order: the split-K sum of this form
// and of s2_wgrad_wgmma.cu's and s2_wgrad_tf32x3.cu's (defined below)
cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream);

namespace {

constexpr int BM = 128;      // dw rows (tap, ci) per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // voxels per stage
constexpr int THREADS = 256;
constexpr int GROUP = 8;     // consecutive elements one thread moves per load

struct WgradArgs {
  const void* x;        // (N, D, H, W, Cin)
  const void* g;        // (N, Do, Ho, Wo, Cout)
  float* out;           // (splits, 27 * Cin, Cout) f32
  int n, d, h, w_, cin;
  int do_, ho, wo, cout;
  int pad_lo;  // output plane od, tap kd reads x plane 2 od + kd - pad_lo
  long long k_per_split;  // voxels per split, a multiple of BK
  int vec_x, vec_g;       // 16-byte loads allowed for A / B groups
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Shared-memory row padding: rows stay 32-byte aligned for WMMA loads
template <typename T> struct Pad { static constexpr int A = 8, B = 8; };

template <typename T>
__device__ __forceinline__ void load_group(const T* p, T (&v)[GROUP]) {
  constexpr int kVecs = GROUP * sizeof(T) / sizeof(uint4);
  const uint4* src = reinterpret_cast<const uint4*>(p);
  uint4* dst = reinterpret_cast<uint4*>(v);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) dst[i] = __ldg(src + i);
}

// The output voxel k = ((n * Do + od) * Ho + oh) * Wo + ow.
struct Voxel { int n, od, oh, ow; };

__device__ __forceinline__ Voxel decode(const WgradArgs& a, long long k) {
  Voxel v;
  v.ow = static_cast<int>(k % a.wo);
  k /= a.wo;
  v.oh = static_cast<int>(k % a.ho);
  k /= a.ho;
  v.od = static_cast<int>(k % a.do_);
  v.n = static_cast<int>(k / a.do_);
  return v;
}

// x at the input voxel that tap `tap` of output voxel `v` reads, channel c;
// false in the padding.
__device__ __forceinline__ bool source(const WgradArgs& a, const Voxel& v,
                                       int tap, long long* offset) {
  const int iz = 2 * v.od + tap / 9 - a.pad_lo, iy = 2 * v.oh + (tap / 3) % 3 - 1,
            ix = 2 * v.ow + tap % 3 - 1;
  if (iz < 0 || iz >= a.d || iy < 0 || iy >= a.h || ix < 0 || ix >= a.w_)
    return false;
  *offset = (((static_cast<long long>(v.n) * a.d + iz) * a.h + iy) * a.w_ + ix) *
            a.cin;
  return true;
}

// A group: GROUP consecutive rows m of dw for output voxel k.
template <typename T>
__device__ __forceinline__ void load_a(const WgradArgs& a, long long k,
                                       bool k_ok, int m, T (&v)[GROUP]) {
  const T* xp = static_cast<const T*>(a.x);
  const int M = 27 * a.cin;
  if (!k_ok) {
#pragma unroll
    for (int e = 0; e < GROUP; ++e) v[e] = zero<T>();
    return;
  }
  const Voxel vox = decode(a, k);
  if (a.vec_x && m < M) {
    // Cin % GROUP == 0: the group lies in one tap, on contiguous channels
    const int tap = m / a.cin, c = m - tap * a.cin;
    long long off;
    if (source(a, vox, tap, &off)) {
      load_group(xp + off + c, v);
      return;
    }
#pragma unroll
    for (int e = 0; e < GROUP; ++e) v[e] = zero<T>();
    return;
  }
#pragma unroll
  for (int e = 0; e < GROUP; ++e) {
    const int me = m + e;
    T val = zero<T>();
    if (me < M) {
      const int tap = me / a.cin, c = me - tap * a.cin;
      long long off;
      if (source(a, vox, tap, &off)) val = xp[off + c];
    }
    v[e] = val;
  }
}

// B group: GROUP consecutive output channels of g at output voxel k.
template <typename T>
__device__ __forceinline__ void load_b(const WgradArgs& a, long long k,
                                       bool k_ok, int co, T (&v)[GROUP]) {
  const T* gp = static_cast<const T*>(a.g);
  if (a.vec_g && k_ok && co < a.cout) {
    load_group(gp + k * a.cout + co, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < GROUP; ++e)
    v[e] = (k_ok && co + e < a.cout) ? gp[k * a.cout + co + e] : zero<T>();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) s2_wgrad_ndhwc(const WgradArgs a) {
  using namespace nvcuda;
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 on WMMA");
  constexpr int LDA = BM + Pad<T>::A;  // A staged k-major: As[k][m]
  constexpr int LDB = BN + Pad<T>::B;  // B staged k-major: Bs[k][co]
  constexpr int LDC = BN + 4;
  constexpr int kABytes = BK * LDA * sizeof(T);
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
  const int M = 27 * a.cin;
  const long long K =
      static_cast<long long>(a.n) * a.do_ * a.ho * a.wo;
  const int n_tiles = (a.cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int co0 = (blockIdx.x % n_tiles) * BN;
  const long long k_begin = blockIdx.y * a.k_per_split;
  const long long k_end =
      k_begin + a.k_per_split < K ? k_begin + a.k_per_split : K;

  // A: each thread stages one fixed group of rows for kAIters voxels a stage
  constexpr int kGroupsPerVoxel = BM / GROUP;
  constexpr int kVoxelStep = THREADS / kGroupsPerVoxel;
  constexpr int kAIters = BK / kVoxelStep;
  const int a_m = (tid % kGroupsPerVoxel) * GROUP;
  const int a_k = tid / kGroupsPerVoxel;
  // B: one group per thread
  static_assert(BK * BN == THREADS * GROUP, "one B group per thread");
  const int b_k = tid / (BN / GROUP);
  const int b_co = (tid % (BN / GROUP)) * GROUP;

  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;  // 4 x 2 warps
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);

  for (long long k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int kk = a_k + i * kVoxelStep;
      alignas(16) T v[GROUP];
      load_a<T>(a, k0 + kk, k0 + kk < k_end, m0 + a_m, v);
      T* dst = As + kk * LDA + a_m;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) dst[e] = v[e];
    }
    {
      alignas(16) T v[GROUP];
      load_b<T>(a, k0 + b_k, k0 + b_k < k_end, co0 + b_co, v);
      T* dst = Bs + b_k * LDB + b_co;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) dst[e] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A (m, k) sits at As[k * LDA + m]: column-major for WMMA
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], fa[i], fb[j], cf[i][j]);
    }
    __syncthreads();
  }

  // accumulators -> C tile in shared memory (the loop ended on a barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, cf[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // store this split's partial tile: consecutive threads, consecutive co
  float* op = a.out + static_cast<long long>(blockIdx.y) * M * a.cout;
  constexpr int kRows = THREADS / BN;
  const int col = tid % BN, co = co0 + col;
  for (int r = tid / BN; r < BM; r += kRows) {
    const int m = m0 + r;
    if (m < M && co < a.cout)
      op[static_cast<long long>(m) * a.cout + co] = Cs[r * LDC + col];
  }
}

// out[i] = sum over s of part[s][i], s in order.
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, long long mn, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[p * mn + i];
    out[i] = s;
  }
}

template <typename T>
cudaError_t launch(const WgradArgs& a, int splits, float* dw,
                   cudaStream_t stream) {
  const long long tiles = static_cast<long long>((27 * a.cin + BM - 1) / BM) *
                          ((a.cout + BN - 1) / BN);
  if (tiles < 1 || tiles > INT_MAX || splits < 1 || splits > 65535)
    return cudaErrorInvalidConfiguration;
  s2_wgrad_ndhwc<T><<<dim3(static_cast<unsigned>(tiles), splits), THREADS, 0,
                      stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return unet3d_s2_wgrad_sum_splits(a.out, dw, 27LL * a.cin * a.cout, splits, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

cudaError_t unet3d_s2_wgrad_sum_splits(const float* part, float* dw, long long mn,
                                       int splits, cudaStream_t stream) {
  const long long blocks = (mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096;
  sum_splits<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, dw, mn, splits);
  return cudaGetLastError();
}

// x (N, D, H, W, Cin), g (N, Do, Ho, Wo, Cout) bf16, dw (3, 3, 3, Cin, Cout)
// f32. With splits > 1, `part` is an f32
// (splits, 27 * Cin, Cout) scratch that the partial sums go to before they
// are summed into dw; with splits == 1 it is unused and may be null. pad_lo
// is the zero planes below x on D: 1 for the SAME conv, 0 for a D slab whose
// first plane is the one below it (the D-halo mode). Returns the cudaError_t
// of the launches (0 on success).
extern "C" int unet3d_s2_wgrad_ndhwc(const void* x, const void* g,
                                     float* part, float* dw, int n, int d,
                                     int h, int w_, int cin, int do_, int ho,
                                     int wo, int cout, int splits,
                                     long long k_per_split, int pad_lo,
                                     void* stream) {
  if (k_per_split < 1 || k_per_split % BK != 0 || pad_lo < 0 || pad_lo > 1 ||
      do_ != (d + pad_lo) / 2)
    return cudaErrorInvalidValue;
  WgradArgs a{x, g, splits == 1 ? dw : part, n, d, h, w_, cin, do_, ho, wo,
              cout, pad_lo, k_per_split, cin % GROUP == 0 && aligned16(x),
              cout % GROUP == 0 && aligned16(g)};
  return launch<__nv_bfloat16>(a, splits, dw, static_cast<cudaStream_t>(stream));
}
