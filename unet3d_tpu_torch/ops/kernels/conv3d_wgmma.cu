// 3x3x3 stride-1 SAME convolution over NDHWC bf16 activations, the Hopper
// (sm_90a) form: brick-staged implicit GEMM on wgmma. It computes the three
// variants of conv3d.cu (conv, conv_stats, block_stats; what each replaces is
// in that file's note) for every bf16 call whose Cin is a multiple of 4 and
// Cout of 8, which is every site of the DynUNet; conv3d.cu keeps the f32 form
// and a bf16 WMMA form for other channel counts.
//
// What bounds it: K = 27 * Cin deep products. The BraTS DynUNet's forward is
// ~2.56 TFLOP per 128^3 window, all but the input conv in convs that do
// 2 * 27 * Cin * Cout flops per voxel over 2 * (Cin + Cout) bytes, i.e.
// >= 860 flops per byte: compute-bound at every level-0 and level-1 site
// (64->64 @128^3 is 0.46 TFLOP, 0.47 ms at 989 TFLOP/s; its bytes 0.16 ms at
// 3.35 TB/s). The input conv (Cin 4) is memory-bound (0.085 ms).
//
// Design:
// * M tile = a BZ x BY x BX brick of output voxels inside one batch item
//   (256 = 4x4x16 or 128 = 2x4x16); bricks at the volume's edges are masked.
//   N tile = BN output channels (BN = Cout up to 256, else 192-wide tiles).
//   The wrapper picks one of CONFIGS per call (conv3d_kernel.wgmma_plan).
// * K runs as (64-channel chunk, tap). For each chunk the brick plus its
//   one-voxel halo ((BZ+2) x (BY+2) x (BX+2) rows of 64 channels, 128 bytes)
//   is staged once in shared memory with cp.async, zero-filled outside the
//   volume and past Cin (a 4-channel input fills 8 of a row's 128 bytes and
//   runs one of the 4 k16 steps per tap), and all 27 taps read it: tap (dz, dy, dx)'s A tile
//   is the brick's rows shifted by that offset. Rows are swizzled by XOR of
//   the 16-byte chunk with (row & 7), so ldmatrix's eight row reads of one
//   x-line hit eight distinct bank groups.
// * A goes from shared memory to registers with ldmatrix (any row address),
//   and wgmma m64nBNk16 takes it from registers (the RS form); B comes from
//   shared memory through a 128-byte-swizzled K-major descriptor. The weight
//   is pre-packed per call by the wrapper (conv3d_kernel.pack_weight) into
//   (n tile, chunk, tap, BN, 64) tiles, zero-padded, so each step's B is one
//   contiguous BN x 128-byte block.
// * Overlap: B tiles run through a STAGES-deep cp.async ring (STAGES - 2
//   tiles ahead); with two halo buffers the next chunk's halo loads while
//   this chunk's taps run; each step's wgmma group stays in flight while the
//   next step's A fragments load (double-buffered registers,
//   wgmma.wait_group 1). Where Cin fits one chunk, one halo buffer frees
//   the room for a deeper M tile or a second block per SM, whose loads and
//   epilogue then overlap this block's products.
// * PROLOGUE (block_stats): every staged element is replaced in shared
//   memory by lrelu(x * inv[n, c] + shift[n, c]) in f32, rounded to bf16;
//   voxels outside the volume stay zero (SAME padding pads the activation:
//   lrelu(shift) != 0). Once per element, not per tap: the first chunk's
//   before its first tap, each later chunk's while an earlier step's
//   products run.
// * Epilogue: accumulators are rounded to bf16; STATS sums those rounded
//   values per channel in registers and warp shuffles, then one atomicAdd
//   per (item, channel) per block into the caller-zeroed (N, 2, Cout) f32
//   buffer (the add order changes run to run). y goes out through shared
//   memory as 16-byte stores.
//
// Two warpgroups of 128 threads; 105-209 KB of shared memory, one or two
// blocks per SM. On an H100 it reaches a quarter to a half of the bf16 bound
// at the DynUNet's level-0 and level-1 sites (PERF.md): at Cout = 64 each
// step reads as many A bytes (ldmatrix) as B bytes (wgmma) from shared
// memory, 1/32 byte per flop, the rate at which shared memory and the tensor
// cores are both saturated. Built by nvcc with the other sources
// (kernels/build.py) and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CK = 64;              // input channels per staged chunk
constexpr int ROW_BYTES = CK * 2;   // one staged row: 64 bf16
constexpr int TAPS = 27;
constexpr int WARPGROUPS = 2;
constexpr int THREADS = WARPGROUPS * 128;

struct Args {
  const bf16* x;        // (N, D, H, W, Cin)
  const bf16* w;        // packed (n_tiles, chunks, 27, BN, 64)
  bf16* y;              // (N, D, H, W, Cout)
  const float* inv;     // (N, Cin), PROLOGUE only
  const float* shift;   // (N, Cin), PROLOGUE only
  float* stats;         // (N, 2, Cout), STATS only; zeroed by the caller
  int n, d, h, w_, cin, cout;
  int bricks_z, bricks_y, bricks_x, n_tiles, chunks;
  float alpha;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 8 bytes global -> shared, or 8 zero bytes when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// orders this thread's completed generic-proxy writes (cp.async) before
// later async-proxy reads (wgmma's B operand)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO 64 x 16 B), LBO
// unused (1); the tile base is 1024-byte aligned, so advancing along K by 16
// elements adds 32 bytes to the start address
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk j of staged row r (swizzled)
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * ROW_BYTES + ((j ^ (r & 7)) << 4));
}

// D += A * B for one m64nNk16 bf16 product, A from registers (the
// m16n8k16-style fragment of each warp's 16 rows), B from a descriptor,
// f32 accumulators d (N / 2 per thread)
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t desc,
                                             float (&d)[32]) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t desc,
                                             float (&d)[48]) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t desc,
                                             float (&d)[64]) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<192> {
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t desc,
                                             float (&d)[96]) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t desc,
                                             float (&d)[128]) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS>
struct Tile {
  static constexpr int BM = BZ * BY * BX;
  static constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;
  static constexpr int HALO_ROWS = HZ * HY * HX;
  static constexpr int HALO_BYTES = align1024(HALO_ROWS * ROW_BYTES);
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int C_PITCH = BN * 2 + 16;  // staged bf16 output row, bytes
  static constexpr int SMEM = HALOS * HALO_BYTES + STAGES * B_BYTES + 1024;
  static_assert(BM == WARPGROUPS * MT * 64, "each warpgroup owns MT 64-row tiles");
  static_assert(BX % 8 == 0, "an 8-row ldmatrix read stays on one x-line");
  static_assert(BN % 8 == 0 && (BN * 8) % THREADS == 0, "B tile rows");
  static_assert(BM * C_PITCH <= HALOS * HALO_BYTES, "C tile fits the halo buffers");
  static_assert(HALOS == 1 || HALOS == 2, "one halo buffer, or two for a chunk ahead");
  static_assert(2 * 8 * BN * 4 <= STAGES * B_BYTES, "statistics fit the B ring");
  static_assert(STAGES >= 3, "one B tile in flight at least");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// KSTEPS: the k16 steps per tap, 4 (64 channels) or 1 (Cin <= 16)
template <int BZ, int BY, int BX, int BN, int MT, int STAGES, int HALOS, int MIN_BLOCKS,
          int KSTEPS, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) conv3x3x3_wgmma(const Args a) {
  using Cfg = Tile<BZ, BY, BX, BN, MT, STAGES, HALOS>;
  // an SM holds 233472 bytes of shared memory, 1024 of them reserved per block
  static_assert(MIN_BLOCKS * (Cfg::SMEM + 1024) <= 233472, "blocks per SM");
  constexpr int HX = Cfg::HX, HY = Cfg::HY, HALO_ROWS = Cfg::HALO_ROWS;
  constexpr int LEAD = STAGES - 2;  // B tiles loaded ahead of the current step
  constexpr int NACC = BN / 2;

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

  // staging: thread -> 16-byte chunk j of every (THREADS / 8)-th halo row
  const int sj = tid & 7;
  // the halo lies inside the volume (no padding rows)
  const bool interior = z0 >= 1 && y0 >= 1 && x0 >= 1 && z0 + BZ < a.d &&
                        y0 + BY < a.h && x0 + BX < a.w_;
  auto halo_voxel = [&](int hr, int& zz, int& yy, int& xx) {
    xx = x0 + hr % HX - 1;
    yy = y0 + (hr / HX) % HY - 1;
    zz = z0 + hr / (HX * HY) - 1;
    return zz >= 0 && zz < a.d && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w_;
  };
  auto load_halo = [&](int c, uint8_t* buf) {
    const int ch = c * CK + sj * 8;
    const uint32_t base = smem_u32(buf);
    for (int hr = tid >> 3; hr < HALO_ROWS; hr += THREADS / 8) {
      int zz, yy, xx;
      const bool in = halo_voxel(hr, zz, yy, xx);
      const bf16* src =
          a.x + (in ? (((static_cast<long long>(item) * a.d + zz) * a.h + yy) * a.w_ + xx) *
                              a.cin + ch
                        : 0);
      if (a.cin % 8 == 0) {
        cp_async16(base + swz(hr, sj), in && ch < a.cin ? src : a.x, in && ch < a.cin);
      } else {  // Cin % 8 == 4: 8-byte aligned rows, two groups of 4 channels
        cp_async8(base + swz(hr, sj), in && ch < a.cin ? src : a.x, in && ch < a.cin);
        cp_async8(base + swz(hr, sj) + 8, in && ch + 4 < a.cin ? src + 4 : a.x,
                  in && ch + 4 < a.cin);
      }
    }
  };
  const bf16* const wtiles =
      a.w + static_cast<long long>(nt) * a.chunks * TAPS * BN * CK;
  auto load_b = [&](int s) {  // step s = chunk * 27 + tap, in packed order
    const bf16* src = wtiles + static_cast<long long>(s) * BN * CK;
    const uint32_t base = smem_u32(ring + (s % STAGES) * Cfg::B_BYTES);
#pragma unroll
    for (int k = 0; k < BN * 8 / THREADS; ++k) {
      const int i = tid + k * THREADS;  // 16-byte group i: row i / 8, chunk i % 8
      cp_async16(base + swz(i >> 3, i & 7), src + i * 8, true);
    }
  };
  // block_stats: z = lrelu(x * inv + shift) in place, once per staged
  // element; a thread transforms the rows it staged itself, so its own
  // cp.async wait suffices
  auto activate = [&](int c, uint8_t* buf) {
    const int ch = c * CK + sj * 8;
    if (ch >= a.cin) return;  // zero-filled channels meet zero weights
    float sc[8], sh[8];  // zero past Cin: zero channels stay zero
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = ch + e < a.cin;
      sc[e] = ok ? a.inv[item * a.cin + ch + e] : 0.f;
      sh[e] = ok ? a.shift[item * a.cin + ch + e] : 0.f;
    }
#pragma unroll 4
    for (int hr = tid >> 3; hr < HALO_ROWS; hr += THREADS / 8) {
      int zz, yy, xx;
      if (!interior && !halo_voxel(hr, zz, yy, xx)) continue;  // padding stays zero
      uint4* p = reinterpret_cast<uint4*>(buf + swz(hr, sj));
      uint4 v = *p;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(h2[e]);
        f.x = fmaf(f.x, sc[2 * e], sh[2 * e]);
        f.y = fmaf(f.y, sc[2 * e + 1], sh[2 * e + 1]);
        f.x = f.x >= 0.f ? f.x : f.x * a.alpha;
        f.y = f.y >= 0.f ? f.y : f.y * a.alpha;
        h2[e] = __floats2bfloat162_rn(f.x, f.y);
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

  float acc[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.f;
  uint32_t afrag[2][MT][KSTEPS][4];

  const int steps = a.chunks * TAPS;
  load_halo(0, halo0);
#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    load_b(s);
    cp_async_commit();
  }

  auto step = [&](int s, auto parity) {
    constexpr int P = decltype(parity)::value;
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
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = hrow[mt] + toff;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(hbase + swz(r, ks * 2 + khalf), afrag[P][mt][ks]);
    }
    wgmma_fence();
    const uint32_t bbase = smem_u32(ring + (s % STAGES) * Cfg::B_BYTES);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t desc = desc_sw128(bbase + ks * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) Wgmma<BN>::mma(afrag[P][mt][ks], desc, acc[mt]);
    }
    wgmma_commit();
    // the next chunk's halo landed with step s's copies (issued at tap 0,
    // LEAD steps ahead): transform it while these products run
    if (PROLOGUE && HALOS == 2 && tap == LEAD && c + 1 < a.chunks)
      activate(c + 1, halo0 + ((c + 1) & 1) * Cfg::HALO_BYTES);
    wgmma_wait<1>();  // step s - 1's products are done with their operands
  };
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, std::integral_constant<int, 0>{});
    step(s + 1, std::integral_constant<int, 1>{});
  }
  if (s < steps) step(s, std::integral_constant<int, 0>{});
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
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][4 * i + 2 * hi],
                                                       acc[mt][4 * i + 2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ctile + r * Cfg::C_PITCH +
                                           (8 * i + 2 * (lane & 3)) * 2) = v;
        if constexpr (STATS) {
          if (row_ok[mt][hi]) {
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
  for (int i = tid; i < Cfg::BM * GROUPS; i += THREADS) {
    const int r = i / GROUPS, q = i % GROUPS;
    const int co = nt * BN + q * 8;
    long long vx;
    if (voxel_of(r, vx) && co < a.cout)
      *reinterpret_cast<uint4*>(a.y + vx * a.cout + co) =
          *reinterpret_cast<const uint4*>(ctile + r * Cfg::C_PITCH + q * 16);
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
  auto kernel = conv3x3x3_wgmma<BZ, BY, BX, BN, MT, STAGES, HALOS, MIN_BLOCKS, KSTEPS,
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
      (KSTEPS == 1 && a.cin > 16))
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
// this one's taps run; 1: Cin <= 64 only); blocks per SM the registers are
// bounded for. ops/conv3d_kernel.py (WGMMA_CONFIGS) picks one
// per call and checks this table against its own when the library loads.
constexpr int CONFIGS[][8] = {
    {4, 4, 16, 64, 2, 4, 2, 1},
    {2, 4, 16, 96, 1, 4, 2, 1},
    {2, 4, 16, 128, 1, 4, 2, 1},
    {2, 4, 16, 192, 1, 4, 2, 1},
    {2, 4, 16, 256, 1, 3, 2, 1},
    {4, 4, 16, 64, 2, 3, 1, 1},
    {2, 4, 16, 128, 1, 3, 1, 2},
};
constexpr int N_CONFIGS = sizeof(CONFIGS) / sizeof(CONFIGS[0]);

}  // namespace

// variant: 0 = conv, 1 = conv_stats, 2 = block_stats; config: an index of
// CONFIGS. w is the packed weight (n_tiles, chunks, 27, BN, 64); x, w and y
// 16-byte aligned, Cin a multiple of 4 and Cout of 8. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int unet3d_conv3x3x3_wgmma(int variant, int config, const void* x,
                                      const void* w, void* y, const float* inv,
                                      const float* shift, float* stats, int n,
                                      int d, int h, int w_, int cin, int cout,
                                      int bricks_z, int bricks_y, int bricks_x,
                                      int n_tiles, int chunks, float alpha,
                                      void* stream) {
  if (cin % 4 != 0 || cout % 8 != 0) return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
         static_cast<bf16*>(y), inv, shift, stats, n, d, h, w_, cin, cout,
         bricks_z, bricks_y, bricks_x, n_tiles, chunks, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return dispatch<4, 4, 16, 64, 2, 4, 2, 1>(variant, a, s);
    case 1: return dispatch<2, 4, 16, 96, 1, 4, 2, 1>(variant, a, s);
    case 2: return dispatch<2, 4, 16, 128, 1, 4, 2, 1>(variant, a, s);
    case 3: return dispatch<2, 4, 16, 192, 1, 4, 2, 1>(variant, a, s);
    case 4: return dispatch<2, 4, 16, 256, 1, 3, 2, 1>(variant, a, s);
    case 5:  // the 4-channel input conv runs one k16 step per tap
      return cin <= 16 ? dispatch<4, 4, 16, 64, 2, 3, 1, 1, 1>(variant, a, s)
                       : dispatch<4, 4, 16, 64, 2, 3, 1, 1>(variant, a, s);
    case 6: return dispatch<2, 4, 16, 128, 1, 3, 1, 2>(variant, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the eight numbers of tile configuration `config` into out; -1 past the table
extern "C" int unet3d_conv3x3x3_wgmma_config(int config, int* out) {
  if (config < 0 || config >= N_CONFIGS) return -1;
  for (int i = 0; i < 8; ++i) out[i] = CONFIGS[config][i];
  return 0;
}
