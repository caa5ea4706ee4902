// Fused inference BasicBlock with BatchNorm folded into the convolutions.
//
// Replaces: human_pose_tpu/ops/pallas_conv.py::fused_basic_block (kernel
// _kernel), which runs both 3x3 convolutions of a row tile as nine shifted
// tap matmuls on the TPU MXU (bf16 operands, float32 accumulation), with the
// conv1 output kept in VMEM.
//
//   y   = relu(conv3x3(x, w1) + b1), zero outside the image, cast to x's type
//   out = relu(conv3x3(y, w2) + b2 + x)
// x and out [B, H, W, C] NHWC, w1, w2 [3, 3, C, C] HWIO (BN folded), b1, b2
// [C] float32; accumulation, bias, residual and ReLU in float32.
//
// What bounds it on the H100: operations. One block at every HRNet-W32
// branch shape (C=32 at 128x128, 64 at 64x64, 128 at 32x32, 256 at 16x16)
// is 2 * 9 * C * C * H * W * 2 = 1.45e10 FLOP at batch 24: 0.015 ms on the
// bf16 tensor cores (989 TFLOP/s), 0.22 ms at the 67 TFLOP/s float32
// CUDA-core peak, against 0.05-0.1 GB of activations (0.015-0.03 ms).
//
// Both instances are implicit GEMMs on the tensor cores, one per tap:
// [pixels x C_in] . [C_in x C_out] with wgmma.mma_async, N = C_out (split in
// two for conv2 at C >= 128), accumulated in float32 registers by two
// warpgroups a block. Channels are padded to CP (16, 32, 64, 128 or 256) with
// zero weights.
//  - A (64 pixels x one k step of the tap-shifted window, 32 bytes a pixel)
//    comes from registers, loaded by ldmatrix.x4 with one row address per
//    pixel, so any pixel of the tile can be a row. Tile pixels are an odd
//    number of 16-byte units apart, so the 8 rows of an ldmatrix matrix fall
//    on 8 distinct bank groups.
//  - B is the tap's [C_in-chunk x C_out] weights, pre-packed by the wrapper
//    into wgmma's K-major core-matrix layout (no swizzle) and streamed chunk
//    by chunk (one tap, KCH input channels) through a ring of STAGES
//    shared-memory buffers by 1-D bulk copies on mbarriers: thread 0 refills
//    a stage as soon as both warpgroups have released it, so the next
//    STAGES - 1 chunks are in flight while the warpgroups compute. (With a
//    separate producer warp, 9 warps a block, ptxas held the bf16 C = 256
//    instance to 166 registers and serialized its wgmma for lack of them.)
//  - The input tile and its 2-pixel halo come by one TMA load of a 5-D map
//    over x viewed as [B, H, W, C / G, G] (G channels = 16 bytes); TMA's
//    out-of-bounds zero fill is conv1's SAME padding, and the box's extra
//    group (past the tensor) is the pixel stride's padding. The map is
//    encoded with cuTensorMapEncodeTiled reached through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//  - conv1 runs over the tile plus a 1-pixel halo (rows padded to a multiple
//    of 64) into shared memory, zero outside the image (conv2's padding);
//    conv2 reads its A fragments from there the same way. The epilogue adds
//    b2 and the residual and applies the ReLU.
//
// bfloat16 x (bf16_block_kernel): m64nNk16 bf16 products. conv1's output is
// stored as bf16 beside the input tile, which gives the residual. Tiles
// 16x16 at C <= 32, 8x16 at C = 64, 8x8 at C >= 128.
//
// float32 x (tf32_block_kernel): 3xTF32. The tensor cores take float32 only
// as TF32 (10 mantissa bits; they ignore an operand's low 13 bits), at 495
// TFLOP/s, and one TF32 product a term misses this block's 1e-4 bound. So
// each operand a is split into hi = cvt.rna.tf32(a) and lo = a - hi (exact),
// and the sum takes a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, as
// three m64nNk8 tf32 products into one float32 accumulator: about 2^-21 of a
// term is lost (lo truncated to TF32, lo * lo dropped). Three products of
// 1.45e10 FLOP at 495 TFLOP/s are a 0.088 ms floor, under the 0.216 ms of
// the float32 CUDA cores. A is split in registers after ldmatrix (a .b16
// ldmatrix.x4 of 32-bit words is exactly the tf32 A fragment); B is split
// once by the wrapper, which packs hi and lo of each k8 step side by side.
// Float32 doubles the tiles, so conv1's output goes over the input tile once
// every warp has read it, and the epilogue reads the residual from x in
// global memory (L2). Tiles and pipeline: F32Cfg below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Geometry of a block's output tile and weight pipeline for CP padded channels
template <int CP_, int TH_, int TW_, int KCH_, int STAGES_, int NS1_, int NS2_>
struct TileGeom {
  static constexpr int CP = CP_, TH = TH_, TW = TW_, KCH = KCH_, STAGES = STAGES_;
  static constexpr int NWG = 2;                      // warpgroups
  static constexpr int THREADS = NWG * 128;
  static constexpr int XH = TH + 4, XW = TW + 4;     // input tile with its 2-pixel halo
  static constexpr int YH = TH + 2, YW = TW + 2;     // conv1 output with its 1-pixel halo
  static constexpr int R1 = YH * YW, MT1 = (R1 + 63) / 64;  // conv1 rows and m64 tiles
  static constexpr int R2 = TH * TW, MT2 = R2 / 64;         // conv2 rows and m64 tiles
  static constexpr int NS1 = NS1_, NS2 = NS2_;       // N slices of each conv
  static constexpr int NN1 = CP / NS1, NN2 = CP / NS2;
  static constexpr int U1 = (MT1 * NS1 + NWG - 1) / NWG;  // units (m64 x NN) per warpgroup
  static constexpr int U2 = (MT2 * NS2 + NWG - 1) / NWG;
  static constexpr int KCS = CP / KCH;               // chunks per tap
  static constexpr int NCH = 9 * KCS;                // chunks per conv
  static_assert(R2 % 64 == 0, "conv2 rows must fill m64 tiles");
};

// bfloat16: the input tile, conv1's output beside it, then the weight ring
template <int CP_, int TH_, int TW_, int KCH_, int STAGES_, int NS2_>
struct TileCfg : TileGeom<CP_, TH_, TW_, KCH_, STAGES_, 1, NS2_> {
  using G = TileGeom<CP_, TH_, TW_, KCH_, STAGES_, 1, NS2_>;
  static constexpr int PSE = CP_ + 8;                // pixel stride in shared memory, elements
  static constexpr int CHUNK_BYTES = KCH_ * CP_ * 2;
  static constexpr int X_BYTES = G::XH * G::XW * PSE * 2;
  static constexpr int Y_BYTES = G::R1 * PSE * 2;
  static constexpr int RING_OFF = (X_BYTES + Y_BYTES + 127) / 128 * 128;
  static constexpr int BAR_OFF = RING_OFF + STAGES_ * CHUNK_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES_);
  static constexpr int NSEQ = 2 * G::NCH;            // chunks through the ring: conv1's, conv2's
  static constexpr int P1 = 1;                       // one conv1 pass, one accumulator
  static constexpr bool DUAL = false;
  __device__ static int pack_chunk(int g) { return g; }
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int CP> struct Cfg;
template <> struct Cfg<16> : TileCfg<16, 16, 16, 16, 8, 1> {};
template <> struct Cfg<32> : TileCfg<32, 16, 16, 32, 8, 1> {};
template <> struct Cfg<64> : TileCfg<64, 8, 16, 64, 4, 1> {};
template <> struct Cfg<128> : TileCfg<128, 8, 8, 64, 4, 2> {};
template <> struct Cfg<256> : TileCfg<256, 8, 8, 64, 3, 2> {};

// float32 (3xTF32): the input tile, conv1's output written over it, then the
// weight ring; a chunk holds the hi and then the lo part of each of its k8
// steps (KCH / 8 of them).
//  - P1: conv1 runs in P1 passes over its m64 tiles, each pass streaming
//    conv1's weights again and covering whole tiles (its N slices spread
//    over the warpgroups), so only one pass's sums are in registers.
//  - DUAL: the two small products of a term (lo x hi, hi x lo) go into a
//    second accumulator, added to the first at the end. The tensor cores do
//    not round the float32 accumulator to nearest, so each wgmma's add
//    loses a fraction of an ulp of the sum, the same way every time: the
//    error grows with the number of adds, 3 a k8 step. DUAL leaves the
//    large sum a third of them.
template <int CP_, int TH_, int TW_, int KCH_, int STAGES_, int NS1_, int NS2_, int P1_, bool DUAL_>
struct F32TileCfg : TileGeom<CP_, TH_, TW_, KCH_, STAGES_, NS1_, NS2_> {
  using G = TileGeom<CP_, TH_, TW_, KCH_, STAGES_, NS1_, NS2_>;
  static constexpr int P1 = P1_;
  static constexpr bool DUAL = DUAL_;
  static constexpr int U1P = P1_ == 1 ? G::U1 : G::MT1 * NS1_ / (G::NWG * P1_);  // units a pass
  static constexpr int PSE = CP_ + 4;                // pixel stride in shared memory, floats
  static constexpr int KS = KCH_ / 8;                // k8 steps a chunk
  static constexpr int STEP_BYTES = CP_ * 8 * 4;     // hi or lo of one k8 step
  static constexpr int CHUNK_BYTES = KS * 2 * STEP_BYTES;
  static constexpr int X_BYTES = G::XH * G::XW * PSE * 4;
  static constexpr int Y_BYTES = G::R1 * PSE * 4;
  static constexpr int RING_OFF = (X_BYTES + 127) / 128 * 128;
  static constexpr int BAR_OFF = RING_OFF + STAGES_ * CHUNK_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES_);
  static constexpr int NSEQ = (P1_ + 1) * G::NCH;    // chunks through the ring: conv1's P1 times, conv2's
  // the packed chunk streamed as the g-th
  __device__ static int pack_chunk(int g) { return g < P1_ * G::NCH ? g % G::NCH : g - (P1_ - 1) * G::NCH; }
  static_assert(KCH_ % 8 == 0 && Y_BYTES <= X_BYTES, "whole k8 steps; conv1's output fits the input tile");
  static_assert(P1_ == 1 || (G::MT1 * NS1_ % (G::NWG * P1_) == 0 && G::NWG * U1P % NS1_ == 0),
                "a pass takes whole m64 tiles, the same number of units in each warpgroup");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Measured on the H100 at the W32 branch shapes (batch 24): KCH 16 with 4
// stages keeps two blocks an SM at C = 32, 64 (122 registers); at C = 128,
// where shared memory allows one block, KCH 32 halves the chunk waits
// (0.193 against 0.228 ms); C = 256 fits two stages of KCH 16 (KCH 8 with 4
// stages: 0.264 ms against 0.219). Smaller tiles, other ring depths and one
// wgmma group kept in flight across chunks were slower. DUAL where the sums
// are long enough for the add's bias to near 1e-4 (C >= 128: 6e-5 at 256
// without it); at C = 256 the two accumulators of conv1 fit only in passes.
template <int CP> struct F32Cfg;
template <> struct F32Cfg<16> : F32TileCfg<16, 16, 16, 16, 4, 1, 1, 1, false> {};
template <> struct F32Cfg<32> : F32TileCfg<32, 16, 16, 16, 4, 1, 1, 1, false> {};
template <> struct F32Cfg<64> : F32TileCfg<64, 8, 16, 16, 4, 1, 1, 1, false> {};
template <> struct F32Cfg<128> : F32TileCfg<128, 8, 8, 32, 2, 1, 2, 1, true> {};
template <> struct F32Cfg<256> : F32TileCfg<256, 8, 8, 16, 2, 2, 2, 2, true> {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at (c0..c4) -> shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16) global -> shared, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Shared-memory matrix descriptor of a K-major, unswizzled operand: core
// matrices of 8 rows x 16 bytes (128 contiguous bytes), LBO bytes apart
// along K and SBO bytes apart along N.
constexpr uint32_t DESC_LBO = 128, DESC_SBO = 256;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(DESC_LBO >> 4) << 16) |
         ((uint64_t)(DESC_SBO >> 4) << 32);
}

// d[N / 2] += A (64 x one k step, registers) * B (k step x N, shared memory,
// K-major): one wgmma.mma_async with A from registers. For an m64nN product
// DREGS lists the accumulators %0 .. %(N/2 - 1), AREGS the four A registers,
// DESC B's descriptor and FLAG the scale-d source (always 1: accumulate);
// TAIL is the immediates after scale-d. The accumulators' constraints come
// last (ACC*: they hold commas).
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)
#define ACC16(i) ACC8(i), ACC8(i + 8)
#define ACC32(i) ACC16(i), ACC16(i + 16)
#define ACC64(i) ACC32(i), ACC32(i + 32)
#define ACC128(i) ACC64(i), ACC64(i + 64)
#define WGMMA_FN(NAME, N, SHAPE_TYPES, TAIL, DREGS, AREGS, DESC, FLAG, ...)                          \
  __device__ __forceinline__ void NAME(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " FLAG ", 0;\n"                                    \
                 "wgmma.mma_async.sync.aligned." SHAPE_TYPES " {" DREGS "}, {" AREGS "}, " DESC       \
                 ", p, " TAIL ";\n}\n"                                                                \
                 : __VA_ARGS__                                                                        \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));                  \
  }
// bf16 (k16: scale-a, scale-b, B not transposed) and tf32 (k8: K-major only)
#define WGMMA_PAIR(N, DREGS, AREGS, DESC, FLAG, ...)                                          \
  WGMMA_FN(wgmma_n##N, N, "m64n" #N "k16.f32.bf16.bf16", "1, 1, 0", DREGS, AREGS, DESC, FLAG, \
           __VA_ARGS__)                                                                       \
  WGMMA_FN(tf32_n##N, N, "m64n" #N "k8.f32.tf32.tf32", "1, 1", DREGS, AREGS, DESC, FLAG, __VA_ARGS__)

WGMMA_PAIR(16,
           "%0, %1, %2, %3, %4, %5, %6, %7",
           "%8, %9, %10, %11", "%12", "%13", ACC8(0))
WGMMA_PAIR(32,
           "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15",
           "%16, %17, %18, %19", "%20", "%21", ACC16(0))
WGMMA_PAIR(64,
           "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
           "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31",
           "%32, %33, %34, %35", "%36", "%37", ACC32(0))
WGMMA_PAIR(128,
           "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
           "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
           "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
           "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63",
           "%64, %65, %66, %67", "%68", "%69", ACC64(0))
WGMMA_PAIR(256,
           "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
           "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
           "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
           "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
           "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
           "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
           "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
           "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127",
           "%128, %129, %130, %131", "%132", "%133", ACC128(0))

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 16) wgmma_n16(d, a, desc_b);
  if constexpr (N == 32) wgmma_n32(d, a, desc_b);
  if constexpr (N == 64) wgmma_n64(d, a, desc_b);
  if constexpr (N == 128) wgmma_n128(d, a, desc_b);
  if constexpr (N == 256) wgmma_n256(d, a, desc_b);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 16) tf32_n16(d, a, desc_b);
  if constexpr (N == 32) tf32_n32(d, a, desc_b);
  if constexpr (N == 64) tf32_n64(d, a, desc_b);
  if constexpr (N == 128) tf32_n128(d, a, desc_b);
  if constexpr (N == 256) tf32_n256(d, a, desc_b);
}

template <int N, int U>
__device__ __forceinline__ void fence_acc(float (&acc)[U][N / 2]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[u][i])::"memory");
  }
}

// Unit u of warpgroup wg: units wg, wg + NWG, ... of the MT * NS (m64 tile,
// N slice) units of a conv. Where they do not divide evenly, a warpgroup's
// last slot repeats the conv's last unit and its epilogue is skipped, so
// every warpgroup issues the same wgmma sequence with no divergent branch
// around it.
template <class K, int MT, int NS>
__device__ __forceinline__ int unit_of(int wg, int u) {
  return min(wg + u * K::NWG, MT * NS - 1);
}

// The g-th weight chunk streamed (K::pack_chunk(g) of the pack) into its
// ring stage, completing on that stage's full barrier
template <class K>
__device__ __forceinline__ void load_chunk(unsigned char* ring, const void* wpack, int g,
                                           uint64_t* full) {
  const int s = g % K::STAGES;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(wpack) + (size_t)K::pack_chunk(g) * K::CHUNK_BYTES;
  mbar_expect_tx(&full[s], K::CHUNK_BYTES);
  bulk_load(ring + s * K::CHUNK_BYTES, src, K::CHUNK_BYTES, &full[s]);
}

// After this warp's products on chunk g completed: release its ring stage;
// thread 0 refills the stage with chunk g + STAGES once every warp has
// released it
template <class K>
__device__ __forceinline__ void release_chunk(unsigned char* ring, const void* wpack, int g,
                                              uint64_t* full, uint64_t* empty, int lane) {
  const int s = g % K::STAGES;
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
  if (threadIdx.x == 0 && g + K::STAGES < K::NSEQ) {
    mbar_wait(&empty[s], (g / K::STAGES) & 1);
    load_chunk<K>(ring, wpack, g + K::STAGES, full);
  }
  __syncwarp();
}

// Thread 0 sets up the barriers and starts the input tile's TMA load and the
// first STAGES weight chunks; the block then meets
template <class K>
__device__ __forceinline__ void start_block(void* xs, const CUtensorMap* xmap, int tx0, int ty0, int b,
                                            unsigned char* ring, const void* wpack, uint64_t* xbar,
                                            uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K::NWG * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(xbar, K::X_BYTES);
    tma_load_5d(xs, xmap, 0, 0, tx0 - 2, ty0 - 2, b, xbar);
    for (int g = 0; g < K::STAGES && g < K::NSEQ; ++g) load_chunk<K>(ring, wpack, g, full);
  }
  __syncthreads();
}

// This lane's ldmatrix row for each unit of conv1 (over the tile plus its
// halo; units first, first + 1, ... of the warpgroup) and of conv2 (over the
// tile): the source-tile pixel of tap (0, 0). Rows past conv1's region read
// pixel 0; their sums are dropped.
template <class K, int U>
__device__ __forceinline__ void conv1_rows(int (&rowpix)[U], int first, int wg, int wq, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int mt = unit_of<K, K::MT1, K::NS1>(wg, first + u) / K::NS1;
    const int r = mt * 64 + 16 * wq + (lane & 15);
    rowpix[u] = r < K::R1 ? (r / K::YW) * K::XW + r % K::YW : 0;
  }
}

template <class K>
__device__ __forceinline__ void conv2_rows(int (&rowpix)[K::U2], int wg, int wq, int lane) {
#pragma unroll
  for (int u = 0; u < K::U2; ++u) {
    const int mt = unit_of<K, K::MT2, K::NS2>(wg, u) / K::NS2;
    const int r = mt * 64 + 16 * wq + (lane & 15);
    rowpix[u] = (r / K::TW) * K::YW + r % K::TW;
  }
}

// --------------------------------------------------------------- bfloat16

// One convolution of a warpgroup: its U units (m64 tile, N slice) over the
// NCH weight chunks starting at ring chunk g0. `rowpix[u]` is this lane's
// ldmatrix row for its unit.
template <class K, int NN, int NS, int MT, int U>
__device__ __forceinline__ void conv_pass(const bf16* src, int src_w, const int (&rowpix)[U],
                                          float (&acc)[U][NN / 2], unsigned char* ring,
                                          const bf16* wpack, uint64_t* full, uint64_t* empty,
                                          int g0, int wg, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < NN / 2; ++i) acc[u][i] = 0.f;
  }
  const uint32_t src_addr = smem_u32(src) + (lane >> 4) * 16;  // k 0-7 or 8-15 of a k16 step
  const uint32_t ring_addr = smem_u32(ring);
  for (int c = 0; c < K::NCH; ++c) {
    const int g = g0 + c, s = g % K::STAGES;
    const int tap = c / K::KCS, kc = c % K::KCS;
    const int toff = (tap / 3) * src_w + tap % 3;
    uint32_t a[K::KCH / 16][U][4];
#pragma unroll
    for (int ks = 0; ks < K::KCH / 16; ++ks) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ldmatrix_x4(a[ks][u], src_addr + ((rowpix[u] + toff) * K::PSE + kc * K::KCH + ks * 16) * 2);
      }
    }
    mbar_wait(&full[s], (g / K::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < K::KCH / 16; ++ks) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ns = unit_of<K, MT, NS>(wg, u) % NS;
        const uint32_t b_addr =
            ring_addr + s * K::CHUNK_BYTES + (ks * (K::CP / 8) + ns * (NN / 8)) * 2 * 128;
        wgmma<NN>(acc[u], a[ks][u], make_desc(b_addr));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<NN, U>(acc);
    release_chunk<K>(ring, wpack, g, full, empty, lane);
  }
}

template <int CP>
__global__ void __launch_bounds__(Cfg<CP>::THREADS, 1) bf16_block_kernel(
    const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ wpack,
    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C) {
  using K = Cfg<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                  // [XH * XW][PSE]
  bf16* ys = reinterpret_cast<bf16*>(smem + K::X_BYTES);     // [R1][PSE]
  unsigned char* ring = smem + K::RING_OFF;                  // [STAGES][CHUNK_BYTES]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + K::BAR_OFF);
  uint64_t* full = xbar + 1;
  uint64_t* empty = full + K::STAGES;
  const int tx0 = blockIdx.x * K::TW, ty0 = blockIdx.y * K::TH, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  start_block<K>(xs, &xmap, tx0, ty0, b, ring, wpack, xbar, full, empty);

  // warpgroup wg, warp wq of it; accumulator row of this lane (and +8)
  // within an m64 tile: 16 * wq + lane / 4
  const int wg = warp >> 2, wq = warp & 3;
  const int g_row = 16 * wq + (lane >> 2), g_col = (lane & 3) * 2;

  // conv1 over the tile plus its 1-pixel halo
  {
    int rowpix[K::U1];
    conv1_rows<K, K::U1>(rowpix, 0, wg, wq, lane);
    float acc[K::U1][K::NN1 / 2];
    mbar_wait(xbar, 0);
    conv_pass<K, K::NN1, K::NS1, K::MT1, K::U1>(xs, K::XW, rowpix, acc, ring, wpack, full, empty, 0, wg,
                                                lane);
#pragma unroll
    for (int u = 0; u < K::U1; ++u) {
      const int unit = wg + u * K::NWG;
      if (unit >= K::MT1 * K::NS1) continue;
      const int mt = unit / K::NS1, n0 = (unit % K::NS1) * K::NN1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 64 + g_row + 8 * h;
        if (r >= K::R1) continue;
        const int gy = ty0 - 1 + r / K::YW, gx = tx0 - 1 + r % K::YW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int i = 0; i < K::NN1 / 8; ++i) {
          const int n = n0 + 8 * i + g_col;
          const float v0 = inside ? fmaxf(acc[u][4 * i + 2 * h] + bias[n], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[u][4 * i + 2 * h + 1] + bias[n + 1], 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(ys + r * K::PSE + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();  // ys complete

  // conv2 over the tile, bias, residual, ReLU
  {
    int rowpix[K::U2];
    conv2_rows<K>(rowpix, wg, wq, lane);
    float acc[K::U2][K::NN2 / 2];
    conv_pass<K, K::NN2, K::NS2, K::MT2, K::U2>(ys, K::YW, rowpix, acc, ring, wpack, full, empty,
                                                K::NCH, wg, lane);
    const float* b2 = bias + CP;
#pragma unroll
    for (int u = 0; u < K::U2; ++u) {
      const int unit = wg + u * K::NWG;
      if (unit >= K::MT2 * K::NS2) continue;
      const int mt = unit / K::NS2, n0 = (unit % K::NS2) * K::NN2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 64 + g_row + 8 * h;
        const int oy = r / K::TW, ox = r % K::TW, gy = ty0 + oy, gx = tx0 + ox;
        if (gy >= H || gx >= W) continue;
        const bf16* res = xs + ((oy + 2) * K::XW + ox + 2) * K::PSE;
        bf16* dst = out + (((size_t)b * H + gy) * W + gx) * C;
#pragma unroll
        for (int i = 0; i < K::NN2 / 8; ++i) {
          const int n = n0 + 8 * i + g_col;
          if (n >= C) continue;
          const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + n));
          const float z0 = (acc[u][4 * i + 2 * h] + b2[n]) + xr.x;
          const float z1 = (acc[u][4 * i + 2 * h + 1] + b2[n + 1]) + xr.y;
          *reinterpret_cast<__nv_bfloat162*>(dst + n) =
              __floats2bfloat162_rn(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
        }
      }
    }
  }
}

// ---------------------------------------------------------- float32, 3xTF32

// The float32 A fragment in `hi` -> hi = each word rounded to tf32 (to
// nearest, ties away from zero), lo = word - hi (exact)
__device__ __forceinline__ void split_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __uint_as_float(hi[i]);
    uint32_t h;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(a));
    lo[i] = __float_as_uint(a - __uint_as_float(h));
    hi[i] = h;
  }
}

// One convolution of a warpgroup, as conv_pass, for its units first,
// first + 1, ...: each k8 step of a chunk is three products, A lo x B hi,
// A hi x B lo (into a second accumulator if K::DUAL), A hi x B hi
template <class K, int NN, int NS, int MT, int U>
__device__ __forceinline__ void tf32_conv_pass(const float* src, int src_w, const int (&rowpix)[U],
                                               float (&acc)[U][NN / 2], unsigned char* ring,
                                               const float* wpack, uint64_t* full, uint64_t* empty,
                                               int g0, int first, int wg, int lane) {
  float small[U][K::DUAL ? NN / 2 : 1];  // unused without DUAL
  (void)small;
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < NN / 2; ++i) {
      acc[u][i] = 0.f;
      if constexpr (K::DUAL) small[u][i] = 0.f;
    }
  }
  const uint32_t src_addr = smem_u32(src) + (lane >> 4) * 16;  // k 0-3 or 4-7 of a k8 step
  const uint32_t ring_addr = smem_u32(ring);
  for (int c = 0; c < K::NCH; ++c) {
    const int g = g0 + c, s = g % K::STAGES;
    const int tap = c / K::KCS, kc = c % K::KCS;
    const int toff = (tap / 3) * src_w + tap % 3;
    uint32_t hi[K::KS][U][4], lo[K::KS][U][4];
#pragma unroll
    for (int ks = 0; ks < K::KS; ++ks) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ldmatrix_x4(hi[ks][u], src_addr + ((rowpix[u] + toff) * K::PSE + kc * K::KCH + ks * 8) * 4);
        split_tf32(hi[ks][u], lo[ks][u]);
      }
    }
    mbar_wait(&full[s], (g / K::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < K::KS; ++ks) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ns = unit_of<K, MT, NS>(wg, first + u) % NS;
        const uint32_t b_hi =
            ring_addr + s * K::CHUNK_BYTES + 2 * ks * K::STEP_BYTES + ns * (NN / 8) * 2 * 128;
        const uint64_t desc_hi = make_desc(b_hi), desc_lo = make_desc(b_hi + K::STEP_BYTES);
        if constexpr (K::DUAL) {
          wgmma_tf32<NN>(small[u], lo[ks][u], desc_hi);
          wgmma_tf32<NN>(small[u], hi[ks][u], desc_lo);
        } else {
          wgmma_tf32<NN>(acc[u], lo[ks][u], desc_hi);
          wgmma_tf32<NN>(acc[u], hi[ks][u], desc_lo);
        }
        wgmma_tf32<NN>(acc[u], hi[ks][u], desc_hi);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<NN, U>(acc);
    if constexpr (K::DUAL) fence_acc<NN, U>(small);
    release_chunk<K>(ring, wpack, g, full, empty, lane);
  }
  if constexpr (K::DUAL) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < NN / 2; ++i) acc[u][i] += small[u][i];
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(F32Cfg<CP>::THREADS, 1) tf32_block_kernel(
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
    const float* __restrict__ wpack, const float* __restrict__ bias, float* __restrict__ out, int H,
    int W, int C) {
  using K = F32Cfg<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [XH * XW][PSE]; after conv1 its output [R1][PSE]
  unsigned char* ring = smem + K::RING_OFF;    // [STAGES][CHUNK_BYTES]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + K::BAR_OFF);
  uint64_t* full = xbar + 1;
  uint64_t* empty = full + K::STAGES;
  const int tx0 = blockIdx.x * K::TW, ty0 = blockIdx.y * K::TH, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  start_block<K>(xs, &xmap, tx0, ty0, b, ring, wpack, xbar, full, empty);

  const int wg = warp >> 2, wq = warp & 3;
  const int g_row = 16 * wq + (lane >> 2), g_col = (lane & 3) * 2;

  // conv1 over the tile plus its 1-pixel halo, in P1 passes; each pass's
  // output goes over the input tile, where it covers only pixels that no
  // later pass reads (conv1 row r reads input pixels from r on)
  mbar_wait(xbar, 0);
#pragma unroll
  for (int p = 0; p < K::P1; ++p) {
    int rowpix[K::U1P];
    conv1_rows<K, K::U1P>(rowpix, p * K::U1P, wg, wq, lane);
    float acc[K::U1P][K::NN1 / 2];
    tf32_conv_pass<K, K::NN1, K::NS1, K::MT1, K::U1P>(xs, K::XW, rowpix, acc, ring, wpack, full, empty,
                                                      p * K::NCH, p * K::U1P, wg, lane);
    __syncthreads();  // every warp has read the input pixels this pass's output covers
#pragma unroll
    for (int u = 0; u < K::U1P; ++u) {
      const int unit = wg + (p * K::U1P + u) * K::NWG;
      if (unit >= K::MT1 * K::NS1) continue;
      const int mt = unit / K::NS1, n0 = (unit % K::NS1) * K::NN1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 64 + g_row + 8 * h;
        if (r >= K::R1) continue;
        const int gy = ty0 - 1 + r / K::YW, gx = tx0 - 1 + r % K::YW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int i = 0; i < K::NN1 / 8; ++i) {
          const int n = n0 + 8 * i + g_col;
          const float v0 = inside ? fmaxf(acc[u][4 * i + 2 * h] + bias[n], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[u][4 * i + 2 * h + 1] + bias[n + 1], 0.f) : 0.f;
          *reinterpret_cast<float2*>(xs + r * K::PSE + n) = make_float2(v0, v1);
        }
      }
    }
  }
  __syncthreads();  // conv1's output complete

  // conv2 over the tile, bias, residual (from x), ReLU
  {
    int rowpix[K::U2];
    conv2_rows<K>(rowpix, wg, wq, lane);
    float acc[K::U2][K::NN2 / 2];
    tf32_conv_pass<K, K::NN2, K::NS2, K::MT2, K::U2>(xs, K::YW, rowpix, acc, ring, wpack, full, empty,
                                                     K::P1 * K::NCH, 0, wg, lane);
    const float* b2 = bias + CP;
#pragma unroll
    for (int u = 0; u < K::U2; ++u) {
      const int unit = wg + u * K::NWG;
      if (unit >= K::MT2 * K::NS2) continue;
      const int mt = unit / K::NS2, n0 = (unit % K::NS2) * K::NN2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 64 + g_row + 8 * h;
        const int gy = ty0 + r / K::TW, gx = tx0 + r % K::TW;
        if (gy >= H || gx >= W) continue;
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        const float* res = x + pix * C;
        float* dst = out + pix * C;
#pragma unroll
        for (int i = 0; i < K::NN2 / 8; ++i) {
          const int n = n0 + 8 * i + g_col;
          if (n >= C) continue;
          const float2 xr = __ldg(reinterpret_cast<const float2*>(res + n));
          const float z0 = (acc[u][4 * i + 2 * h] + b2[n]) + xr.x;
          const float z1 = (acc[u][4 * i + 2 * h + 1] + b2[n + 1]) + xr.y;
          *reinterpret_cast<float2*>(dst + n) = make_float2(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of the input tiles of kernel config K: x [B, H, W, Cx] of
// `elem`-byte elements as [B, H, W, Cx / G, G] (G elements = 16 bytes),
// innermost first; the box has one G-channel group more than CP, past the
// tensor: zero filled
template <class K>
int encode_x_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* x, int B, int H,
                 int W, int Cx) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int g = 16 / elem;
  const cuuint64_t dims[5] = {(cuuint64_t)g, (cuuint64_t)(Cx / g), (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {16, (cuuint64_t)Cx * elem, (cuuint64_t)W * Cx * elem,
                                 (cuuint64_t)H * W * Cx * elem};
  const cuuint32_t box[5] = {(cuuint32_t)g, (cuuint32_t)(K::CP / g + 1), K::XW, K::XH, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, 5, const_cast<void*>(x), dims, strides, box, elem_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int CP>
int launch_bf16(const void* x, const void* wpack, const float* bias, void* out, int B, int H, int W,
                int C, int Cx, cudaStream_t stream) {
  using K = Cfg<CP>;
  CUtensorMap map;
  int err = encode_x_map<K>(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, W, Cx);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(bf16_block_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  K::SMEM);
  if (err != 0) return err;
  const dim3 grid((W + K::TW - 1) / K::TW, (H + K::TH - 1) / K::TH, B);
  bf16_block_kernel<CP><<<grid, K::THREADS, K::SMEM, stream>>>(
      map, static_cast<const bf16*>(wpack), bias, static_cast<bf16*>(out), H, W, C);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_tf32(const float* x, const float* wpack, const float* bias, float* out, int B, int H,
                int W, int C, cudaStream_t stream) {
  using K = F32Cfg<CP>;
  CUtensorMap map;
  int err = encode_x_map<K>(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, H, W, C);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(tf32_block_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  K::SMEM);
  if (err != 0) return err;
  const dim3 grid((W + K::TW - 1) / K::TW, (H + K::TH - 1) / K::TH, B);
  tf32_block_kernel<CP><<<grid, K::THREADS, K::SMEM, stream>>>(map, x, wpack, bias, out, H, W, C);
  return (int)cudaGetLastError();
}

// The compiled tile of config K and its kernel: TH, TW, KCH, STAGES, conv1
// passes, DUAL, shared bytes, threads, and the blocks an SM can hold (the
// occupancy calculator's)
template <class K, class Kernel>
int tile_of(Kernel kernel, int* info) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, K::THREADS, K::SMEM);
  const int values[9] = {K::TH, K::TW, K::KCH, K::STAGES, K::P1, K::DUAL, K::SMEM, K::THREADS, blocks};
  for (int i = 0; i < 9; ++i) info[i] = values[i];
  return err;
}

}  // namespace

// float32: x, out [B, H, W, C]; wpack the hi and lo tf32 parts of both
// convs' weights in k8-step order (pack_block_weights(..., float32)), bias
// [2, CP] f32 (b1, b2, zero past C); CP in {16, 32, 64, 128, 256}, C a
// multiple of 4, C <= CP. Returns the launch's cudaError_t.
extern "C" int launch_fused_basic_block(const float* x, const float* wpack, const float* bias,
                                        float* out, int B, int H, int W, int C, int CP,
                                        cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 4 || C % 4 != 0 || C > CP) {
    return (int)cudaErrorInvalidValue;
  }
  switch (CP) {
    case 16: return launch_tf32<16>(x, wpack, bias, out, B, H, W, C, stream);
    case 32: return launch_tf32<32>(x, wpack, bias, out, B, H, W, C, stream);
    case 64: return launch_tf32<64>(x, wpack, bias, out, B, H, W, C, stream);
    case 128: return launch_tf32<128>(x, wpack, bias, out, B, H, W, C, stream);
    case 256: return launch_tf32<256>(x, wpack, bias, out, B, H, W, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16: x [B, H, W, Cx] (Cx = C rounded up to a multiple of 8, the
// channels past C zero), out [B, H, W, C]; wpack the bf16 weights of both
// convs in chunk order (pack_block_weights), bias [2, CP] f32 (b1, b2, zero
// past C); CP in {16, 32, 64, 128, 256}, C <= CP. Returns the launch's
// cudaError_t.
extern "C" int launch_fused_basic_block_bf16(const void* x, const void* wpack, const float* bias,
                                             void* out, int B, int H, int W, int C, int Cx, int CP,
                                             cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 4 || C % 4 != 0 || C > CP || Cx % 8 != 0 ||
      Cx < C || Cx > CP) {
    return (int)cudaErrorInvalidValue;
  }
  switch (CP) {
    case 16: return launch_bf16<16>(x, wpack, bias, out, B, H, W, C, Cx, stream);
    case 32: return launch_bf16<32>(x, wpack, bias, out, B, H, W, C, Cx, stream);
    case 64: return launch_bf16<64>(x, wpack, bias, out, B, H, W, C, Cx, stream);
    case 128: return launch_bf16<128>(x, wpack, bias, out, B, H, W, C, Cx, stream);
    case 256: return launch_bf16<256>(x, wpack, bias, out, B, H, W, C, Cx, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled tile of the instance for CP padded channels (float32 when
// f32 is non-zero, else bfloat16) into info[9]: TH, TW, KCH, STAGES, conv1
// passes, DUAL, shared bytes, threads, blocks an SM. Returns a cudaError_t.
extern "C" int fused_basic_block_tile(int CP, int f32, int* info) {
#define TILE_OF(CP_) \
  f32 ? tile_of<F32Cfg<CP_>>(tf32_block_kernel<CP_>, info) : tile_of<Cfg<CP_>>(bf16_block_kernel<CP_>, info)
  switch (CP) {
    case 16: return TILE_OF(16);
    case 32: return TILE_OF(32);
    case 64: return TILE_OF(64);
    case 128: return TILE_OF(128);
    case 256: return TILE_OF(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TILE_OF
}
