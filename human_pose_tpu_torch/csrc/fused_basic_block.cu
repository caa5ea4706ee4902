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
// bfloat16 x: tensor cores (bf16_block_kernel). Both convolutions are
// implicit GEMMs, one per tap: [pixels x C_in] . [C_in x C_out] with
// wgmma.mma_async m64nNk16, N = C_out (split in two for conv2 at C >= 128),
// accumulated in float32 registers. Channels are padded to CP (16, 32, 64,
// 128 or 256) with zero weights.
//  - A (64 pixels x 16 channels of the tap-shifted window) comes from
//    registers, loaded by ldmatrix.x4 with one row address per pixel, so any
//    pixel of the tile can be a row. Tile pixels are CP + 8 channels apart (an
//    odd number of 16-byte units), so the 8 rows of an 8x8 matrix fall on 8
//    distinct bank groups.
//  - B is the tap's [C_in-chunk x C_out] bf16 weights, pre-packed by the
//    wrapper into wgmma's K-major core-matrix layout (no swizzle) and
//    streamed chunk by chunk (one tap, KCH input channels) through a ring
//    of STAGES shared-memory buffers by 1-D bulk copies on mbarriers: thread
//    0 refills a stage as soon as both warpgroups have released it, so the
//    next STAGES - 1 chunks are in flight while the warpgroups compute. (With
//    a separate producer warp, 9 warps a block, ptxas held the C = 256
//    instance to 166 registers and serialized its wgmma for lack of them.)
//  - The input tile and its 2-pixel halo come by one TMA load of a 5-D map
//    over x viewed as [B, H, W, C/8, 8]; TMA's out-of-bounds zero fill is
//    conv1's SAME padding, and the box's extra 8-channel group (past the
//    tensor) is the pixel stride's padding. The map is encoded with
//    cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint, so the
//    library needs no -lcuda.
//  - conv1 runs over the tile plus a 1-pixel halo (rows padded to a multiple
//    of 64) into shared memory as bf16, zero outside the image (conv2's
//    padding); conv2 reads its A fragments from there the same way. The
//    epilogue adds b2 and the residual (from the staged input tile), applies
//    the ReLU and stores bf16.
//  - Tile size trades conv1's halo recompute against parallelism: 16x16 at
//    C <= 32, 8x16 at C = 64, 8x8 at C >= 128.
//
// float32 x: a direct convolution on CUDA cores (f32_block_kernel), explicit
// fmaf per tap in ci order, taps in (dy, dx) order. One block per output tile
// stages the tile with a 2-pixel halo in shared memory (zero outside the
// image), computes conv1 over the tile plus a 1-pixel halo, then conv2, the
// residual and the ReLU. Thread t owns output channel t % C for the pixels
// t / C, t / C + G, ... (G = 256 / C) and keeps 8 pixels' sums in registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- float32

constexpr int F32_THREADS = 256;
constexpr int RP = 8;  // output pixels per thread per pass
constexpr size_t F32_SMEM_TARGET = 110 * 1024;

// Sums of a 3x3 convolution for output channel co at RP output pixels of a
// rows x cols region: pixel p = first + r * G reads the source tile src
// (width src_w, C channels a pixel) at (p / cols + dy, p % cols + dx).
__device__ __forceinline__ void conv3x3(const float* src, int src_w, const float* __restrict__ w,
                                        int C, int co, int cols, int n, int first, int G,
                                        float (&acc)[RP]) {
  int off[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int p = min(first + r * G, n - 1);
    off[r] = ((p / cols) * src_w + p % cols) * C;
    acc[r] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * src_w + tap % 3) * C;
    const float* wt = w + (size_t)tap * C * C + co;
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = wt[(size_t)ci * C], w1 = wt[(size_t)(ci + 1) * C];
      const float w2 = wt[(size_t)(ci + 2) * C], w3 = wt[(size_t)(ci + 3) * C];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(src + off[r] + toff + ci);
        acc[r] = fmaf(v.x, w0, acc[r]);
        acc[r] = fmaf(v.y, w1, acc[r]);
        acc[r] = fmaf(v.z, w2, acc[r]);
        acc[r] = fmaf(v.w, w3, acc[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS) f32_block_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int H,
    int W, int C, int TH, int TW) {
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH, b = blockIdx.z;
  const int XW = TW + 4, XH = TH + 4, YW = TW + 2, YH = TH + 2;
  extern __shared__ __align__(16) float smem_f32[];
  float* xs = smem_f32;              // [XH * XW][C] input, rows ty0-2 .., cols tx0-2 ..
  float* ys = xs + XH * XW * C;      // [YH * YW][C] conv1, rows ty0-1 .., cols tx0-1 ..
  const float* xb = x + (size_t)b * H * W * C;

  for (int t = threadIdx.x; t < XH * XW * C; t += F32_THREADS) {
    const int c = t % C, pix = t / C, gy = ty0 - 2 + pix / XW, gx = tx0 - 2 + pix % XW;
    xs[t] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xb[((size_t)gy * W + gx) * C + c] : 0.f;
  }
  __syncthreads();

  const int G = F32_THREADS / C, co = threadIdx.x % C, pg = threadIdx.x / C;
  float acc[RP];
  if (pg < G) {
    const int n = YH * YW;
    for (int first = pg; first < n; first += G * RP) {
      conv3x3(xs, XW, w1, C, co, YW, n, first, G, acc);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = first + r * G;
        if (p >= n) break;
        const int gy = ty0 - 1 + p / YW, gx = tx0 - 1 + p % YW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        ys[p * C + co] = inside ? fmaxf(acc[r] + b1[co], 0.f) : 0.f;
      }
    }
  }
  __syncthreads();
  if (pg < G) {
    const int n = TH * TW;
    for (int first = pg; first < n; first += G * RP) {
      conv3x3(ys, YW, w2, C, co, TW, n, first, G, acc);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = first + r * G;
        if (p >= n) break;
        const int ly = p / TW, lx = p % TW, gy = ty0 + ly, gx = tx0 + lx;
        if (gy >= H || gx >= W) continue;
        const float z = (acc[r] + b2[co]) + xs[((ly + 2) * XW + lx + 2) * C + co];
        out[((size_t)b * H * W + (size_t)gy * W + gx) * C + co] = fmaxf(z, 0.f);
      }
    }
  }
}

size_t f32_smem_bytes(int C, int th, int tw) {
  return (size_t)((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * C * sizeof(float);
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

// Tile and pipeline of the tensor-core kernel for CP padded channels.
template <int CP_, int TH_, int TW_, int KCH_, int STAGES_, int NS2_>
struct TileCfg {
  static constexpr int CP = CP_, TH = TH_, TW = TW_, KCH = KCH_, STAGES = STAGES_;
  static constexpr int NWG = 2;                      // warpgroups
  static constexpr int THREADS = NWG * 128;
  static constexpr int XH = TH + 4, XW = TW + 4;     // input tile with its 2-pixel halo
  static constexpr int YH = TH + 2, YW = TW + 2;     // conv1 output with its 1-pixel halo
  static constexpr int PSE = CP + 8;                 // pixel stride in shared memory, elements
  static constexpr int R1 = YH * YW, MT1 = (R1 + 63) / 64;  // conv1 rows and m64 tiles
  static constexpr int R2 = TH * TW, MT2 = R2 / 64;         // conv2 rows and m64 tiles
  static constexpr int NS1 = 1, NS2 = NS2_;          // N slices of each conv
  static constexpr int NN1 = CP / NS1, NN2 = CP / NS2;
  static constexpr int U1 = (MT1 * NS1 + NWG - 1) / NWG;  // units (m64 x NN) per warpgroup
  static constexpr int U2 = (MT2 * NS2 + NWG - 1) / NWG;
  static constexpr int KCS = CP / KCH;               // chunks per tap
  static constexpr int NCH = 9 * KCS;                // chunks per conv
  static constexpr int CHUNK_BYTES = KCH * CP * 2;
  static constexpr int X_BYTES = XH * XW * PSE * 2;
  static constexpr int Y_BYTES = R1 * PSE * 2;
  static constexpr int RING_OFF = (X_BYTES + Y_BYTES + 127) / 128 * 128;
  static constexpr int BAR_OFF = RING_OFF + STAGES * CHUNK_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES);
  static_assert(R2 % 64 == 0, "conv2 rows must fill m64 tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int CP> struct Cfg;
template <> struct Cfg<16> : TileCfg<16, 16, 16, 16, 8, 1> {};
template <> struct Cfg<32> : TileCfg<32, 16, 16, 32, 8, 1> {};
template <> struct Cfg<64> : TileCfg<64, 8, 16, 64, 4, 1> {};
template <> struct Cfg<128> : TileCfg<128, 8, 8, 64, 4, 2> {};
template <> struct Cfg<256> : TileCfg<256, 8, 8, 64, 3, 2> {};

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

// Shared-memory matrix descriptor of a K-major, unswizzled operand: 8x8
// core matrices of 128 contiguous bytes, LBO bytes apart along K and SBO
// bytes apart along N.
constexpr uint32_t DESC_LBO = 128, DESC_SBO = 256;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(DESC_LBO >> 4) << 16) |
         ((uint64_t)(DESC_SBO >> 4) << 32);
}

// d[8] += A (64 x 16, registers) * B (16 x 16, shared memory, K-major)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16] += A (64 x 16, registers) * B (16 x 32, shared memory, K-major)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, shared memory, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += A (64 x 16, registers) * B (16 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[128] += A (64 x 16, registers) * B (16 x 256, shared memory, K-major)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 16) wgmma_n16(d, a, desc_b);
  if constexpr (N == 32) wgmma_n32(d, a, desc_b);
  if constexpr (N == 64) wgmma_n64(d, a, desc_b);
  if constexpr (N == 128) wgmma_n128(d, a, desc_b);
  if constexpr (N == 256) wgmma_n256(d, a, desc_b);
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

// Weight chunk g (both convs' chunks in order) into its ring stage,
// completing on that stage's full barrier
template <class K>
__device__ __forceinline__ void load_chunk(unsigned char* ring, const bf16* wpack, int g,
                                           uint64_t* full) {
  const int s = g % K::STAGES;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack) + (size_t)g * K::CHUNK_BYTES;
  mbar_expect_tx(&full[s], K::CHUNK_BYTES);
  bulk_load(ring + s * K::CHUNK_BYTES, src, K::CHUNK_BYTES, &full[s]);
}

// One convolution of a warpgroup: its U units (m64 tile, N slice) over the
// NCH weight chunks starting at ring chunk g0. `rowpix[u]` is this lane's
// ldmatrix row: the source-tile pixel of tap (0, 0) for its unit's row.
// Rows past the conv's region read pixel 0; their sums are dropped.
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && g + K::STAGES < 2 * K::NCH) {  // refill once every warp left it
      mbar_wait(&empty[s], (g / K::STAGES) & 1);
      load_chunk<K>(ring, wpack, g + K::STAGES, full);
    }
    __syncwarp();
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

  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K::NWG * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the input tile, and the first STAGES weight chunks
    mbar_expect_tx(xbar, K::X_BYTES);
    tma_load_5d(xs, &xmap, 0, 0, tx0 - 2, ty0 - 2, b, xbar);
    for (int g = 0; g < K::STAGES && g < 2 * K::NCH; ++g) load_chunk<K>(ring, wpack, g, full);
  }
  __syncthreads();

  // warpgroup wg, warp wq of it; accumulator row of this lane (and +8)
  // within an m64 tile: 16 * wq + lane / 4
  const int wg = warp >> 2, wq = warp & 3;
  const int g_row = 16 * wq + (lane >> 2), g_col = (lane & 3) * 2;

  // conv1 over the tile plus its 1-pixel halo
  {
    int rowpix[K::U1];
#pragma unroll
    for (int u = 0; u < K::U1; ++u) {
      const int mt = unit_of<K, K::MT1, K::NS1>(wg, u) / K::NS1;
      const int r = mt * 64 + 16 * wq + (lane & 15);
      rowpix[u] = r < K::R1 ? (r / K::YW) * K::XW + r % K::YW : 0;
    }
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
#pragma unroll
    for (int u = 0; u < K::U2; ++u) {
      const int mt = unit_of<K, K::MT2, K::NS2>(wg, u) / K::NS2;
      const int r = mt * 64 + 16 * wq + (lane & 15);
      rowpix[u] = (r / K::TW) * K::YW + r % K::TW;
    }
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

template <int CP>
int launch_bf16(const void* x, const void* wpack, const float* bias, void* out, int B, int H, int W,
                int C, int Cx, cudaStream_t stream) {
  using K = Cfg<CP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x [B, H, W, Cx] as [B, H, W, Cx / 8, 8], innermost first; the box has
  // one 8-channel group more than CP, past the tensor: zero filled
  const cuuint64_t dims[5] = {8, (cuuint64_t)(Cx / 8), (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {16, (cuuint64_t)Cx * 2, (cuuint64_t)W * Cx * 2,
                                 (cuuint64_t)H * W * Cx * 2};
  const cuuint32_t box[5] = {8, CP / 8 + 1, K::XW, K::XH, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bf16_block_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + K::TW - 1) / K::TW, (H + K::TH - 1) / K::TH, B);
  bf16_block_kernel<CP><<<grid, K::THREADS, K::SMEM, stream>>>(
      map, static_cast<const bf16*>(wpack), bias, static_cast<bf16*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// float32: x, out [B, H, W, C]; w1, w2 [3, 3, C, C]; b1, b2 [C]. C a multiple
// of 4, at most 256. Returns the launch's cudaError_t.
extern "C" int launch_fused_basic_block(const float* x, const float* w1, const float* b1,
                                        const float* w2, const float* b2, float* out, int B, int H,
                                        int W, int C, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 4 || C > F32_THREADS || C % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  static const int tiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}};
  int th = 2, tw = 2;
  for (const auto& t : tiles) {
    if (f32_smem_bytes(C, t[0], t[1]) <= F32_SMEM_TARGET) {
      th = t[0];
      tw = t[1];
      break;
    }
  }
  const size_t smem = f32_smem_bytes(C, th, tw);
  cudaError_t err = cudaFuncSetAttribute(f32_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  f32_block_kernel<<<grid, F32_THREADS, smem, stream>>>(x, w1, b1, w2, b2, out, H, W, C, th, tw);
  return (int)cudaGetLastError();
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
