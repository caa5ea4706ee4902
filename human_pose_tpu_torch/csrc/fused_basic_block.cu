// Fused inference BasicBlock with BatchNorm folded into the convolutions.
//
// Replaces: human_pose_tpu/ops/pallas_conv.py::fused_basic_block (kernel
// _kernel), which runs both 3x3 convolutions of a row tile as nine shifted
// tap matmuls on the TPU MXU, with the conv1 output kept in VMEM.
//
//   y   = relu(conv3x3(x, w1) + b1), zero outside the image, cast to x's type
//   out = relu(conv3x3(y, w2) + b2 + x)
// x and out [B, H, W, C] NHWC in float32 or bfloat16, w1, w2 [3, 3, C, C]
// HWIO float32 (BN folded), b1, b2 [C] float32; accumulation in float32 (an
// explicit fmaf per tap, in ci order within each tap, taps in (dy, dx)
// order), residual added in float32.
//
// What bounds it on the H100: operations. One block at every HRNet-W32
// branch shape (C=32 at 128x128, 64 at 64x64, 128 at 32x32, 256 at 16x16)
// is 2 * 9 * C * C * H * W * 2 = 1.45e10 FLOP at batch 24: 0.22 ms at the
// 67 TFLOP/s float32 CUDA-core peak (far less on bf16 tensor cores), against
// 2 * 24 * 128 * 128 * 32 * 4 = 0.1 GB of activations (0.03 ms).
//
// Design: a direct convolution on CUDA cores, simple first. One block per
// (TH x TW output tile, image): it stages the input tile with a 2-pixel
// halo in shared memory (zero outside the image), computes conv1 over the
// tile plus a 1-pixel halo into shared memory (zeroed outside the image,
// which is conv2's SAME padding), then conv2, the residual and the ReLU.
// Thread t owns output channel t % C for the pixels t / C, t / C + G, ...
// (G = 256 / C groups) and keeps 8 pixels' sums in registers; a warp's lanes
// read consecutive weights (coalesced) and the same input pixel (a shared
// memory broadcast, four channels per 16-byte load). The tile shrinks as C
// grows so that the block's shared memory stays near 100 KB (two blocks an
// SM); the halo's conv1 outputs are computed by both neighbours.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RP = 8;  // output pixels per thread per pass
constexpr size_t SMEM_TARGET = 110 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

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

template <typename T>
__global__ void __launch_bounds__(THREADS) basic_block_kernel(
    const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H, int W,
    int C, int TH, int TW) {
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH, b = blockIdx.z;
  const int XW = TW + 4, XH = TH + 4, YW = TW + 2, YH = TH + 2;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [XH * XW][C] input, rows ty0-2 .., cols tx0-2 ..
  float* ys = xs + XH * XW * C;      // [YH * YW][C] conv1, rows ty0-1 .., cols tx0-1 ..
  const T* xb = x + (size_t)b * H * W * C;

  for (int t = threadIdx.x; t < XH * XW * C; t += THREADS) {
    const int c = t % C, pix = t / C, gy = ty0 - 2 + pix / XW, gx = tx0 - 2 + pix % XW;
    xs[t] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? to_f(xb[((size_t)gy * W + gx) * C + c]) : 0.f;
  }
  __syncthreads();

  const int G = THREADS / C, co = threadIdx.x % C, pg = threadIdx.x / C;
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
        const float yv = inside ? fmaxf(acc[r] + b1[co], 0.f) : 0.f;
        ys[p * C + co] = to_f(from_f<T>(yv));
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
        out[((size_t)b * H * W + (size_t)gy * W + gx) * C + co] = from_f<T>(fmaxf(z, 0.f));
      }
    }
  }
}

size_t smem_bytes(int C, int th, int tw) {
  return (size_t)((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * C * sizeof(float);
}

template <typename T>
int launch(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
           void* out, int B, int H, int W, int C, cudaStream_t stream) {
  static const int tiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}};
  int th = 2, tw = 2;
  for (const auto& t : tiles) {
    if (smem_bytes(C, t[0], t[1]) <= SMEM_TARGET) {
      th = t[0];
      tw = t[1];
      break;
    }
  }
  const size_t smem = smem_bytes(C, th, tw);
  cudaError_t err = cudaFuncSetAttribute(basic_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  basic_block_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), w1, b1, w2, b2,
                                                         static_cast<T*>(out), H, W, C, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, H, W, C] (float32 when bf16 == 0, bfloat16 when 1); w1, w2
// [3, 3, C, C] f32; b1, b2 [C] f32. C a multiple of 4, at most 256. Returns
// the launch's cudaError_t.
extern "C" int launch_fused_basic_block(const void* x, const float* w1, const float* b1,
                                        const float* w2, const float* b2, void* out, int B, int H,
                                        int W, int C, int bf16, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 4 || C > THREADS || C % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, C, stream);
  return launch<float>(x, w1, b1, w2, b2, out, B, H, W, C, stream);
}
