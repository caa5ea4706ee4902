// BatchNorm's batch-statistics backward for bf16 and fp16 inputs in NCHW: the
// gradient of x in x's dtype and the float32 gradients of the weight and the
// bias, in two launches.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm to flax and
// XLA. Added because PyTorch's NCHW backward (batch_norm_backward_kernel)
// runs one block per channel, each walking all N*H*W elements of its channel
// twice, and HRNet keeps few channels at large maps: 73% of a HigherHRNet-W32
// training step's BatchNorm elements sit in layers of 32-64 channels, so
// 32-64 blocks run on a card of 132 SMs. Beside it the port summed the
// float32 parameter gradients in four more full-size passes.
//
// What bounds it on the H100: device-memory bytes. The gradient needs two
// passes over a channel: a reduce that reads x and dy (4 B an element in
// bf16) for sum(dy) and sum(dy * (x - mean)), and an apply that reads them
// again and writes dx (6 B): 10 B an element from device memory where x and
// dy exceed the 50 MB L2, 43.4 GB a HigherHRNet-W32 step at bs36 and 512^2,
// 13.0 ms at 3.35 TB/s. The L2 can serve up to its size of the apply's
// second read: 6 B an element for a layer whose x and dy fit in it, 50 MB
// less for any other, which takes the step's bound to 10.1 ms. A few float
// operations an element are far below the card's rate.
//
// Design: both kernels run a grid of channel x split. The wrapper
// (ops/cuda_norm.py::splits) takes the number of splits S from the shape:
// enough blocks to fill every SM twice at full occupancy, and at least 4
// vectors a thread so that a block's loads hide the memory's latency; S is 1
// where the channels alone fill the card. Split s of a channel walks the
// s-th contiguous slice of the channel's N planes (its element i at plane
// i / HW, position i % HW; offsets in 64 bits) in vectors of 8 elements, one
// 16-byte load each of x and dy, where HW is a multiple of 8 and every base
// is 16-byte aligned, and of one element otherwise. The reduce sums its
// slice in float32, reduces the two sums with warp shuffles and shared
// memory, and writes one pair to a float32 [C, S, 2] scratch. Each block of
// the apply sums its channel's S pairs in one fixed order, so every block of
// a channel holds the same bits; the block of split 0 writes grad_b =
// sum(dy) and grad_w = invstd * sum(dy * (x - mean)); every block writes
// dx = (dy - sum(dy) / n - (x - mean) * invstd^2 * sum(dy * (x - mean)) / n)
// * invstd * w, in float32 and rounded once to x's dtype. No float atomics:
// each sum has a fixed order, so a training step repeats bit for bit. With
// no dx wanted the apply runs one block a channel and writes the two
// parameter gradients only.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Bf16 {
  static __device__ __forceinline__ float to_float(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ unsigned short from_float(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct Fp16 {
  static __device__ __forceinline__ float to_float(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ unsigned short from_float(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// VEC elements at p (16-byte aligned when VEC is 8) as floats
template <class D, int VEC>
__device__ __forceinline__ void load(const unsigned short* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = D::to_float((unsigned short)(w[i] & 0xffffu));
      v[2 * i + 1] = D::to_float((unsigned short)(w[i] >> 16));
    }
  } else {
    v[0] = D::to_float(p[0]);
  }
}

// VEC floats rounded to D's type, stored at p (16-byte aligned when VEC is 8)
template <class D, int VEC>
__device__ __forceinline__ void store(unsigned short* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (unsigned)D::from_float(v[2 * i]) | ((unsigned)D::from_float(v[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    p[0] = D::from_float(v[0]);
  }
}

// element offset of vector v of channel c: plane v / hwv, vector v % hwv in it
template <int VEC>
__device__ __forceinline__ long long offset(unsigned v, unsigned hwv, int c, int C) {
  const unsigned n = v / hwv;
  const unsigned p = v - n * hwv;
  return ((long long)n * C + c) * ((long long)hwv * VEC) + (long long)p * VEC;
}

// [begin, end): split s of `splits` of a channel's `vectors` vectors
__device__ __forceinline__ void slice(unsigned vectors, int s, int splits, unsigned& begin,
                                      unsigned& end) {
  begin = (unsigned)((unsigned long long)vectors * s / splits);
  end = (unsigned)((unsigned long long)vectors * (s + 1) / splits);
}

// the block's sum of v, the same bits on every thread (a fixed tree)
__device__ __forceinline__ float2 block_sum(float2 v) {
  __shared__ float2 warp_sums[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(FULL, v.x, o);
      v.y += __shfl_xor_sync(FULL, v.y, o);
    }
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

// partial[c * S + s] = (sum dy, sum dy * (x - mean)) over split s of channel c
template <class D, int VEC>
__global__ void __launch_bounds__(THREADS)
hp_batch_norm_backward_reduce(const unsigned short* __restrict__ x,
                              const unsigned short* __restrict__ dy,
                              const float* __restrict__ mean, float2* __restrict__ partial,
                              int C, unsigned hwv, unsigned vectors) {
  const int c = blockIdx.x, s = blockIdx.y, splits = gridDim.y;
  unsigned begin, end;
  slice(vectors, s, splits, begin, end);
  const float m = mean[c];
  float sum_dy = 0.f, sum_dy_xmu = 0.f;
#pragma unroll 2
  for (unsigned v = begin + threadIdx.x; v < end; v += THREADS) {
    const long long o = offset<VEC>(v, hwv, c, C);
    float xv[VEC], gv[VEC];
    load<D, VEC>(x + o, xv);
    load<D, VEC>(dy + o, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sum_dy += gv[i];
      sum_dy_xmu = fmaf(gv[i], xv[i] - m, sum_dy_xmu);
    }
  }
  const float2 tot = block_sum(make_float2(sum_dy, sum_dy_xmu));
  if (threadIdx.x == 0) partial[(long long)c * splits + s] = tot;
}

// the parameter gradients (split 0) and, with dx, dx over split s of channel c
template <class D, int VEC>
__global__ void __launch_bounds__(THREADS)
hp_batch_norm_backward_apply(const unsigned short* __restrict__ x,
                             const unsigned short* __restrict__ dy,
                             const float* __restrict__ mean, const float* __restrict__ invstd,
                             const float* __restrict__ weight, const float2* __restrict__ partial,
                             int partials, unsigned short* __restrict__ dx,
                             float* __restrict__ grad_w, float* __restrict__ grad_b, int C,
                             unsigned hwv, unsigned vectors, float inv_count) {
  const int c = blockIdx.x, s = blockIdx.y;
  float2 t = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < partials; i += THREADS) {
    const float2 p = partial[(long long)c * partials + i];
    t.x += p.x;
    t.y += p.y;
  }
  const float2 tot = block_sum(t);
  const float is = invstd[c];
  if (s == 0 && threadIdx.x == 0) {
    grad_b[c] = tot.x;
    grad_w[c] = tot.y * is;
  }
  if (dx == nullptr) return;
  const float mean_dy = tot.x * inv_count;
  const float proj = tot.y * inv_count * is * is;
  const float scale = is * weight[c];
  const float m = mean[c];
  unsigned begin, end;
  slice(vectors, s, gridDim.y, begin, end);
#pragma unroll 2
  for (unsigned v = begin + threadIdx.x; v < end; v += THREADS) {
    const long long o = offset<VEC>(v, hwv, c, C);
    float xv[VEC], gv[VEC];
    load<D, VEC>(x + o, xv);
    load<D, VEC>(dy + o, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) gv[i] = (gv[i] - mean_dy - (xv[i] - m) * proj) * scale;
    store<D, VEC>(dx + o, gv);
  }
}

template <class D, int VEC>
int launch(const void* x, const void* dy, const float* mean, const float* invstd,
           const float* weight, float* partial, void* dx, float* grad_w, float* grad_b, int C,
           unsigned hwv, unsigned vectors, int splits, float inv_count, cudaStream_t stream) {
  const auto* xs = static_cast<const unsigned short*>(x);
  const auto* dys = static_cast<const unsigned short*>(dy);
  auto* pairs = reinterpret_cast<float2*>(partial);
  const dim3 grid(C, splits);
  hp_batch_norm_backward_reduce<D, VEC><<<grid, THREADS, 0, stream>>>(xs, dys, mean, pairs, C,
                                                                     hwv, vectors);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hp_batch_norm_backward_apply<D, VEC><<<dx ? grid : dim3(C, 1), THREADS, 0, stream>>>(
      xs, dys, mean, invstd, weight, pairs, splits, static_cast<unsigned short*>(dx), grad_w,
      grad_b, C, hwv, vectors, inv_count);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return p == nullptr || (uintptr_t)p % bytes == 0; }

}  // namespace

// x, dy (and dx, or null for no dx): [N, C, HW] contiguous, bf16 (fp16 = 0)
// or fp16 (fp16 = 1); mean, invstd, weight: float32 [C]; partial: float32
// [C, splits, 2] scratch; grad_w, grad_b: float32 [C]. vec (8 or 1) elements
// a load: 8 needs HW % 8 == 0 and x, dy, dx 16-byte aligned.
extern "C" int launch_batch_norm_backward(const void* x, const void* dy, const float* mean,
                                          const float* invstd, const float* weight,
                                          float* partial, void* dx, float* grad_w,
                                          float* grad_b, int N, int C, int HW, int splits,
                                          float inv_count, int fp16, int vec,
                                          cudaStream_t stream) {
  const long long count = (long long)N * HW;
  if (N < 1 || C < 1 || HW < 1 || count > 0xffffffffLL || splits < 1 || splits > 65535 ||
      (vec != 8 && vec != 1) || HW % vec != 0 || !aligned(x, 2 * vec) ||
      !aligned(dy, 2 * vec) || !aligned(dx, 2 * vec) || (fp16 != 0 && fp16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned hwv = (unsigned)(HW / vec), vectors = (unsigned)(count / vec);
  if (fp16) {
    return vec == 8 ? launch<Fp16, 8>(x, dy, mean, invstd, weight, partial, dx, grad_w, grad_b,
                                      C, hwv, vectors, splits, inv_count, stream)
                    : launch<Fp16, 1>(x, dy, mean, invstd, weight, partial, dx, grad_w, grad_b,
                                      C, hwv, vectors, splits, inv_count, stream);
  }
  return vec == 8 ? launch<Bf16, 8>(x, dy, mean, invstd, weight, partial, dx, grad_w, grad_b, C,
                                    hwv, vectors, splits, inv_count, stream)
                  : launch<Bf16, 1>(x, dy, mean, invstd, weight, partial, dx, grad_w, grad_b, C,
                                    hwv, vectors, splits, inv_count, stream);
}
