// Refine argmax on a phase-layout heatmap, with the quarter-resolution tag
// maps upsampled 4x inside the kernel.
//
// Replaces: human_pose_tpu/ops/pallas_aggregate.py::refine_argmax_phase_batch
// (kernel _refine_phase_kernel), which upsamples the tag planes into 16 phase
// planes in TPU VMEM and keeps lane-wise (diff, linear index) carries over the
// 16 heatmap phase planes.
//
// For each (image b, joint k, person p) -- all P persons, no skip:
//   idx[b,k,p] = argmax over full-resolution (y, x) of
//                hm(y, x) - rint(sqrt(sum_e (tag_e(y, x) - prev[b,p,e])^2))
// with ties to the lowest y*W + x, and val[b,k,p] = hm at idx. hm(y, x) is
// avg_phase[b, k, y%4, x%4, y/4, x/4]; tag_e(y, x) is the 4x
// align_corners=False upsample of tags_lo[b, k, e], rows first then along the
// row, with the taps (i-1, i) for phases 0, 1 and (i, i+1) for phases 2, 3 and
// the weights (0.375, 0.625), (0.125, 0.875), (0.875, 0.125), (0.625, 0.375);
// an edge tap collapses to an exact copy. The distance is sqrt of the summed
// squares even when E == 1 (the JAX kernel's form; the dense refine uses |d|).
// Built with --fmad=false and without fast math, so every value is the plain
// version's float32 operation sequence; rintf rounds halves to even like
// torch.round.
//
// What bounds it on the H100: operations. At B=24, K=17, H4=W4=128, P=30,
// E=1 it reads ~0.46 GB (~0.14 ms at 3.35 TB/s) but evaluates 3.2e9
// (pixel, person) pairs at 3E+4 float32 operations each (~2.2e10, ~0.33 ms at
// 67 TFLOP/s); the running (max, index) selects add several instructions per
// pair on top of those.
//
// Design: one block per (k, b). The block copies the E quarter-resolution tag
// planes into shared memory (64 KB a plane at 128x128) and streams the 16
// heatmap phase planes once, one thread per cell, so loads are coalesced; each
// thread upsamples its cell's tags from shared memory and keeps a running
// (best diff, lowest linear index) per person in registers. The phase order
// is not row-major, so every comparison carries the index explicitly, and the
// block then merges per person on (diff desc, index asc) as in
// refine_argmax.cu.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__constant__ float UP4_WL[4] = {0.375f, 0.125f, 0.875f, 0.625f};
__constant__ float UP4_WR[4] = {0.625f, 0.875f, 0.125f, 0.375f};

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// tag plane T [H4, W4] upsampled 4x at full-resolution (4i+ry, 4j+rx)
__device__ __forceinline__ float up4(const float* T, int i, int j, int ry, int rx, int H4, int W4) {
  auto rows = [&](int c) {
    const float wl = UP4_WL[ry], wr = UP4_WR[ry];
    if (ry < 2) return i == 0 ? T[c] : wl * T[(i - 1) * W4 + c] + wr * T[i * W4 + c];
    return i == H4 - 1 ? T[i * W4 + c] : wl * T[i * W4 + c] + wr * T[(i + 1) * W4 + c];
  };
  const float wl = UP4_WL[rx], wr = UP4_WR[rx];
  if (rx < 2) return j == 0 ? rows(0) : wl * rows(j - 1) + wr * rows(j);
  return j == W4 - 1 ? rows(j) : wl * rows(j) + wr * rows(j + 1);
}

template <int E>
__global__ void __launch_bounds__(THREADS) refine_phase_kernel(
    const float* __restrict__ avg, const float* __restrict__ tags_lo, const float* __restrict__ prev,
    int* __restrict__ idx, float* __restrict__ val, int K, int H4, int W4, int P) {
  const int k = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW4 = H4 * W4, W = 4 * W4;
  const int none = 16 * HW4;  // the JAX kernel's "no position" index
  const size_t map = (size_t)b * K + k;

  extern __shared__ float tag_s[];  // [E][H4 * W4]
  __shared__ float prev_s[MAXP][E];
  __shared__ float red_v[WARPS][MAXP];
  __shared__ int red_i[WARPS][MAXP];

  const float* tl = tags_lo + map * E * HW4;
  for (int t = tid; t < E * HW4; t += THREADS) tag_s[t] = tl[t];
  for (int t = tid; t < P * E; t += THREADS) prev_s[t / E][t % E] = prev[(size_t)b * P * E + t];
  __syncthreads();

  const float* hm = avg + map * 16 * HW4;
  float best[MAXP];
  int besti[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    best[p] = -INFINITY;
    besti[p] = none;
  }
  for (int t = tid; t < 16 * HW4; t += THREADS) {
    const int plane = t / HW4, cell = t - plane * HW4, i = cell / W4, j = cell - i * W4;
    const int ry = plane >> 2, rx = plane & 3;
    const int lin = (4 * i + ry) * W + 4 * j + rx;
    const float hv = hm[t];
    float tv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) tv[e] = up4(tag_s + e * HW4, i, j, ry, rx, H4, W4);
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      if (p >= P) break;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = tv[e] - prev_s[p][e];
        acc = acc + d * d;
      }
      const float diff = hv - rintf(sqrtf(acc));
      argmax_merge(best[p], besti[p], diff, lin);
    }
  }
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;
    float v = best[p];
    int i = besti[p];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      argmax_merge(v, i, ov, oi);
    }
    if (lane == 0) {
      red_v[warp][p] = v;
      red_i[warp][p] = i;
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) {
    float v = red_v[0][p];
    int i = red_i[0][p];
    for (int w = 1; w < WARPS; ++w) argmax_merge(v, i, red_v[w][p], red_i[w][p]);
    const int y = i / W, x = i - y * W;
    idx[map * P + p] = i;
    val[map * P + p] =
        i < none ? hm[((y & 3) * 4 + (x & 3)) * HW4 + (y >> 2) * W4 + (x >> 2)] : -INFINITY;
  }
}

template <int E>
int launch(const float* avg, const float* tags_lo, const float* prev, int* idx, float* val, int B,
           int K, int H4, int W4, int P, cudaStream_t stream) {
  const size_t smem = (size_t)E * H4 * W4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(refine_phase_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  refine_phase_kernel<E><<<dim3(K, B), THREADS, smem, stream>>>(avg, tags_lo, prev, idx, val, K, H4,
                                                                W4, P);
  return (int)cudaGetLastError();
}

}  // namespace

// avg_phase [B, K, 4, 4, H4, W4] f32, tags_lo [B, K, E, H4, W4] f32,
// prev [B, P, E] f32 -> idx [B, K, P] i32 (full-resolution y*4*W4 + x),
// val [B, K, P] f32. Returns the launch's cudaError_t.
extern "C" int launch_refine_argmax_phase(const float* avg, const float* tags_lo, const float* prev,
                                          int* idx, float* val, int B, int K, int H4, int W4, int E,
                                          int P, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || H4 < 1 || W4 < 1 || P < 1 || P > MAXP) {
    return (int)cudaErrorInvalidValue;
  }
  switch (E) {
    case 1: return launch<1>(avg, tags_lo, prev, idx, val, B, K, H4, W4, P, stream);
    case 2: return launch<2>(avg, tags_lo, prev, idx, val, B, K, H4, W4, P, stream);
    case 3: return launch<3>(avg, tags_lo, prev, idx, val, B, K, H4, W4, P, stream);
    case 4: return launch<4>(avg, tags_lo, prev, idx, val, B, K, H4, W4, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
