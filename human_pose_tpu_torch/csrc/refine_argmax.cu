// Refine argmax of the associative-embedding decode.
//
// Replaces: human_pose_tpu/ops/pallas_decode.py::refine_argmax_batch
// (kernels _refine_kernel / _refine_chunk), which streams each joint's maps
// through TPU VMEM in row tiles and keeps lane-wise running (max, first row)
// accumulators for a chunk of 8 persons.
//
// For each (image b, joint k, person p < counts[b]):
//   idx[b,k,p] = argmax_i  hm[b,k,i] - rint(||tags[b,k,:,i] - prev[b,p,:]||)
// the first maximum in row-major order; |d| when E == 1, else sqrt of the
// squares summed over e in index order. Persons p >= counts[b] get 0.
//
// What bounds it on the H100: bytes and operations about equally. The maps
// are read once, B*K*(1+E)*HW*4 bytes (856 MB at B=24, K=17, E=1, 512x512:
// ~0.26 ms at 3.35 TB/s), while every pixel costs ~5 fp32 operations per
// active person (30 persons in every image: ~16 GOP, ~0.24 ms at the
// 67 TFLOP/s peak that counts an FMA as two operations; none of these fuse).
// Counted as instructions (the two selects that keep the running (max,
// index) pair, the shared-memory tag reads, the loop) the update issues
// several times more than its FLOPs, so instruction issue sets the pace.
//
// Design: one block per (k, b) streams its row once with coalesced loads;
// each thread keeps a running (best diff, first index) per active person in
// registers (the person loop is unrolled to MAXP and exits at counts[b]), and
// the block then reduces per person on (diff desc, index asc), which keeps
// the first-maximum rule across threads. Person tags sit in shared memory
// (broadcast reads). Images with few persons do proportionally less work.
// Built with --fmad=false and without fast math: rintf rounds halves to even
// like torch.round, and the squared-distance sum is not fused.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS) refine_kernel(
    const float* __restrict__ hm, const float* __restrict__ tags, const float* __restrict__ prev,
    const int* __restrict__ counts, int* __restrict__ idx, int K, int HW, int P) {
  const int k = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = max(0, min(counts[b], P));
  int* out = idx + ((size_t)b * K + k) * P;

  __shared__ float prev_s[MAXP][E];
  __shared__ float red_v[WARPS][MAXP];
  __shared__ int red_i[WARPS][MAXP];

  for (int i = tid; i < cnt * E; i += THREADS) prev_s[i / E][i % E] = prev[(size_t)b * P * E + i];
  __syncthreads();

  const float* h = hm + ((size_t)b * K + k) * HW;
  const float* t = tags + ((size_t)b * K + k) * E * HW;
  float best[MAXP];
  int besti[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    best[p] = -INFINITY;
    besti[p] = 0;
  }
  if (cnt > 0) {
    for (int i = tid; i < HW; i += THREADS) {
      const float hv = h[i];
      float tv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) tv[e] = t[(size_t)e * HW + i];
#pragma unroll
      for (int p = 0; p < MAXP; ++p) {
        if (p >= cnt) break;
        float dist;
        if (E == 1) {
          dist = fabsf(tv[0] - prev_s[p][0]);
        } else {
          float d2 = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = tv[e] - prev_s[p][e];
            d2 = d2 + d * d;
          }
          dist = sqrtf(d2);
        }
        const float diff = hv - rintf(dist);
        if (diff > best[p]) {  // strict: this thread's earlier pixel wins ties
          best[p] = diff;
          besti[p] = i;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= cnt) break;
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
    if (p >= cnt) {
      out[p] = 0;
      continue;
    }
    float v = red_v[0][p];
    int i = red_i[0][p];
    for (int w = 1; w < WARPS; ++w) argmax_merge(v, i, red_v[w][p], red_i[w][p]);
    out[p] = i;
  }
}

template <int E>
int launch(const float* hm, const float* tags, const float* prev, const int* counts, int* idx,
           int B, int K, int HW, int P, cudaStream_t stream) {
  refine_kernel<E><<<dim3(K, B), THREADS, 0, stream>>>(hm, tags, prev, counts, idx, K, HW, P);
  return (int)cudaGetLastError();
}

}  // namespace

// hm [B, K, HW] f32, tags [B, K, E, HW] f32, prev [B, P, E] f32, counts [B] i32
// -> idx [B, K, P] i32. Returns the launch's cudaError_t.
extern "C" int launch_refine_argmax(const float* hm, const float* tags, const float* prev,
                                    const int* counts, int* idx, int B, int K, int HW, int E,
                                    int P, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || HW < 1 || P < 1 || P > MAXP) return (int)cudaErrorInvalidValue;
  switch (E) {
    case 1: return launch<1>(hm, tags, prev, counts, idx, B, K, HW, P, stream);
    case 2: return launch<2>(hm, tags, prev, counts, idx, B, K, HW, P, stream);
    case 3: return launch<3>(hm, tags, prev, counts, idx, B, K, HW, P, stream);
    case 4: return launch<4>(hm, tags, prev, counts, idx, B, K, HW, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
