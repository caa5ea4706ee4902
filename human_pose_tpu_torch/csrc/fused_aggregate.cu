// Fused decode front end: stage average, two 2x upsamples, 5x5 NMS and row
// maxima in one pass.
//
// Replaces: human_pose_tpu/ops/pallas_aggregate.py::fused_aggregate (kernel
// _aggregate_kernel), which runs the chain per (image, joint) in TPU VMEM as
// phase-plane rolls and selects so that the VPU lanes stay full.
//
// For each (image b, joint k), with q the quarter-resolution stage and h2 the
// half-resolution one:
//   A   = up2_cols(up2_rows(q))                       (half resolution)
//   C   = (A + h2) * 0.5
//   F   = up2_cols(up2_rows(C))                       (full resolution)
//   sup = F where F equals its 5x5 window maximum (out-of-map = -inf), else 0
// where up2 is the 2x align_corners=False upsample out[2u] = 0.25*M[u-1] +
// 0.75*M[u], out[2u+1] = 0.75*M[u] + 0.25*M[u+1], each edge output an exact
// copy. F and sup are written in the 4x4 phase layout
// [B, K, 4, 4, H4, W4] (value at (y, x) in plane (y%4, x%4), cell (y/4, x/4))
// and cmax[b, k, ry, i] is the maximum of sup's full-resolution row 4i+ry.
// Every value is the same float32 operation sequence as the plain version
// (no fused multiply-add: the build uses --fmad=false), so the outputs are
// bit-equal to it.
//
// What bounds it on the H100: bytes. At B=24, K=17, H4=W4=128 it reads 134 MB
// (q and h2) and writes 856 MB (two full-resolution maps): ~0.30 ms at
// 3.35 TB/s, against ~1e9 float32 operations (~0.02 ms at 67 TFLOP/s).
//
// Design: one block per (quarter-resolution row i, k, b), i.e. four
// full-resolution rows. The block builds the half-resolution rows it needs
// (2i-2 .. 2i+3) in shared memory, then the full-resolution rows 4i-2 ..
// 4i+5 (the NMS's 2-row halo; rows outside the map are -inf), takes the
// vertical then the horizontal 5-max in shared memory, and writes each phase
// plane's row i with one thread per output cell, so neighbouring threads
// write neighbouring addresses. The writes are the bound; the halo rows are
// recomputed by the neighbouring blocks (2x on the full-resolution rows),
// which costs arithmetic, not bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

// out[o] of a 2x upsample of a length-n line read through at(index)
template <typename At>
__device__ __forceinline__ float up2(At at, int o, int n) {
  const int u = o >> 1;
  if ((o & 1) == 0) return u == 0 ? at(0) : 0.25f * at(u - 1) + 0.75f * at(u);
  return u == n - 1 ? at(u) : 0.75f * at(u) + 0.25f * at(u + 1);
}

__global__ void __launch_bounds__(THREADS) aggregate_kernel(
    const float* __restrict__ q, const float* __restrict__ h2, float* __restrict__ avg,
    float* __restrict__ sup, float* __restrict__ cmax, int K, int H4, int W4) {
  const int i = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int H2 = 2 * H4, W2 = 2 * W4, H = 4 * H4, W = 4 * W4;
  const int u0 = 2 * i - 2;  // first half-resolution row held
  const int y0 = 4 * i - 2;  // first full-resolution row held
  const size_t map = (size_t)b * K + k;

  extern __shared__ float smem[];
  float* Cs = smem;        // [6][W2] averaged half-resolution rows u0 ..
  float* Fs = Cs + 6 * W2;  // [8][W]  full-resolution rows y0 ..
  float* Ps = Fs + 8 * W;   // [4][W]  vertical 5-max of rows 4i .. 4i+3
  float* Ss = Ps + 4 * W;   // [4][W]  sup of rows 4i .. 4i+3

  const float* qm = q + map * H4 * W4;
  const float* hm = h2 + map * H2 * W2;
  for (int t = threadIdx.x; t < 6 * W2; t += THREADS) {
    const int lu = t / W2, v = t - lu * W2, u = u0 + lu;
    if (u < 0 || u >= H2) continue;
    auto rows = [&](int j) { return up2([&](int r) { return qm[(size_t)r * W4 + j]; }, u, H4); };
    const float a = up2(rows, v, W4);
    Cs[t] = (a + hm[(size_t)u * W2 + v]) * 0.5f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 8 * W; t += THREADS) {
    const int ly = t / W, x = t - ly * W, y = y0 + ly;
    if (y < 0 || y >= H) {
      Fs[t] = -INFINITY;
      continue;
    }
    auto rows = [&](int v) { return up2([&](int u) { return Cs[(u - u0) * W2 + v]; }, y, H2); };
    Fs[t] = up2(rows, x, W2);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 4 * W; t += THREADS) {
    float m = Fs[t];
    for (int d = 1; d < 5; ++d) m = fmaxf(m, Fs[t + d * W]);
    Ps[t] = m;
  }
  __syncthreads();
  const size_t plane_sz = (size_t)H4 * W4;
  for (int t = threadIdx.x; t < 16 * W4; t += THREADS) {
    const int plane = t / W4, j = t - plane * W4, ry = plane >> 2, rx = plane & 3;
    const int x = 4 * j + rx;
    const float f = Fs[(ry + 2) * W + x];
    float m = -INFINITY;
    for (int xx = max(x - 2, 0); xx <= min(x + 2, W - 1); ++xx) m = fmaxf(m, Ps[ry * W + xx]);
    const float s = m == f ? f : 0.f;
    const size_t o = (map * 16 + plane) * plane_sz + (size_t)i * W4 + j;
    avg[o] = f;
    sup[o] = s;
    Ss[ry * W + x] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    float m = -INFINITY;
    for (int x = lane; x < W; x += 32) m = fmaxf(m, Ss[warp * W + x]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) cmax[(map * 4 + warp) * H4 + i] = m;
  }
}

}  // namespace

// q [B, K, H4, W4] f32, h2 [B, K, 2*H4, 2*W4] f32 -> avg, sup [B, K, 4, 4, H4, W4]
// f32, cmax [B, K, 4, H4] f32. Returns the launch's cudaError_t.
extern "C" int launch_fused_aggregate(const float* q, const float* h2, float* avg, float* sup,
                                      float* cmax, int B, int K, int H4, int W4,
                                      cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H4 < 1 || W4 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * 2 * W4 + 16 * 4 * W4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  aggregate_kernel<<<dim3(H4, K, B), THREADS, smem, stream>>>(q, h2, avg, sup, cmax, K, H4, W4);
  return (int)cudaGetLastError();
}
