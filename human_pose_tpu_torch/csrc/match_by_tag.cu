// Sequential associative-embedding grouping with an in-block Hungarian solver.
//
// Replaces: human_pose_tpu/ops/pallas_match.py::match_by_tag_pallas_batched
// (kernel _match_kernel_batched), which runs the whole grouping of a batch in
// one TPU grid cell with the Hungarian's loops predicated per image.
//
// What bounds it on the H100: latency, not bytes or FLOPs. Per image it reads
// K*M*(3+E) floats (~10 KB) but runs K joint steps, each with up to M
// augmenting paths of up to M+1 dependent argmin steps: a chain of a few
// thousand block-wide reductions, each a few hundred cycles of shuffles and
// __syncthreads. There is no meaningful roofline.
//
// Design: one thread block per image, so the B images run in parallel on
// separate SMs and the decode pays the longest image's chain, not the sum.
// The persons (plus pad columns up to max(M, P)) and the Hungarian's virtual
// column live on threads: thread j owns column j's potential v, its minv and
// its "used" flag in registers; cost and distance rows, row potentials u, the
// column->row match and the path "way" live in shared memory. Each argmin is a
// warp-shuffle reduction ordered on (value, column), so ties go to the lowest
// column exactly like the plain solver (ops/hungarian.py). Rows with
// score <= det_thr are skipped in candidate order and there is no
// column-reduction initialisation, so the assignment, not just its cost,
// equals the plain version's.
//
// Arithmetic parity traps: round() is rintf (halves to even, like torch.round
// and jnp.round; CUDA's roundf rounds halves away from zero); the squared
// distance is summed over e in index order from 0; the build uses
// --fmad=false and no fast math so no multiply-add is fused and sqrtf is
// IEEE-rounded. The pad of nonexistent-person columns is |max real|*2 + 100
// (100 when no real pair exists), never 1e10: float32 potentials would lose
// the cost structure.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_M = 32;      // candidate rows per joint
constexpr int MAX_COLS = 127;  // person (+pad) columns; +1 virtual column = 128 threads
constexpr int MAX_E = 8;
constexpr int MAX_F = 3 + MAX_E;
constexpr float BIG = 1e18f;   // "infinity" of the solver, as in the plain version

__device__ __forceinline__ void argmin_merge(float& v, int& j, float ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__global__ void match_kernel(const float* __restrict__ cand, const int* __restrict__ order,
                             float* __restrict__ joints, int* __restrict__ count_out,
                             int K, int M, int E, int P, float det_thr, float tag_thr) {
  const int F = 3 + E;
  const int NC = max(M, P);  // assignment columns: persons, then pad columns
  const int VC = NC;         // the virtual column
  const int b = blockIdx.x;
  const int j = threadIdx.x;  // this thread's column
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;

  __shared__ float cand_s[MAX_M][MAX_F];
  __shared__ float dist_s[MAX_M][MAX_COLS];
  __shared__ float cost_s[MAX_M][MAX_COLS];
  __shared__ float u_s[MAX_M];
  __shared__ int pm_s[MAX_COLS + 1];   // row+1 matched to each column, 0 = free
  __shared__ int way_s[MAX_COLS + 1];
  __shared__ float tag_sum[MAX_COLS][MAX_E];
  __shared__ float tag_cnt[MAX_COLS];
  __shared__ int valid_s[MAX_M];
  __shared__ int matched_row[MAX_M];
  __shared__ float red_v[4];
  __shared__ int red_j[4];
  __shared__ int count_s;

  float* out = joints + (size_t)b * P * K * F;
  for (int i = j; i < P * K * F; i += blockDim.x) out[i] = 0.f;
  for (int i = j; i < MAX_COLS * MAX_E; i += blockDim.x) tag_sum[i / MAX_E][i % MAX_E] = 0.f;
  for (int i = j; i < MAX_COLS; i += blockDim.x) tag_cnt[i] = 0.f;
  if (j == 0) count_s = 0;

  for (int s = 0; s < K; ++s) {
    const int idx = order[s];  // original joint id of this step
    const float* c = cand + ((size_t)b * K + s) * M * F;
    __syncthreads();
    for (int i = j; i < M * F; i += blockDim.x) cand_s[i / F][i % F] = c[i];
    __syncthreads();
    const int count = count_s;
    if (j < M) {
      valid_s[j] = cand_s[j][2] > det_thr;
      matched_row[j] = 0;
      u_s[j] = 0.f;
    }
    // distances and costs to the existing persons
    for (int i = j; i < M * count; i += blockDim.x) {
      const int m = i / count, p = i % count;
      const float cnt = fmaxf(tag_cnt[p], 1.f);
      float d2 = 0.f;
      for (int e = 0; e < E; ++e) {
        const float d = cand_s[m][3 + e] - tag_sum[p][e] / cnt;
        d2 = d2 + d * d;
      }
      const float dist = sqrtf(d2);
      dist_s[m][p] = dist;
      cost_s[m][p] = rintf(dist) * 100.f - cand_s[m][2];
    }
    __syncthreads();
    // pad just above the largest real cost
    float mx = -BIG;
    for (int i = j; i < M * count; i += blockDim.x) {
      const int m = i / count, p = i % count;
      if (valid_s[m]) mx = fmaxf(mx, cost_s[m][p]);
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
    if (lane == 0) red_v[warp] = mx;
    __syncthreads();
    mx = red_v[0];
    for (int w = 1; w < nwarps; ++w) mx = fmaxf(mx, red_v[w]);
    const float pad = mx > -BIG * 0.5f ? fabsf(mx) * 2.f + 100.f : 100.f;
    for (int i = j; i < M * (NC - count); i += blockDim.x) {
      cost_s[i / (NC - count)][count + i % (NC - count)] = pad;
    }
    if (j <= VC) pm_s[j] = 0;
    __syncthreads();

    // Hungarian: valid rows in candidate order, columns on threads
    float v = 0.f;
    for (int m = 0; m < M; ++m) {
      if (!valid_s[m]) continue;  // uniform: shared flag
      float minv = BIG;
      bool used = false;
      if (j <= VC) way_s[j] = VC;
      if (j == 0) pm_s[VC] = m + 1;
      int j0 = VC;
      __syncthreads();
      while (true) {
        const int i0 = pm_s[j0];
        if (i0 == 0) break;  // uniform: every thread read the same entry
        if (j == j0) used = true;
        const float ui0 = u_s[i0 - 1];
        float masked = BIG;
        if (j < NC && !used) {
          const float cur = cost_s[i0 - 1][j] - ui0 - v;
          if (cur < minv) {
            minv = cur;
            way_s[j] = j0;
          }
          masked = minv;
        }
        float bv = masked;
        int bj = j;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int oj = __shfl_down_sync(0xffffffffu, bj, off);
          argmin_merge(bv, bj, ov, oj);
        }
        if (lane == 0) {
          red_v[warp] = bv;
          red_j[warp] = bj;
        }
        __syncthreads();
        float delta = red_v[0];
        int j1 = red_j[0];
        for (int w = 1; w < nwarps; ++w) argmin_merge(delta, j1, red_v[w], red_j[w]);
        if (used) {
          u_s[pm_s[j] - 1] += delta;  // rows of used columns are distinct
          v -= delta;
        } else if (j < NC) {
          minv -= delta;
        }
        j0 = j1;
        __syncthreads();
      }
      if (j == 0) {  // augment along the path
        int jj = j0;
        while (jj != VC) {
          const int jn = way_s[jj];
          pm_s[jj] = pm_s[jn];
          jj = jn;
        }
      }
      __syncthreads();
    }

    // harvest matches to existing persons (tag_thr gates the raw distance)
    if (j < count) {
      const int r = pm_s[j] - 1;
      if (r >= 0 && valid_s[r] && dist_s[r][j] < tag_thr) {
        matched_row[r] = 1;
        float* dst = out + ((size_t)j * K + idx) * F;
        for (int f = 0; f < F; ++f) dst[f] = cand_s[r][f];
        for (int e = 0; e < E; ++e) tag_sum[j][e] += cand_s[r][3 + e];
        tag_cnt[j] += 1.f;
      }
    }
    __syncthreads();
    // unmatched valid candidates found new persons, in candidate order
    if (j == 0) {
      int n_new = 0;
      for (int m = 0; m < M; ++m) {
        if (!valid_s[m] || matched_row[m]) continue;
        const int slot = count + n_new++;
        if (slot >= P) continue;
        float* dst = out + ((size_t)slot * K + idx) * F;
        for (int f = 0; f < F; ++f) dst[f] = cand_s[m][f];
        for (int e = 0; e < E; ++e) tag_sum[slot][e] = cand_s[m][3 + e];
        tag_cnt[slot] = 1.f;
      }
      count_s = min(count + n_new, P);
    }
  }
  __syncthreads();
  if (j == 0) count_out[b] = count_s;
}

}  // namespace

// cand [B, K, M, 3+E] f32 in processing order, order [K] i32 (device) ->
// joints [B, P, K, 3+E] f32, count [B] i32. Returns the launch's cudaError_t.
extern "C" int launch_match_by_tag(const float* cand, const int* order, float* joints, int* count,
                                   int B, int K, int M, int E, int P, float det_thr, float tag_thr,
                                   cudaStream_t stream) {
  if (B < 1 || K < 1 || M < 1 || M > MAX_M || P < 1 || (M > P ? M : P) > MAX_COLS || E < 1 ||
      E > MAX_E) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = (M > P ? M : P) + 1;
  const int threads = (cols + 31) / 32 * 32;
  match_kernel<<<B, threads, 0, stream>>>(cand, order, joints, count, K, M, E, P, det_thr, tag_thr);
  return (int)cudaGetLastError();
}
