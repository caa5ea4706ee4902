// Sequential associative-embedding grouping: one warp per image, with the
// Hungarian solver's state in registers.
//
// Replaces: human_pose_tpu/ops/pallas_match.py::match_by_tag_pallas_batched
// (kernel _match_kernel_batched), which runs the whole grouping of a batch in
// one TPU grid cell with the Hungarian's loops predicated per image, and
// match_by_tag_pallas (_match_kernel, one image per grid cell).
//
// What bounds it on the H100: latency, not bytes or FLOPs. Per image it reads
// K*M*(3+E) floats (~10 KB) but runs K joint steps, each with up to M
// augmenting paths of up to M+1 dependent argmin steps: a chain of several
// thousand dependent reductions. There is no meaningful roofline; the cost of
// one step of the chain is the whole story.
//
// Design: one warp per image (one 32-thread block each, so the B images run
// on separate SMs and the decode pays the longest image's chain). Lane l owns
// the assignment columns l, l+32, .. (Q of them, Q = ceil((max(M,P)+1)/32) a
// template parameter; Q = 1 at M = P = 30): each column's potential v, its
// minv, its "used" flag, its way, its matched row and that row's potential u
// live in registers (a row's u travels with its column when a path is
// augmented), so `u[row] += delta` is a register add on the used columns. A
// step of the solver is: relax the lane's own columns (cost rows in per-warp
// shared memory, indexed [row][column], so the 32 lanes read 32 banks); take
// the lane's minimum over its columns in ascending order with a strict <;
// one redux.sync over the value's order key gives the warp's least value on
// every lane, a second one over (column, row) among the lanes holding it the
// lowest such column and its row; a __shfl_sync brings that row's u. No __syncthreads, no shared
// memory round trip. Augmenting walks `way` by shuffles; new persons take
// slots count + popc(newmask below me), one lane per candidate. The person
// mean tags are divided once per joint step, not once per (row, person)
// pair: the same float operation, so the same bits.
//
// Each argmin is ordered on (value, column), so ties go to the lowest column
// exactly like the plain solver (ops/hungarian.py). Rows with
// score <= det_thr are skipped in candidate order and there is no
// column-reduction initialisation, so the assignment, not just its cost,
// equals the plain version's. The float operations are the plain solver's in
// its order: cur = cost - u[i0] - v, minv -= delta, u += delta, v -= delta.
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

constexpr int MAX_M = 32;      // candidate rows per joint: one row per lane
constexpr int MAX_COLS = 127;  // person (+pad) columns; +1 virtual column = 4 columns a lane
constexpr int MAX_E = 8;
constexpr int MAX_F = 3 + MAX_E;
constexpr float BIG = 1e18f;   // "infinity" of the solver, as in the plain version
constexpr unsigned FULL = 0xffffffffu;

// A float's order as an unsigned key (and back), so that one redux.sync
// takes a warp's minimum. Exact for the solver's values: they are finite and
// never -0 (costs are rint(dist) * 100 - score or the positive pad, and a
// difference or sum is -0 only when an operand already is).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float(k ^ (~(unsigned)((int)k >> 31) | 0x80000000u));
}

// a float from the shared-memory address addr (a 32-bit shared-window
// address computed once, so the solver's loop does no address conversion)
__device__ __forceinline__ float ld_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// value of the lane-private register array a at slot s (s uniform or not),
// without a runtime index into registers
template <int Q, typename T>
__device__ __forceinline__ T pick(const T (&a)[Q], int s) {
  T out = a[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    if (q == s) out = a[q];
  }
  return out;
}

// a[s] = val on this lane
template <int Q, typename T>
__device__ __forceinline__ void put(T (&a)[Q], int s, T val) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q == s) a[q] = val;
  }
}

// the value column j holds in the per-column register array a, on every lane
template <int Q, typename T>
__device__ __forceinline__ T column(const T (&a)[Q], int j) {
  return __shfl_sync(FULL, pick<Q>(a, j >> 5), j & 31);
}

template <int Q>
__global__ void __launch_bounds__(32) match_kernel(
    const float* __restrict__ cand, const int* __restrict__ order, float* __restrict__ joints,
    int* __restrict__ count_out, int K, int M, int E, int P, float det_thr, float tag_thr) {
  const int F = 3 + E;
  const int NC = max(M, P);  // assignment columns: persons, then pad columns
  const int VC = NC;         // the virtual column
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lanes_below = (1u << lane) - 1u;

  __shared__ float cand_s[MAX_M][MAX_F];
  __shared__ float dist_s[MAX_M][32 * Q];
  __shared__ float cost_s[MAX_M][32 * Q];
  __shared__ float tag_sum[32 * Q][MAX_E];
  __shared__ float tag_cnt[32 * Q];

  // cost_s[r][lane + 32 q] is at cost_lane + (r * 32 Q + 32 q) * 4
  const unsigned cost_lane = static_cast<unsigned>(__cvta_generic_to_shared(&cost_s[0][lane]));
  float* out = joints + (size_t)b * P * K * F;
  for (int i = lane; i < P * K * F; i += 32) out[i] = 0.f;
  for (int i = lane; i < 32 * Q * MAX_E; i += 32) tag_sum[i / MAX_E][i % MAX_E] = 0.f;
  for (int i = lane; i < 32 * Q; i += 32) tag_cnt[i] = 0.f;
  int count = 0;  // uniform across the warp

  for (int s = 0; s < K; ++s) {
    const int idx = order[s];  // original joint id of this step
    const float* c = cand + ((size_t)b * K + s) * M * F;
    __syncwarp();
    for (int i = lane; i < M * F; i += 32) cand_s[i / F][i % F] = c[i];
    __syncwarp();
    const unsigned validmask = __ballot_sync(FULL, lane < M && cand_s[lane][2] > det_thr);

    // distances and costs of every row to this lane's existing persons; the
    // mean tag of a person is divided once (the plain version's operation)
    float mx = -BIG;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int p = lane + 32 * q;
      if (p >= count) continue;
      const float cnt = fmaxf(tag_cnt[p], 1.f);
      float mean[MAX_E];
#pragma unroll
      for (int e = 0; e < MAX_E; ++e) mean[e] = e < E ? tag_sum[p][e] / cnt : 0.f;
      for (int m = 0; m < M; ++m) {
        float d2 = 0.f;
#pragma unroll
        for (int e = 0; e < MAX_E; ++e) {
          if (e < E) {
            const float d = cand_s[m][3 + e] - mean[e];
            d2 = d2 + d * d;
          }
        }
        const float dist = sqrtf(d2);
        const float cost = rintf(dist) * 100.f - cand_s[m][2];
        dist_s[m][p] = dist;
        cost_s[m][p] = cost;
        if ((validmask >> m) & 1u) mx = fmaxf(mx, cost);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    // pad just above the largest real cost
    const float pad = mx > -BIG * 0.5f ? fabsf(mx) * 2.f + 100.f : 100.f;
    __syncwarp();

    // Hungarian: valid rows in candidate order, columns on lanes. Each
    // column also carries the potential u of its matched row (upm), so the
    // row of the argmin column and its u arrive in one pair of shuffles.
    float v[Q], minv[Q], upm[Q];
    int pm[Q], way[Q];  // row+1 matched to each column (0 = free), the path
    bool used[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      v[q] = 0.f;
      upm[q] = 0.f;
      pm[q] = 0;
    }
    for (unsigned rows = validmask; rows; rows &= rows - 1) {
      const int m = __ffs(rows) - 1;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        minv[q] = BIG;
        used[q] = false;
        way[q] = VC;
        if (lane + 32 * q == VC) {  // the virtual column holds row m, u[m] = 0
          pm[q] = m + 1;
          upm[q] = 0.f;
        }
      }
      int j0 = VC, i0 = m + 1;  // the newest used column and its row
      float ui0 = 0.f;
      while (true) {
        if ((j0 & 31) == lane) put<Q>(used, j0 >> 5, true);
        float bv = BIG;
        int bj = lane, bpm = pm[0];  // the lane's least column and its row
#pragma unroll
        for (int q = 0; q < Q; ++q) {  // branch-free: every lane loads, live columns update
          const int j = lane + 32 * q;
          const bool live = j < NC && !used[q];
          const float c = ld_shared(cost_lane + ((i0 - 1) * 32 * Q + 32 * q) * 4);
          const float cur = (j < count ? c : pad) - ui0 - v[q];
          if (live && cur < minv[q]) {
            minv[q] = cur;
            way[q] = j0;
          }
          if (live && minv[q] < bv) {
            bv = minv[q];
            bj = j;
            bpm = pm[q];
          }
        }
        // argmin over (value, column): the least value, then the lowest
        // column, which comes with its row in the low byte
        const unsigned key = ordered(bv);
        const unsigned least = __reduce_min_sync(FULL, key);
        const unsigned win = __reduce_min_sync(FULL, key == least ? (unsigned)(bj << 8 | bpm) : ~0u);
        const int j1 = (int)(win >> 8), i1 = (int)(win & 0xffu);
        const float delta = unordered(least);
        const float u1 = column<Q>(upm, j1);  // j1 is not used: u1 does not change below
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (used[q]) {
            upm[q] += delta;  // rows of used columns
            v[q] -= delta;
          } else if (lane + 32 * q < NC) {
            minv[q] -= delta;
          }
        }
        j0 = j1;
        if (i1 == 0) break;  // uniform: a free column ends the path
        i0 = i1;
        ui0 = u1;
      }
      // augment along the path: (pm, upm)[jj] = (pm, upm)[way[jj]] back to
      // the virtual column
      int jj = j0;
      while (jj != VC) {
        const int jn = column<Q>(way, jj);
        const int r = column<Q>(pm, jn);
        const float ur = column<Q>(upm, jn);
        if ((jj & 31) == lane) {
          put<Q>(pm, jj >> 5, r);
          put<Q>(upm, jj >> 5, ur);
        }
        jj = jn;
      }
    }

    // harvest matches to existing persons (tag_thr gates the raw distance)
    unsigned matched = 0u;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = lane + 32 * q;
      const int r = pm[q] - 1;
      if (j < count && r >= 0 && ((validmask >> r) & 1u) && dist_s[r][j] < tag_thr) {
        matched |= 1u << r;
        float* dst = out + ((size_t)j * K + idx) * F;
        for (int f = 0; f < F; ++f) dst[f] = cand_s[r][f];
        for (int e = 0; e < E; ++e) tag_sum[j][e] += cand_s[r][3 + e];
        tag_cnt[j] += 1.f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) matched |= __shfl_xor_sync(FULL, matched, off);
    // unmatched valid candidates found new persons, in candidate order
    const unsigned newmask = validmask & ~matched;
    if ((newmask >> lane) & 1u) {
      const int slot = count + __popc(newmask & lanes_below);
      if (slot < P) {
        float* dst = out + ((size_t)slot * K + idx) * F;
        for (int f = 0; f < F; ++f) dst[f] = cand_s[lane][f];
        for (int e = 0; e < E; ++e) tag_sum[slot][e] = cand_s[lane][3 + e];
        tag_cnt[slot] = 1.f;
      }
    }
    count = min(count + __popc(newmask), P);
  }
  if (lane == 0) count_out[b] = count;
}

template <int Q>
int launch(const float* cand, const int* order, float* joints, int* count, int B, int K, int M,
           int E, int P, float det_thr, float tag_thr, cudaStream_t stream) {
  match_kernel<Q><<<B, 32, 0, stream>>>(cand, order, joints, count, K, M, E, P, det_thr, tag_thr);
  return (int)cudaGetLastError();
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
  const int cols = (M > P ? M : P) + 1;  // persons and pad columns, and the virtual column
  switch ((cols + 31) / 32) {
    case 1: return launch<1>(cand, order, joints, count, B, K, M, E, P, det_thr, tag_thr, stream);
    case 2: return launch<2>(cand, order, joints, count, B, K, M, E, P, det_thr, tag_thr, stream);
    case 3: return launch<3>(cand, order, joints, count, B, K, M, E, P, det_thr, tag_thr, stream);
    default: return launch<4>(cand, order, joints, count, B, K, M, E, P, det_thr, tag_thr, stream);
  }
}
