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
// squares even when E == 1 (the JAX kernel's form). Built with --fmad=false
// and without fast math, so every value is the plain version's float32
// operation sequence.
//
// What bounds it on the H100: instruction issue. At B=24, K=17, 512x512, P=30,
// E=1 it reads ~0.46 GB (~0.14 ms at 3.35 TB/s) but evaluates 3.2e9
// (pixel, person) pairs, none of whose operations fuse, so the count of
// instructions per pair sets the time. The design is the dense refine's
// (refine_argmax.cu) on the phase layout:
// * A thread's step is one 4-pixel GROUP: full-resolution row y, quarter-
//   resolution column j, pixels x = 4j..4j+3. Its heatmap values are four
//   scalar loads from the phase planes (y%4, 0..3) at cell (y/4, j), each
//   coalesced across a warp's consecutive j. The group index g = y*W4 + j
//   grows in row-major order and pixel x of it has the linear index 4g + x%4,
//   so the scan needs no (value, index) compare: the hot loop keeps only
//   (running maximum, first group that reached it) per person, branch-free.
//   The pixel inside the winning group is found once per (row, person) at the
//   end, by computing that group's four differences again with the same
//   arithmetic and taking the first that equals the maximum.
// * The upsample is done once per group, not per (pixel, person): the
//   vertical lerp of quarter columns j-1, j, j+1 (edges copied), then the four
//   horizontal lerps with weights fixed at compile time. The block's quarter-
//   resolution tag rows, one halo row on each side, sit in shared memory.
// * At E == 1 the distance is |d|, which equals sqrt(d*d) in IEEE float32
//   while d*d neither overflows nor underflows (and both round to 0 when d is
//   tiny). rint(x) is (x + 2^23) - 2^23, two adds that round halves to even
//   exactly for 0 <= x < 2^23, instead of the conversion-unit FRND. A group in
//   which an upsampled tag reaches 2^20, or a block whose person tags do,
//   takes a second instance of the loop that computes rintf(sqrtf(d*d)), the
//   JAX form (sqrt(d*d) is infinite when |d| >= 2^64, |d| is not). At E > 1
//   both instances take sqrtf of the squares summed from e = 0; the fast one
//   rounds by the two adds.
// * The person loop has no branch: it is compiled for every even count up to
//   32 at E == 1 and for 8, 16, 24, 32 at E > 1, and a block branches once
//   into the instance it needs. Persons that pad the count have a zero tag and
//   are never written.
// * The card is filled by splitting each (b, k) map's full-resolution rows
//   over S blocks of 256 threads (grid B*K x S). A block reduces its threads'
//   pairs with two warp reductions per person (the maximum of an order-
//   preserving integer key of the float, then the lowest group among the
//   lanes that hold it) and writes one (key, group) per person to scratch
//   memory the wrapper allocated; a second small kernel merges the S partial
//   pairs of a map on (key descending, group ascending), resolves the pixel
//   and writes idx and val. Both steps are independent of the order blocks
//   run in: the result is deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 32;     // persons a thread keeps in registers
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float TWO23 = 8388608.f;
// upsampled and person tags below this magnitude keep every distance below
// 2^23 for E <= 4: |d| < 2^21 per dim, the summed squares < 2^44
constexpr float SMALL_TAG = 1048576.f;  // 2^20

// the person loop is compiled for the multiples of this up to MAXP
template <int E>
constexpr int PERSON_STEP = E == 1 ? 2 : 8;

// integer key that orders like the float; v is never NaN here
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// rint(||tv - pv||) in the plain version's arithmetic. FAST: every tag is
// known to lie below SMALL_TAG, so |d| stands for sqrt(d*d) at E == 1 and
// adding and subtracting 2^23 rounds halves to even exactly.
template <int E, bool FAST>
__device__ __forceinline__ float rounded_distance(const float (&tv)[E], const float (&pv)[E]) {
  if (E == 1 && FAST) {
    const float x = fabsf(__fsub_rn(tv[0], pv[0]));
    return __fsub_rn(__fadd_rn(x, TWO23), TWO23);
  }
  float d2 = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float d = __fsub_rn(tv[e], pv[e]);
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  const float x = sqrtf(d2);
  return FAST ? __fsub_rn(__fadd_rn(x, TWO23), TWO23) : rintf(x);
}

// The quarter rows [q0, q0 + nq) that the lerps of full rows [y0, y1) read,
// one halo row a side: what a block stages. The launch checks with this same
// function that the shared memory the wrapper sized holds every block's rows.
__host__ __device__ __forceinline__ void staged_span(int y0, int y1, int H4, int& q0, int& nq) {
  q0 = y0 / 4 - 1 > 0 ? y0 / 4 - 1 : 0;
  const int q1 = y1 > y0 ? ((y1 - 1) / 4 + 1 < H4 - 1 ? (y1 - 1) / 4 + 1 : H4 - 1) : q0 - 1;
  nq = q1 - q0 + 1;
}

// 2-tap lerp of the plain version: wl*a + wr*b, unfused
__device__ __forceinline__ float lerp2(float wl, float a, float wr, float b) {
  return __fadd_rn(__fmul_rn(wl, a), __fmul_rn(wr, b));
}

// The 4 upsampled tags of group (y, j) for each e: the rows lerp of quarter
// columns j-1, j, j+1, then the four column lerps. rows: the staged quarter
// rows, [E][nq][W4], nq rows from quarter row q0.
template <int E>
__device__ __forceinline__ void upsample_group(float (&t)[E][4], const float* rows, int nq, int q0,
                                               int H4, int W4, int y, int j) {
  const int i = y >> 2, ry = y & 3;
  const bool up = ry < 2;  // phases 0, 1 take rows (i-1, i); 2, 3 take (i, i+1)
  const int r0 = (up ? max(i - 1, 0) : i) - q0, r1 = (up ? i : min(i + 1, H4 - 1)) - q0;
  const bool vcopy = up ? i == 0 : i == H4 - 1;  // the edge tap is a copy of row i
  const float wl = ry == 0 ? 0.375f : ry == 1 ? 0.125f : ry == 2 ? 0.875f : 0.625f;
  const float wr = ry == 0 ? 0.625f : ry == 1 ? 0.875f : ry == 2 ? 0.125f : 0.375f;
  const int jl = max(j - 1, 0), jr = min(j + 1, W4 - 1);
  const bool first = j == 0, last = j == W4 - 1;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float* a = rows + ((size_t)e * nq + r0) * W4;
    const float* b = rows + ((size_t)e * nq + r1) * W4;
    const float* c = rows + ((size_t)e * nq + i - q0) * W4;
    const float rl = vcopy ? c[jl] : lerp2(wl, a[jl], wr, b[jl]);
    const float rc = vcopy ? c[j] : lerp2(wl, a[j], wr, b[j]);
    const float rr = vcopy ? c[jr] : lerp2(wl, a[jr], wr, b[jr]);
    t[e][0] = first ? rc : lerp2(0.375f, rl, 0.625f, rc);
    t[e][1] = first ? rc : lerp2(0.125f, rl, 0.875f, rc);
    t[e][2] = last ? rc : lerp2(0.875f, rc, 0.125f, rr);
    t[e][3] = last ? rc : lerp2(0.625f, rc, 0.375f, rr);
  }
}

// one group against PC persons: the running maximum and the first group
// that reached it; strict '>' keeps the thread's earlier group on ties, NaN
// differences are never taken
template <int E, int PC, bool FAST>
__device__ __forceinline__ void update(const float (&h)[4], const float (&t)[E][4], int g,
                                       const float* prev_s, float (&best)[PC], int (&besti)[PC]) {
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    float pv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) pv[e] = prev_s[p * E + e];
    float d[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float tv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) tv[e] = t[e][x];
      d[x] = __fsub_rn(h[x], rounded_distance<E, FAST>(tv, pv));
    }
    const float m = fmaxf(fmaxf(d[0], d[2]), fmaxf(d[1], d[3]));
    const bool rises = m > best[p];
    best[p] = rises ? m : best[p];
    besti[p] = rises ? g : besti[p];
  }
}

// what one block scans: full-resolution rows [y0, y1) of one (b, k) map
template <int E>
struct Work {
  const float* hm;      // the map's 16 phase planes [4][4][H4][W4]
  const float* rows;    // staged quarter tag rows [E][nq][W4] in shared memory
  int nq, q0, H4, W4, y0, y1;
  const float* prev_s;  // [MAXP][E], zero past P
  bool prev_big;        // a person tag reaches SMALL_TAG
  int P;
  unsigned (*red_k)[MAXP];  // [WARPS][MAXP] shared staging of the warps' results
  int (*red_i)[MAXP];
  unsigned* out_k;  // [P] key of the maximum
  int* out_i;       // [P] first group that reached it
};

// the block's groups against PC >= P persons; writes (key of the maximum,
// first group that reached it) of persons < P
template <int E, int PC>
__device__ __forceinline__ void scan(const Work<E>& w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW4 = w.H4 * w.W4;
  float best[PC];
  int besti[PC];
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    best[p] = -INFINITY;
    besti[p] = w.y0 * w.W4;
  }
  // thread tid takes groups y0*W4 + tid + n*THREADS: (y, j) advanced by
  // (dy, dj) a step with a carry, no division in the loop
  const int dy = THREADS / w.W4, dj = THREADS % w.W4;
  int y = w.y0 + tid / w.W4, j = tid % w.W4;
  if (y < w.y1) {
    const float* hp = w.hm + (size_t)((y & 3) * 4) * HW4 + (y >> 2) * w.W4 + j;
    float h[4] = {__ldcs(hp), __ldcs(hp + HW4), __ldcs(hp + 2 * HW4), __ldcs(hp + 3 * HW4)};
    while (true) {
      int ny = y + dy, nj = j + dj;
      if (nj >= w.W4) nj -= w.W4, ++ny;
      const bool more = ny < w.y1;
      float nh[4] = {h[0], h[1], h[2], h[3]};
      if (more) {  // the next group's heatmap values, loaded before this group's arithmetic
        const float* np = w.hm + (size_t)((ny & 3) * 4) * HW4 + (ny >> 2) * w.W4 + nj;
        nh[0] = __ldcs(np), nh[1] = __ldcs(np + HW4), nh[2] = __ldcs(np + 2 * HW4);
        nh[3] = __ldcs(np + 3 * HW4);
      }
      float t[E][4];
      upsample_group<E>(t, w.rows, w.nq, w.q0, w.H4, w.W4, y, j);
      float amax = 0.f;  // largest |tag| of the group; fmaxf drops NaN
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) amax = fmaxf(amax, fabsf(t[e][x]));
      const int g = y * w.W4 + j;
      if (w.prev_big || amax >= SMALL_TAG)
        update<E, PC, false>(h, t, g, w.prev_s, best, besti);
      else
        update<E, PC, true>(h, t, g, w.prev_s, best, besti);
      if (!more) break;
#pragma unroll
      for (int x = 0; x < 4; ++x) h[x] = nh[x];
      y = ny;
      j = nj;
    }
  }
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    // + 0 turns -0 into +0, so that equal floats have equal keys
    const unsigned key = order_key(__fadd_rn(best[p], 0.f));
    const unsigned kmax = __reduce_max_sync(FULL, key);
    const int first = __reduce_min_sync(FULL, key == kmax ? besti[p] : INT32_MAX);
    if (lane == 0) {
      w.red_k[warp][p] = kmax;
      w.red_i[warp][p] = first;
    }
  }
  __syncthreads();
  if (tid < w.P) {
    unsigned k = w.red_k[0][tid];
    int gi = w.red_i[0][tid];
    for (int o = 1; o < WARPS; ++o) {
      const unsigned ok = w.red_k[o][tid];
      const int oi = w.red_i[o][tid];
      if (ok > k || (ok == k && oi < gi)) {
        k = ok;
        gi = oi;
      }
    }
    w.out_k[tid] = k;
    w.out_i[tid] = gi;
  }
}

// the instance of scan compiled for the least PC >= P
template <int E, int PC>
__device__ __forceinline__ void scan_for_count(const Work<E>& w) {
  if constexpr (PC >= MAXP) {
    scan<E, MAXP>(w);
  } else {
    if (w.P <= PC)
      scan<E, PC>(w);
    else
      scan_for_count<E, PC + PERSON_STEP<E>>(w);
  }
}

// grid (B*K maps, S splits): block (map, s) scans full-resolution rows
// [s*rows_per, (s+1)*rows_per) and writes part_k/part_i[map][s][p]
template <int E>
__global__ void __launch_bounds__(THREADS, E <= 2 ? 2 : 1) refine_phase_scan_kernel(
    const float* __restrict__ avg, const float* __restrict__ tags_lo, const float* __restrict__ prev,
    unsigned* __restrict__ part_k, int* __restrict__ part_i, int K, int H4, int W4, int P,
    int rows_per) {
  const int map = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int b = map / K;
  const int tid = threadIdx.x;
  const int H = 4 * H4, HW4 = H4 * W4;

  extern __shared__ float rows_s[];  // [E][nq][W4]
  __shared__ __align__(16) float prev_s[MAXP * E];
  __shared__ unsigned red_k[WARPS][MAXP];
  __shared__ int red_i[WARPS][MAXP];

  const int y0 = min(s * rows_per, H), y1 = min(y0 + rows_per, H);
  int q0, nq;
  staged_span(y0, y1, H4, q0, nq);
  const float* tl = tags_lo + (size_t)map * E * HW4;
  for (int t = tid; t < E * nq * W4; t += THREADS) {
    const int e = t / (nq * W4), r = t - e * nq * W4;
    rows_s[t] = tl[(size_t)e * HW4 + (size_t)q0 * W4 + r];
  }
  int big = 0;
  for (int i = tid; i < MAXP * E; i += THREADS) {
    const float v = i < P * E ? prev[(size_t)b * P * E + i] : 0.f;
    prev_s[i] = v;
    big |= fabsf(v) >= SMALL_TAG;
  }
  const bool prev_big = __syncthreads_or(big);

  const size_t part = ((size_t)map * S + s) * P;
  const Work<E> w{avg + (size_t)map * 16 * HW4, rows_s, nq, q0, H4, W4, y0, y1,
                  prev_s, prev_big, P, red_k, red_i, part_k + part, part_i + part};
  scan_for_count<E, PERSON_STEP<E>>(w);
}

// one warp per map: thread p merges the map's S partial pairs, finds the
// first pixel of the winning group that attains the maximum, writes idx, val
template <int E>
__global__ void __launch_bounds__(MAXP) refine_phase_merge_kernel(
    const float* __restrict__ avg, const float* __restrict__ tags_lo, const float* __restrict__ prev,
    const unsigned* __restrict__ part_k, const int* __restrict__ part_i, int* __restrict__ idx,
    float* __restrict__ val, int K, int H4, int W4, int P, int S) {
  const int map = blockIdx.x, p = threadIdx.x;
  const int b = map / K;
  if (p >= P) return;
  const int HW4 = H4 * W4;
  const size_t part = (size_t)map * S * P + p;
  unsigned k = part_k[part];
  int gi = part_i[part];
  for (int s = 1; s < S; ++s) {
    const unsigned ok = part_k[part + (size_t)s * P];
    const int oi = part_i[part + (size_t)s * P];
    if (ok > k || (ok == k && oi < gi)) {
      k = ok;
      gi = oi;
    }
  }
  const float v = key_value(k);
  const int y = gi / W4, j = gi - y * W4;
  float t[E][4];
  upsample_group<E>(t, tags_lo + (size_t)map * E * HW4, H4, 0, H4, W4, y, j);
  const float* hp = avg + (size_t)map * 16 * HW4 + (size_t)((y & 3) * 4) * HW4 + (y >> 2) * W4 + j;
  float pv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) pv[e] = prev[((size_t)b * P + p) * E + e];
  int first = 0;
  for (int x = 3; x >= 0; --x) {
    float tv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) tv[e] = t[e][x];
    // the JAX form: equal to the fast form wherever the scan took that
    if (__fsub_rn(hp[x * HW4], rounded_distance<E, false>(tv, pv)) == v) first = x;
  }
  idx[(size_t)map * P + p] = 4 * gi + first;
  val[(size_t)map * P + p] = hp[first * HW4];
}

template <int E>
int launch(const float* avg, const float* tags_lo, const float* prev, int* idx, float* val,
           int* scratch, int B, int K, int H4, int W4, int P, int S, int smem, cudaStream_t stream) {
  const int maps = B * K, H = 4 * H4;
  const int rows_per = (H + S - 1) / S;
  for (int s = 0; s < S; ++s) {  // every block's staged rows fit in the smem bytes given
    const int y0 = s * rows_per < H ? s * rows_per : H, y1 = y0 + rows_per < H ? y0 + rows_per : H;
    int q0, nq;
    staged_span(y0, y1, H4, q0, nq);
    if ((int64_t)E * nq * W4 * sizeof(float) > smem) return (int)cudaErrorInvalidValue;
  }
  // refuses smem past what the card gives a block
  cudaError_t err = cudaFuncSetAttribute(refine_phase_scan_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned* part_k = reinterpret_cast<unsigned*>(scratch);
  int* part_i = scratch + (size_t)maps * S * P;
  refine_phase_scan_kernel<E><<<dim3(maps, S), THREADS, smem, stream>>>(
      avg, tags_lo, prev, part_k, part_i, K, H4, W4, P, rows_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refine_phase_merge_kernel<E><<<maps, MAXP, 0, stream>>>(avg, tags_lo, prev, part_k, part_i, idx,
                                                          val, K, H4, W4, P, S);
  return (int)cudaGetLastError();
}

}  // namespace

// avg_phase [B, K, 4, 4, H4, W4] f32, tags_lo [B, K, E, H4, W4] f32,
// prev [B, P, E] f32 -> idx [B, K, P] i32 (full-resolution y*4*W4 + x),
// val [B, K, P] f32. scratch: 2 * B*K * S * P int32, the blocks' partial
// (key, group) pairs; S >= 1 blocks share a map's rows. smem: the bytes of
// shared memory a block gets for its staged tag rows, sized by the wrapper
// (cuda_aggregate.staged_bytes); too few for a block's rows is refused.
// Returns the first failed launch's cudaError_t, or 0.
extern "C" int launch_refine_argmax_phase(const float* avg, const float* tags_lo, const float* prev,
                                          int* idx, float* val, int* scratch, int B, int K, int H4,
                                          int W4, int E, int P, int S, int smem,
                                          cudaStream_t stream) {
  if (B < 1 || K < 1 || H4 < 1 || W4 < 1 || P < 1 || P > MAXP || S < 1 || S > 65535 || smem < 0 ||
      (int64_t)B * K > INT32_MAX || (int64_t)16 * H4 * W4 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  switch (E) {
    case 1: return launch<1>(avg, tags_lo, prev, idx, val, scratch, B, K, H4, W4, P, S, smem,
                              stream);
    case 2: return launch<2>(avg, tags_lo, prev, idx, val, scratch, B, K, H4, W4, P, S, smem,
                              stream);
    case 3: return launch<3>(avg, tags_lo, prev, idx, val, scratch, B, K, H4, W4, P, S, smem,
                              stream);
    case 4: return launch<4>(avg, tags_lo, prev, idx, val, scratch, B, K, H4, W4, P, S, smem,
                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
