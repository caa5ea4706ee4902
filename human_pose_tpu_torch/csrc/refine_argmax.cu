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
// What bounds it on the H100: instruction throughput, not bytes. The maps are read
// once, B*K*(1+E)*HW*4 bytes, but every (pixel, person) pair needs its own
// distance, rounding and subtraction, none of which fuse (the library is
// built with --fmad=false so that it repeats the plain version's float32
// arithmetic bit for bit). With 30 persons in an image the pairs outnumber
// the pixels 30 to 1, and an SM starts at most 128 lane-instructions a clock,
// so the count of instructions per pair sets the time.
//
// Design, in the order of what it saves:
// * 4.0 full-rate adds per pair at E == 1 and little else. A thread takes 4
//   consecutive pixels per step (one 16-byte load of the heatmap and of each
//   tag plane, the next step's loads started before this step's arithmetic).
//   rint(x) is (x + 2^23) - 2^23, two adds that round halves to even exactly
//   for 0 <= x < 2^23, instead of the conversion-unit instruction rintf
//   compiles to. A 4-pixel group in which a tag reaches 2^20, or a block
//   whose person tags do, takes a second instance of the loop that calls
//   rintf, so every finite distance is rounded exactly (NaN and infinity come
//   out of both forms alike).
// * The hot loop keeps only (running maximum, first GROUP that reached it)
//   per person: the maximum of the group's four differences, one compare,
//   two selects, and no branch. Which of the four pixels it was is found
//   once per (row, person) at the very end, by computing that one group's
//   differences again with the same arithmetic and taking the first that
//   equals the maximum. The first maximum of a row lies in the lowest group
//   whose maximum equals the row's, so the first-maximum rule holds.
// * The person loop has no branch: it is compiled for every even count up
//   to 32 at E == 1 (the model's embedding size; 30 persons then cost 30,
//   not 32) and for 8, 16, 24, 32 at E > 1, and a block branches once, on
//   counts[b] rounded up, into the instance it needs. The persons that pad
//   the count have a zero tag and are never written. Person tags sit in
//   shared memory and are read up to 4 at a time.
// * The card is filled by splitting each (b, k) row over S blocks of 256
//   threads (grid B*K x S), each a contiguous range of pixels. A block
//   reduces its threads' pairs with two warp reductions per person (the
//   maximum of an order-preserving integer key of the float, then the
//   lowest group among the lanes that hold it) and writes one (key, group)
//   per person to scratch memory the wrapper allocated; a second small
//   kernel merges the S partial pairs of a row on (key descending, group
//   ascending), resolves the pixel inside the group and writes idx. Both
//   steps are independent of the order blocks run in: the result is
//   deterministic.
// Built with --fmad=false and without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 32;     // persons a thread keeps in registers
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIX = 4;       // consecutive pixels a thread takes per step: 4 or 8
constexpr unsigned FULL = 0xffffffffu;
constexpr float TWO23 = 8388608.f;
// tags below this magnitude (pixel and person) keep every distance below
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

// rint(||tv - pv||) in the plain version's arithmetic. MAGIC: the distance
// is known to lie below 2^23, where adding and subtracting 2^23 rounds
// halves to even exactly.
template <int E, bool MAGIC>
__device__ __forceinline__ float rounded_distance(const float (&tv)[E], const float (&pv)[E]) {
  float x;
  if (E == 1) {
    x = fabsf(__fsub_rn(tv[0], pv[0]));
  } else {
    float d2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = __fsub_rn(tv[e], pv[e]);
      d2 = __fadd_rn(d2, __fmul_rn(d, d));
    }
    x = sqrtf(d2);
  }
  return MAGIC ? __fsub_rn(__fadd_rn(x, TWO23), TWO23) : rintf(x);
}

// PIX consecutive pixels of one row: heatmap values and tags
template <int E>
struct Group {
  float h[PIX];
  float t[E][PIX];
};

// pixels [i, i + PIX) of the row; vec: 16-byte loads (the row, its tag planes
// and i are 16-byte aligned and the group lies inside [.., hi)), else guarded
// scalar loads, a pixel at or past hi reading as heatmap -inf
template <int E>
__device__ __forceinline__ void load_group(Group<E>& g, const float* __restrict__ h,
                                           const float* __restrict__ t, int HW, int i, int hi,
                                           bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < PIX; q += 4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(h + i + q));
      g.h[q] = a.x, g.h[q + 1] = a.y, g.h[q + 2] = a.z, g.h[q + 3] = a.w;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float4 c = __ldcs(reinterpret_cast<const float4*>(t + (size_t)e * HW + i + q));
        g.t[e][q] = c.x, g.t[e][q + 1] = c.y, g.t[e][q + 2] = c.z, g.t[e][q + 3] = c.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const bool in = i + j < hi;
      g.h[j] = in ? h[i + j] : -INFINITY;
#pragma unroll
      for (int e = 0; e < E; ++e) g.t[e][j] = in ? t[(size_t)e * HW + i + j] : 0.f;
    }
  }
}

// one group against PC persons: the running maximum and the first group
// (its first pixel's index) that reached it; strict '>' keeps the thread's
// earlier group on ties, NaN differences are never taken
template <int E, int PC, bool MAGIC>
__device__ __forceinline__ void update(const Group<E>& g, int i, const float* prev_s,
                                       float (&best)[PC], int (&besti)[PC]) {
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    float pv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) pv[e] = prev_s[p * E + e];
    float d[PIX];
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      float tv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) tv[e] = g.t[e][j];
      d[j] = __fsub_rn(g.h[j], rounded_distance<E, MAGIC>(tv, pv));
    }
#pragma unroll
    for (int w = PIX / 2; w > 0; w /= 2)  // the group's maximum, as a tree
#pragma unroll
      for (int j = 0; j < w; ++j) d[j] = fmaxf(d[j], d[j + w]);
    const float m = d[0];
    const bool rises = m > best[p];
    best[p] = rises ? m : best[p];
    besti[p] = rises ? i : besti[p];
  }
}

// what one block scans: pixels [lo, hi) of a row, the image's person tags in
// shared memory, and where its partial results go
template <int E>
struct Work {
  const float* h;       // the row's heatmap
  const float* t;       // the row's E tag planes
  int HW, lo, hi;
  bool vec;             // 16-byte loads allowed
  const float* prev_s;  // [MAXP][E], zero past cnt
  bool prev_big;        // a person tag reaches SMALL_TAG
  int cnt;
  unsigned (*red_k)[MAXP];  // [WARPS][MAXP] shared staging of the warps' results
  int (*red_i)[MAXP];
  unsigned* out_k;  // [P] key of the maximum
  int* out_i;       // [P] first group that reached it
};

// the block's pixels against PC >= cnt persons; writes (key of the maximum,
// first group that reached it) of persons < cnt
template <int E, int PC>
__device__ __forceinline__ void scan(const Work<E>& w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float best[PC];
  int besti[PC];
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    best[p] = -INFINITY;
    besti[p] = w.lo;
  }
  int i = w.lo + tid * PIX;
  if (i < w.hi) {
    Group<E> cur;
    load_group<E>(cur, w.h, w.t, w.HW, i, w.hi, w.vec);
    while (true) {
      const int ni = i + THREADS * PIX;
      const bool more = ni < w.hi;
      Group<E> nxt = cur;
      if (more) load_group<E>(nxt, w.h, w.t, w.HW, ni, w.hi, w.vec);
      float amax = 0.f;  // largest |tag| of the group; fmaxf drops NaN
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int j = 0; j < PIX; ++j) amax = fmaxf(amax, fabsf(cur.t[e][j]));
      if (w.prev_big || amax >= SMALL_TAG)
        update<E, PC, false>(cur, i, w.prev_s, best, besti);
      else
        update<E, PC, true>(cur, i, w.prev_s, best, besti);
      if (!more) break;
      cur = nxt;
      i = ni;
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
  if (tid < w.cnt) {
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

// the instance of scan compiled for the least PC >= cnt
template <int E, int PC>
__device__ __forceinline__ void scan_for_count(const Work<E>& w) {
  if constexpr (PC >= MAXP) {
    scan<E, MAXP>(w);
  } else {
    if (w.cnt <= PC)
      scan<E, PC>(w);
    else
      scan_for_count<E, PC + PERSON_STEP<E>>(w);
  }
}

// grid (B*K rows, S splits): block (row, s) scans pixels [s*chunk, (s+1)*chunk)
// of its row and writes part_k/part_i[row][s][p] for p < counts[b]
template <int E>
__global__ void __launch_bounds__(THREADS, E <= 2 ? 2 : 1) refine_scan_kernel(
    const float* __restrict__ hm, const float* __restrict__ tags, const float* __restrict__ prev,
    const int* __restrict__ counts, unsigned* __restrict__ part_k, int* __restrict__ part_i, int K,
    int HW, int P, int chunk, int vec) {
  const int row = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int b = row / K;
  const int tid = threadIdx.x;
  const int cnt = max(0, min(counts[b], P));
  if (cnt == 0) return;  // the whole block: no person of this image is consumed

  __shared__ __align__(16) float prev_s[MAXP * E];
  __shared__ unsigned red_k[WARPS][MAXP];
  __shared__ int red_i[WARPS][MAXP];

  int big = 0;
  for (int i = tid; i < MAXP * E; i += THREADS) {
    const float v = i < cnt * E ? prev[(size_t)b * P * E + i] : 0.f;
    prev_s[i] = v;
    big |= fabsf(v) >= SMALL_TAG;
  }
  const bool prev_big = __syncthreads_or(big);

  const int lo = min(s * chunk, HW);
  const size_t part = ((size_t)row * S + s) * P;
  const Work<E> w{hm + (size_t)row * HW, tags + (size_t)row * E * HW, HW, lo, min(lo + chunk, HW),
                  vec != 0, prev_s, prev_big, cnt, red_k, red_i, part_k + part, part_i + part};
  scan_for_count<E, PERSON_STEP<E>>(w);
}

// one warp per row: thread p merges the row's S partial pairs, finds the
// first pixel of the winning group that attains the maximum, writes idx
template <int E>
__global__ void __launch_bounds__(MAXP) refine_merge_kernel(
    const float* __restrict__ hm, const float* __restrict__ tags, const float* __restrict__ prev,
    const int* __restrict__ counts, const unsigned* __restrict__ part_k,
    const int* __restrict__ part_i, int* __restrict__ idx, int K, int HW, int P, int S) {
  const int row = blockIdx.x, p = threadIdx.x;
  const int b = row / K;
  if (p >= P) return;
  int* out = idx + (size_t)row * P;
  if (p >= counts[b]) {
    out[p] = 0;
    return;
  }
  const size_t part = (size_t)row * S * P + p;
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
  const float* h = hm + (size_t)row * HW;
  const float* t = tags + (size_t)row * E * HW;
  float pv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) pv[e] = prev[((size_t)b * P + p) * E + e];
  int first = 0;
  for (int j = PIX - 1; j >= 0; --j) {
    if (gi + j >= HW) continue;
    float tv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) tv[e] = t[(size_t)e * HW + gi + j];
    if (__fsub_rn(h[gi + j], rounded_distance<E, false>(tv, pv)) == v) first = j;
  }
  out[p] = gi + first;
}

template <int E>
int launch(const float* hm, const float* tags, const float* prev, const int* counts, int* idx,
           int* scratch, int B, int K, int HW, int P, int S, cudaStream_t stream) {
  const int rows = B * K;
  const int chunk = (int)((((int64_t)HW + S - 1) / S + PIX - 1) / PIX * PIX);
  const bool vec = HW % PIX == 0 && (uintptr_t)hm % 16 == 0 && (uintptr_t)tags % 16 == 0;
  unsigned* part_k = reinterpret_cast<unsigned*>(scratch);
  int* part_i = scratch + (size_t)rows * S * P;
  refine_scan_kernel<E><<<dim3(rows, S), THREADS, 0, stream>>>(hm, tags, prev, counts, part_k,
                                                               part_i, K, HW, P, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refine_merge_kernel<E><<<rows, MAXP, 0, stream>>>(hm, tags, prev, counts, part_k, part_i, idx,
                                                    K, HW, P, S);
  return (int)cudaGetLastError();
}

}  // namespace

// hm [B, K, HW] f32, tags [B, K, E, HW] f32, prev [B, P, E] f32, counts [B] i32
// -> idx [B, K, P] i32. scratch: 2 * B*K * S * P int32, the blocks' partial
// (key, group) pairs; S >= 1 blocks share a row. Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int launch_refine_argmax(const float* hm, const float* tags, const float* prev,
                                    const int* counts, int* idx, int* scratch, int B, int K,
                                    int HW, int E, int P, int S, cudaStream_t stream) {
  if (B < 1 || K < 1 || HW < 1 || HW > (1 << 30) || P < 1 || P > MAXP || S < 1 || S > 65535 ||
      (int64_t)B * K > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  switch (E) {
    case 1: return launch<1>(hm, tags, prev, counts, idx, scratch, B, K, HW, P, S, stream);
    case 2: return launch<2>(hm, tags, prev, counts, idx, scratch, B, K, HW, P, S, stream);
    case 3: return launch<3>(hm, tags, prev, counts, idx, scratch, B, K, HW, P, S, stream);
    case 4: return launch<4>(hm, tags, prev, counts, idx, scratch, B, K, HW, P, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
