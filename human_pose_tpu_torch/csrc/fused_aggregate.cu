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
// Design: one block per (strip of `rows` quarter rows, k, b). A thread owns
// one 4-pixel group, quarter column j (full-resolution columns 4j .. 4j+3),
// and the block walks down its strip making every half- and full-resolution
// row once: it keeps the three averaged half-resolution rows the vertical
// upsample needs and the five full-resolution rows of the NMS window in
// registers, and only the strip's 2-row NMS halo a side (and its
// half-resolution rows) is made twice. A thread computes its group's
// half-resolution columns 2j-1 .. 2j+2 from the quarter columns j-1 .. j+1
// (read through the cache), so its four full-resolution values need no
// neighbour; the 10 loads of a half row are issued two full rows before it is
// used, so their latency overlaps the rows in between. The horizontal 5-max
// takes the two vertical maxima a side from lanes j-1 and j+1 by shuffle, the
// warps' edge lanes through a small shared buffer, one barrier a row (which
// also keeps the block's warps writing the same rows together: a copy that
// dropped it for warp-wide column tiles measured slower). Each row's four
// values go to the four phase planes (y%4, 0..3) at column j: neighbouring
// lanes write neighbouring addresses, and the stores leave as each row is
// made, marked evict-first (`st.global.cs`: the 856 MB never come back). The
// row maximum is a warp reduce and one cross-warp step a row.
//
// Widths: a block of `threads` lanes covers the row when W4 <= threads;
// wider rows run as column tiles one after another, each with one halo lane
// a side that only feeds its neighbour (row maxima merged by the one thread
// that writes them). The wrapper (cuda_aggregate.aggregate_launch) chooses
// `rows` and `threads`; the launch checks them, and the kernel takes no
// dynamic shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;  // a block's most lanes: the kernel's launch bound
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// What the averaged half-resolution row u needs at quarter column j: q at
// columns j-1, j, j+1 of the two quarter rows its vertical lerp reads (a, b),
// and h2 at half columns 2j-1 .. 2j+2. Indices are clamped into the map;
// the clamped entries feed only edge outputs, which copy instead.
struct HalfIn {
  float am, a0, ap, bm, b0, bp, h0, h1, h2, h3;
};

__device__ __forceinline__ HalfIn load_half(const float* __restrict__ q, const float* __restrict__ h2,
                                            int u, int j, int H4, int W4) {
  const int i = u >> 1, jm = max(j - 1, 0), jp = min(j + 1, W4 - 1), W2 = 2 * W4;
  const float* qa = q + (size_t)((u & 1) ? i : max(i - 1, 0)) * W4;
  const float* qb = q + (size_t)((u & 1) ? min(i + 1, H4 - 1) : i) * W4;
  const float* hr = h2 + (size_t)u * W2;
  return {__ldg(qa + jm), __ldg(qa + j), __ldg(qa + jp), __ldg(qb + jm), __ldg(qb + j), __ldg(qb + jp),
          __ldg(hr + max(2 * j - 1, 0)), __ldg(hr + 2 * j), __ldg(hr + 2 * j + 1),
          __ldg(hr + min(2 * j + 2, W2 - 1))};
}

// q upsampled 2x down the rows at half-resolution row u, from quarter rows a, b
__device__ __forceinline__ float rows_up(float a, float b, int u, int H4) {
  const int i = u >> 1;
  if ((u & 1) == 0) return i == 0 ? b : 0.25f * a + 0.75f * b;
  return i == H4 - 1 ? a : 0.75f * a + 0.25f * b;
}

// the averaged half-resolution row u, C = (A + h2) * 0.5, at half columns
// 2j-1, 2j, 2j+1, 2j+2
__device__ __forceinline__ float4 half_row(const HalfIn& in, int u, int j, int H4, int W4) {
  const float rm = rows_up(in.am, in.bm, u, H4), r0 = rows_up(in.a0, in.b0, u, H4),
              rp = rows_up(in.ap, in.bp, u, H4);
  const float a0 = 0.75f * rm + 0.25f * r0;                     // odd output of column j-1
  const float a1 = j == 0 ? r0 : 0.25f * rm + 0.75f * r0;        // even output of column j
  const float a2 = j == W4 - 1 ? r0 : 0.75f * r0 + 0.25f * rp;  // odd output of column j
  const float a3 = 0.25f * r0 + 0.75f * rp;                     // even output of column j+1
  return make_float4((a0 + in.h0) * 0.5f, (a1 + in.h1) * 0.5f, (a2 + in.h2) * 0.5f, (a3 + in.h3) * 0.5f);
}

__device__ __forceinline__ float lerp_rows(float wa, float a, float wb, float b) { return wa * a + wb * b; }

__device__ __forceinline__ float4 fmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__global__ void __launch_bounds__(MAX_THREADS) aggregate_kernel(
    const float* __restrict__ q, const float* __restrict__ h2, float* __restrict__ avg,
    float* __restrict__ sup, float* __restrict__ cmax, int K, int H4, int W4, int rows) {
  const int k = blockIdx.y, b = blockIdx.z;
  const int H2 = 2 * H4, H = 4 * H4;
  const int y_begin = 4 * blockIdx.x * rows, y_end = min(y_begin + 4 * rows, H);  // output rows
  const size_t map = (size_t)b * K + k, plane = (size_t)H4 * W4;
  const float* qm = q + map * plane;
  const float* hm = h2 + map * 4 * plane;
  const int nt = blockDim.x, warps = nt >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = W4 <= nt ? nt : nt - 2;  // groups a tile writes
  const int tiles = (W4 + stride - 1) / stride;

  __shared__ float edge[2][MAX_WARPS][4];  // a warp's lane 0 vertical maxima 0,1 and lane 31's 2,3
  __shared__ float red[2][MAX_WARPS];      // each warp's maximum of a row's sup

  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * stride;  // first group the tile writes
    const int j = tiles == 1 ? (int)threadIdx.x : j0 - 1 + (int)threadIdx.x;
    const bool writes = j >= j0 && j < min(j0 + stride, W4);
    const int jc = min(max(j, 0), W4 - 1);  // lanes outside the map compute column jc, unused

    // averaged half-resolution rows cu-1, cu, cu+1 (cu: the row the next
    // full-resolution row y is centred on, y >> 1)
    int cu = max(y_begin - 2, 0) >> 1;
    float4 c_lo = make_float4(0.f, 0.f, 0.f, 0.f), c_mid, c_hi = c_lo;
    if (cu > 0) c_lo = half_row(load_half(qm, hm, cu - 1, jc, H4, W4), cu - 1, jc, H4, W4);
    c_mid = half_row(load_half(qm, hm, cu, jc, H4, W4), cu, jc, H4, W4);
    if (cu + 1 < H2) c_hi = half_row(load_half(qm, hm, cu + 1, jc, H4, W4), cu + 1, jc, H4, W4);
    // the inputs of half row cu+2, loaded two full rows before they are used
    HalfIn ahead = {};
    if (cu + 2 < H2) ahead = load_half(qm, hm, cu + 2, jc, H4, W4);

    // full-resolution row y at columns 4jc .. 4jc+3; -inf outside the map
    auto full_row = [&](int y) {
      if (y < 0 || y >= H) return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if ((y >> 1) > cu) {  // y advances one row a call: at most one new half row
        c_lo = c_mid;
        c_mid = c_hi;
        ++cu;
        if (cu + 1 < H2) c_hi = half_row(ahead, cu + 1, jc, H4, W4);
        if (cu + 2 < H2) ahead = load_half(qm, hm, cu + 2, jc, H4, W4);
      }
      float4 v;  // up2 down the rows, at half columns 2j-1 .. 2j+2
      if ((y & 1) == 0) {
        if (cu == 0) {
          v = c_mid;
        } else {
          v = make_float4(lerp_rows(0.25f, c_lo.x, 0.75f, c_mid.x), lerp_rows(0.25f, c_lo.y, 0.75f, c_mid.y),
                          lerp_rows(0.25f, c_lo.z, 0.75f, c_mid.z), lerp_rows(0.25f, c_lo.w, 0.75f, c_mid.w));
        }
      } else if (cu == H2 - 1) {
        v = c_mid;
      } else {
        v = make_float4(lerp_rows(0.75f, c_mid.x, 0.25f, c_hi.x), lerp_rows(0.75f, c_mid.y, 0.25f, c_hi.y),
                        lerp_rows(0.75f, c_mid.z, 0.25f, c_hi.z), lerp_rows(0.75f, c_mid.w, 0.25f, c_hi.w));
      }
      // up2 along the row: full columns 4j .. 4j+3 from half columns 2j-1 .. 2j+2
      return make_float4(jc == 0 ? v.y : 0.25f * v.x + 0.75f * v.y, 0.75f * v.y + 0.25f * v.z,
                         0.25f * v.y + 0.75f * v.z, jc == W4 - 1 ? v.z : 0.75f * v.z + 0.25f * v.w);
    };

    // the NMS window: full-resolution rows y-2 .. y+2
    float4 f0 = full_row(y_begin - 2), f1 = full_row(y_begin - 1), f2 = full_row(y_begin),
           f3 = full_row(y_begin + 1);
    for (int y = y_begin; y < y_end; ++y) {
      const float4 f4 = full_row(y + 2);
      const float4 p = fmax4(fmax4(fmax4(f0, f1), fmax4(f3, f4)), f2);  // vertical 5-max
      const int buf = y & 1;
      if (lane == 0) {
        edge[buf][warp][0] = p.x;
        edge[buf][warp][1] = p.y;
      }
      if (lane == 31) {
        edge[buf][warp][2] = p.z;
        edge[buf][warp][3] = p.w;
      }
      __syncthreads();
      if (threadIdx.x == 0 && y > y_begin) {  // the previous row's maximum, all warps' parts
        float m = red[buf ^ 1][0];
        for (int w = 1; w < warps; ++w) m = fmaxf(m, red[buf ^ 1][w]);
        const int yp = y - 1;
        float* out = cmax + (map * 4 + (yp & 3)) * H4 + (yp >> 2);
        *out = t == 0 ? m : fmaxf(*out, m);
      }
      // vertical maxima of full columns 4j-2, 4j-1 (lane j-1) and 4j+4, 4j+5 (lane j+1)
      float l2 = __shfl_up_sync(FULL, p.z, 1), l1 = __shfl_up_sync(FULL, p.w, 1);
      float r0 = __shfl_down_sync(FULL, p.x, 1), r1 = __shfl_down_sync(FULL, p.y, 1);
      if (lane == 0) {
        l2 = warp > 0 ? edge[buf][warp - 1][2] : -INFINITY;
        l1 = warp > 0 ? edge[buf][warp - 1][3] : -INFINITY;
      }
      if (lane == 31) {
        r0 = warp + 1 < warps ? edge[buf][warp + 1][0] : -INFINITY;
        r1 = warp + 1 < warps ? edge[buf][warp + 1][1] : -INFINITY;
      }
      if (j <= 0) l2 = l1 = -INFINITY;
      if (j >= W4 - 1) r0 = r1 = -INFINITY;
      const float m12 = fmaxf(p.y, p.z), m012 = fmaxf(p.x, m12), m123 = fmaxf(m12, p.w);
      const float4 s = make_float4(
          fmaxf(fmaxf(l2, l1), m012) == f2.x ? f2.x : 0.f, fmaxf(fmaxf(l1, m012), p.w) == f2.y ? f2.y : 0.f,
          fmaxf(fmaxf(p.x, m123), r0) == f2.z ? f2.z : 0.f, fmaxf(m123, fmaxf(r0, r1)) == f2.w ? f2.w : 0.f);
      float m = -INFINITY;
      if (writes) {
        const size_t o = (map * 16 + 4 * (y & 3)) * plane + (size_t)(y >> 2) * W4 + j;
        __stcs(avg + o, f2.x);
        __stcs(avg + o + plane, f2.y);
        __stcs(avg + o + 2 * plane, f2.z);
        __stcs(avg + o + 3 * plane, f2.w);
        __stcs(sup + o, s.x);
        __stcs(sup + o + plane, s.y);
        __stcs(sup + o + 2 * plane, s.z);
        __stcs(sup + o + 3 * plane, s.w);
        m = fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w));
      }
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lane == 0) red[buf][warp] = m;
      f0 = f1;
      f1 = f2;
      f2 = f3;
      f3 = f4;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // the strip's last row
      const int yp = y_end - 1, buf = yp & 1;
      float m = red[buf][0];
      for (int w = 1; w < warps; ++w) m = fmaxf(m, red[buf][w]);
      float* out = cmax + (map * 4 + (yp & 3)) * H4 + (yp >> 2);
      *out = t == 0 ? m : fmaxf(*out, m);
    }
    __syncthreads();  // the next tile reuses the shared buffers
  }
}

}  // namespace

// q [B, K, H4, W4] f32, h2 [B, K, 2*H4, 2*W4] f32 -> avg, sup [B, K, 4, 4, H4, W4]
// f32, cmax [B, K, 4, H4] f32. `rows` quarter rows a block (1 .. H4), `threads`
// a block (a multiple of 32, at most MAX_THREADS, the launch bound): the
// wrapper's choice.
// Returns the launch's cudaError_t.
extern "C" int launch_fused_aggregate(const float* q, const float* h2, float* avg, float* sup,
                                      float* cmax, int B, int K, int H4, int W4, int rows,
                                      int threads, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H4 < 1 || W4 < 1 || rows < 1 || rows > H4 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int strips = (H4 + rows - 1) / rows;
  aggregate_kernel<<<dim3(strips, K, B), threads, 0, stream>>>(q, h2, avg, sup, cmax, K, H4, W4, rows);
  return (int)cudaGetLastError();
}
