// Gaussian heatmap splat for the keypoints training targets, on the host.
//
// Port of the splat of native/hp_native.cpp (the JAX package's extension),
// with a plain C interface instead of the CPython C API, so that it builds
// with the host C++ compiler alone (ops/_build.py) and loads with ctypes.
// ctypes.CDLL releases the GIL around the call, so the data loader's worker
// threads run splats in parallel.
//
// Semantics of the reference HeatmapGenerator (data/targets.py, whose NumPy
// loop is the plain version): a window of L = len(arange(0, 6*sigma+3))
// values a side centred at 3*sigma+1, computed in double and stored as
// float; bounds round(x - 3*sigma - 1) .. round(x + 3*sigma + 2) with
// std::lround (halves away from zero; NumPy's round takes halves to even,
// and the two agree whenever 3*sigma+1 is an integer, as at sigma 2);
// joints with vis <= 0 or outside the map are skipped; overlapping
// windows combine by max.
//
// Host code, bound by the bytes of its output: each call zeroes and writes
// size*size*num_kpts floats and touches L*L of them a visible joint.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// joints: int32 [num_people, num_kpts, 3] (x, y, vis); out: float32
// [size, size, num_kpts] (channel-last), overwritten. Returns 0, or 1 when
// an argument is out of range.
int splat_heatmaps(const int32_t* joints, int num_people, int num_kpts, int size, double sigma,
                   float* out) {
  if (num_people < 0 || num_kpts <= 0 || size <= 0 || !(sigma > 0.0)) return 1;
  const int L = static_cast<int>(std::ceil(6.0 * sigma + 3.0));
  std::vector<float> gauss(static_cast<size_t>(L) * L);
  const double c = 3.0 * sigma + 1.0;
  for (int y = 0; y < L; ++y) {
    for (int x = 0; x < L; ++x) {
      const double dx = x - c, dy = y - c;
      gauss[static_cast<size_t>(y) * L + x] =
          static_cast<float>(std::exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma)));
    }
  }
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(size) * size * num_kpts);
  for (int p = 0; p < num_people; ++p) {
    for (int k = 0; k < num_kpts; ++k) {
      const int32_t* j = joints + (static_cast<size_t>(p) * num_kpts + k) * 3;
      const int x = j[0], y = j[1], vis = j[2];
      if (vis <= 0 || x < 0 || y < 0 || x >= size || y >= size) continue;
      const int xmin = static_cast<int>(std::lround(x - 3.0 * sigma - 1.0));
      const int ymin = static_cast<int>(std::lround(y - 3.0 * sigma - 1.0));
      const int xmax = static_cast<int>(std::lround(x + 3.0 * sigma + 2.0));
      const int ymax = static_cast<int>(std::lround(y + 3.0 * sigma + 2.0));
      const int mx0 = std::max(0, xmin), mx1 = std::min(xmax, size);
      const int my0 = std::max(0, ymin), my1 = std::min(ymax, size);
      for (int yy = my0; yy < my1; ++yy) {
        const float* grow = &gauss[static_cast<size_t>(yy - ymin) * L];
        float* orow = out + static_cast<size_t>(yy) * size * num_kpts + k;
        for (int xx = mx0; xx < mx1; ++xx) {
          float& dst = orow[static_cast<size_t>(xx) * num_kpts];
          const float g = grow[xx - xmin];
          if (g > dst) dst = g;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
