// COCO RLE mask decode for the data pipeline, on the host.
//
// Port of rle_decode of native/hp_native.cpp (the JAX package's extension),
// with a plain C interface instead of the CPython C API, so that it builds
// with the host C++ compiler alone (ops/_build.py) and loads with ctypes.
// ctypes.CDLL releases the GIL around the call.
//
// Semantics of that function, byte for byte: the runs are column-major and
// start with zeros; a negative count is an empty run; a run that passes
// h*w is cut there and the counts after it are ignored; no count (n = 0)
// gives an all-zero mask. The NumPy loop of data/rle.py::rle_to_mask_plain
// is the plain version (it agrees wherever no count is negative).
//
// Host code, bound by the bytes of its output: each call writes h*w bytes
// once into a column-major buffer and once transposed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// counts: int32 [n_counts] run lengths; out: uint8 [h, w] (row-major),
// overwritten. Returns 0, or 1 when an argument is out of range.
int rle_decode(const int32_t* counts, int n_counts, int h, int w, uint8_t* out) {
  if (n_counts < 0 || h < 0 || w < 0) return 1;
  const size_t total = static_cast<size_t>(h) * w;
  std::vector<uint8_t> flat(total, 0);
  size_t pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < n_counts && pos < total; ++i) {
    const size_t run = std::min<size_t>(counts[i] > 0 ? counts[i] : 0, total - pos);
    if (val) std::memset(flat.data() + pos, 1, run);
    pos += run;
    val = 1 - val;
  }
  for (int col = 0; col < w; ++col)
    for (int row = 0; row < h; ++row)
      out[static_cast<size_t>(row) * w + col] = flat[static_cast<size_t>(col) * h + row];
  return 0;
}

}  // extern "C"
