// Host RLE mask ops for the port: a plain-C shared library, loaded with
// ctypes by detectorch_tpu_torch/eval/rle_native.py.
//
// The port's copy of the JAX package's CPython extension
// (native/rle_ext.cpp, module detectorch_tpu_rle_native), which plays the
// role pycocotools' C maskApi plays for the reference (result_utils.py:218-221
// encode, json_dataset.py:397-414 IoU). The algorithms are that file's: the
// run-walk IoU, maskApi's rleToString / rleFrString, and the strip
// paste-encode. Its PyArg / numpy glue is replaced by C entry points over
// caller-owned int64 / uint8 / char buffers, so the build needs neither
// Python's nor numpy's headers: only a C++17 compiler.
//
// Counts are int64 runs in column-major order, alternating 0s and 1s and
// starting with a 0-run. Every function is reentrant (no global state), so
// callers may run it from several threads at once.
//
// Entry points (all sizes int64; the Python wrapper validates them):
//   rle_counts_to_string(counts, m, out, cap) -> length written (<= 13 m)
//   rle_string_to_counts(s, len, out, cap)    -> #counts, -1 if truncated
//   rle_encode_pasted(patch, bh, bw, x0, y0, im_h, im_w, out, cap)
//       -> length of the string; written only if it fits in cap
//   rle_area(counts, m)                        -> sum of the 1-runs
//   rle_iou_matrix(counts, offsets, d, g, iscrowd, out) -> 0
//       counts of the d dts then the g gts back to back, offsets (d+g+1)

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Intervals {
  // [start, end) pairs of 1-runs in flat (column-major) order
  std::vector<int64_t> starts;
  std::vector<int64_t> ends;
  int64_t area = 0;
};

Intervals counts_to_intervals(const int64_t* c, int64_t m) {
  Intervals out;
  int64_t pos = 0;
  out.starts.reserve(m / 2 + 1);
  out.ends.reserve(m / 2 + 1);
  for (int64_t i = 0; i < m; i++) {
    if (i % 2 == 1 && c[i] > 0) {
      out.starts.push_back(pos);
      out.ends.push_back(pos + c[i]);
      out.area += c[i];
    }
    pos += c[i];
  }
  return out;
}

int64_t intersect_area(const Intervals& a, const Intervals& b) {
  size_t i = 0, j = 0;
  int64_t total = 0;
  while (i < a.starts.size() && j < b.starts.size()) {
    int64_t lo = a.starts[i] > b.starts[j] ? a.starts[i] : b.starts[j];
    int64_t hi = a.ends[i] < b.ends[j] ? a.ends[i] : b.ends[j];
    if (hi > lo) total += hi - lo;
    if (a.ends[i] < b.ends[j]) {
      i++;
    } else {
      j++;
    }
  }
  return total;
}

// maskApi rleToString: signed 5-bit varint, 2nd-order diffs from index 3;
// at most 13 characters per count (65 bits)
void runs_to_string(const int64_t* c, int64_t m, std::string* s) {
  s->reserve(s->size() + m * 3);
  for (int64_t i = 0; i < m; i++) {
    int64_t x = c[i];
    if (i > 2) x -= c[i - 2];
    bool more = true;
    while (more) {
      int64_t ch = x & 0x1f;
      x >>= 5;  // arithmetic: Python's floor shift on negative values
      more = (ch & 0x10) ? (x != -1) : (x != 0);
      if (more) ch |= 0x20;
      s->push_back(static_cast<char>(ch + 48));
    }
  }
}

}  // namespace

extern "C" {

int64_t rle_counts_to_string(const int64_t* counts, int64_t m, char* out, int64_t cap) {
  std::string s;
  runs_to_string(counts, m, &s);
  int64_t n = static_cast<int64_t>(s.size());
  if (n <= cap) std::memcpy(out, s.data(), n);
  return n;
}

int64_t rle_string_to_counts(const char* s, int64_t len, int64_t* out, int64_t cap) {
  // maskApi rleFrString; a string of len characters holds <= len counts
  int64_t n = 0, i = 0;
  while (i < len) {
    uint64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= len) return -1;  // truncated: a continuation bit at the end
      uint64_t ch = static_cast<uint64_t>(s[i] - 48);
      if (5 * k < 64) x |= (ch & 0x1f) << (5 * k);
      more = (ch & 0x20) != 0;
      i++;
      if (!more && (ch & 0x10) && 5 * (k + 1) < 64) x |= ~uint64_t(0) << (5 * (k + 1));
      k++;
    }
    if (n > 2) x += static_cast<uint64_t>(out[n - 2]);  // wraps as int64 would
    if (n >= cap) return -1;
    out[n++] = static_cast<int64_t>(x);
  }
  return n;
}

int64_t rle_encode_pasted(const uint8_t* p, int64_t bh, int64_t bw, int64_t x0, int64_t y0,
                          int64_t im_h, int64_t im_w, char* out, int64_t cap) {
  // the RLE string of the (bh, bw) patch pasted at (x0, y0) into an
  // otherwise-zero (im_h, im_w) canvas, walked in column-major order without
  // materialising the canvas (the hot loop of the mask paste)
  std::vector<int64_t> counts;
  if (bh == 0 || bw == 0) {
    counts.push_back(im_h * im_w);
  } else {
    counts.reserve(static_cast<size_t>(bw) * 4 + 2);
    // runs alternate 0s/1s starting with a 0-run; counts.size() odd  ->
    // currently in a 0-run, even -> in a 1-run
    int64_t zero_run = x0 * im_h + y0;  // zero columns + lead-in of column 0
    for (int64_t j = 0; j < bw; j++) {
      int64_t i = 0;
      while (i < bh) {
        uint8_t v = p[i * bw + j];
        int64_t start = i;
        while (i < bh && p[i * bw + j] == v) i++;
        int64_t run = i - start;
        if (v == 0) {
          zero_run += run;
        } else if (zero_run == 0 && !counts.empty()) {
          counts.back() += run;  // contiguous across a column wrap
        } else {
          counts.push_back(zero_run);  // may be 0 (leading-1 convention)
          counts.push_back(run);
          zero_run = 0;
        }
      }
      // gap between this column's end and the next column's patch start
      zero_run += (im_h - y0 - bh) + (j + 1 < bw ? y0 : 0);
    }
    zero_run += (im_w - x0 - bw) * im_h;  // trailing zero columns
    if (zero_run > 0 || counts.empty()) counts.push_back(zero_run);
  }
  std::string s;
  runs_to_string(counts.data(), static_cast<int64_t>(counts.size()), &s);
  int64_t n = static_cast<int64_t>(s.size());
  if (n <= cap) std::memcpy(out, s.data(), n);
  return n;
}

int64_t rle_area(const int64_t* counts, int64_t m) {
  int64_t area = 0;
  for (int64_t i = 1; i < m; i += 2) area += counts[i];
  return area;
}

int rle_iou_matrix(const int64_t* counts, const int64_t* offsets, int64_t d, int64_t g,
                   const uint8_t* iscrowd, double* out) {
  // (d, g) IoU with the COCO crowd convention: intersection / dt area for a
  // crowd gt
  std::vector<Intervals> iv(d + g);
  for (int64_t k = 0; k < d + g; k++) {
    iv[k] = counts_to_intervals(counts + offsets[k], offsets[k + 1] - offsets[k]);
  }
  for (int64_t i = 0; i < d; i++) {
    const Intervals& dt = iv[i];
    for (int64_t j = 0; j < g; j++) {
      const Intervals& gt = iv[d + j];
      int64_t inter = intersect_area(dt, gt);
      double denom = iscrowd[j] ? static_cast<double>(dt.area)
                                : static_cast<double>(dt.area + gt.area - inter);
      out[i * g + j] = denom > 0 ? inter / denom : 0.0;
    }
  }
  return 0;
}

}  // extern "C"
