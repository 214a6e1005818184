// ECDF knot scan of the adaptive quantizer.
//
// The greedy piecewise-linear ECDF approximation (ops/quantizer.py; the reference's numba
// kernels at _quantizer.py:18-73) walks the sorted unique values one by one under a
// tangent-cone error bound. It is inherently sequential and runs on the host. Same
// operations in the same order as ops/quantizer.py::_scan_knot, so both give the same
// knots.

#include <cstdint>
#include <limits>

extern "C" {

// Walks from `knot` in `direction` (+1 forward / -1 backward) over the sentinel-
// extended arrays x (float64, length n) and y (int64 cumulative counts, length n).
// Returns the new knot index; *bin_count_out receives the count of the closed bin.
int64_t knot_scan(const double* x, const int64_t* y, int64_t n, int64_t knot,
                  int64_t max_bin_error, int64_t max_bin_size, int32_t direction,
                  int64_t* bin_count_out) {
  double lo_tangent = 0.0;
  double hi_tangent = std::numeric_limits<double>::infinity();
  int64_t candidate = knot + direction;
  int64_t bin_count = 0;
  const int64_t stop = direction > 0 ? n : -1;
  bool broke = false;
  while (candidate != stop) {
    const int64_t left = direction > 0 ? knot : candidate;
    const int64_t right = direction > 0 ? candidate : knot;
    bin_count = y[right - 1] - (left > 0 ? y[left - 1] : 0);
    if (bin_count > max_bin_size) {
      broke = true;
      break;
    }
    if (right != left + 1) {
      const double dx = x[right - 1] - x[left];
      const double dy = static_cast<double>(y[right - 1] - y[left]);
      const double hi = (dy + static_cast<double>(max_bin_error)) / dx;
      const double lo = (dy - static_cast<double>(max_bin_error)) / dx;
      if (hi < hi_tangent) hi_tangent = hi;
      if (lo > lo_tangent) lo_tangent = lo;
      const double tangent = dy / dx;
      if (!(lo_tangent <= tangent && tangent <= hi_tangent)) {
        broke = true;
        break;
      }
    }
    candidate += direction;
  }
  if (!broke) {
    candidate = stop - direction;
  }
  *bin_count_out = bin_count;
  return candidate;
}

}  // extern "C"
