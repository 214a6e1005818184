// Weighted isotonic regression by pool-adjacent-violators (PAV).
//
// The native counterpart of the Python stack loop in
// models/isotonic.py::pool_adjacent_violators. The classifier's probability calibrator
// fits on the leave-one-out predictions of every training row, so this sequential host
// loop sees millions of points. Same operations in the same order as the Python loop
// (blocks merge while the left mean is >= the right mean, weighted-averaging their
// values), so both give identical bits.

#include <cstdint>

extern "C" {

// y, w: length-n block values and weights (already sorted by x and reduced to unique x).
// out: length-n result (block means expanded back to one value per entry).
// means, weights, counts: caller-allocated length-n scratch.
void pav_fit(const double* y, const double* w, int64_t n, double* out,
             double* means, double* weights, int64_t* counts) {
  int64_t top = 0;
  for (int64_t i = 0; i < n; ++i) {
    means[top] = y[i];
    weights[top] = w[i];
    counts[top] = 1;
    ++top;
    while (top > 1 && means[top - 2] >= means[top - 1]) {
      const double wa = weights[top - 2];
      const double wb = weights[top - 1];
      means[top - 2] = (means[top - 2] * wa + means[top - 1] * wb) / (wa + wb);
      weights[top - 2] = wa + wb;
      counts[top - 2] += counts[top - 1];
      --top;
    }
  }
  int64_t pos = 0;
  for (int64_t b = 0; b < top; ++b) {
    for (int64_t r = 0; r < counts[b]; ++r) out[pos++] = means[b];
  }
}

}  // extern "C"
