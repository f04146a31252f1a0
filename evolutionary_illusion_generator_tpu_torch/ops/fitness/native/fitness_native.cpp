// Native (C++) batch fitness scorer.
//
// Float64 host scoring is the default fitness path (bit-compatible rankings
// with the reference's numpy math, SURVEY.md §7); at pop 256 x K 256 the
// O(pop*K^2) swarm metric is the host-side hot spot.  This translation unit
// scores a whole population in one call, reproducing the exact arithmetic
// of ops/fitness/metrics_np.py / calculate.py — including the documented
// reference quirks:
//   * swarm "optimal" angle ((a + df*pi) mod 2) * pi        (quirk #2)
//   * horizontal symmetry broadcast [ndx, ndx] below middle (quirk #1)
//   * strength uses the x-component mean only               (quirk #3)
//
// Exposed as a C ABI consumed via ctypes (native.py); built with
//   g++ -O3 -march=native -shared -fPIC -o libfitness_native.so fitness_native.cpp
//
// Vector rows are [x, y, dx, dy] (px), one (K, 4) block per candidate with
// a count of valid leading rows.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Vecs {
  const double* data;  // (count, 4) valid rows
  int count;
  double x(int i) const { return data[4 * i]; }
  double y(int i) const { return data[4 * i + 1]; }
  double dx(int i) const { return data[4 * i + 2]; }
  double dy(int i) const { return data[4 * i + 3]; }
  double norm(int i) const { return std::sqrt(dx(i) * dx(i) + dy(i) * dy(i)); }
};

// fitness_calculator.py:18-27 — keep rows with flow norm <= limit.
// Writes surviving row indices into keep; returns survivor count.
int plausibility(const Vecs& v, double limit, std::vector<int>& keep) {
  keep.clear();
  for (int i = 0; i < v.count; ++i) {
    if (!(v.norm(i) > limit)) keep.push_back(i);
  }
  return static_cast<int>(keep.size());
}

double mean_of(const std::vector<double>& xs) {
  double s = 0;
  for (double x : xs) s += x;
  return xs.empty() ? 0.0 : s / xs.size();
}

double var_of(const std::vector<double>& xs) {
  double m = mean_of(xs);
  double s = 0;
  for (double x : xs) s += (x - m) * (x - m);
  return xs.empty() ? 0.0 : s / xs.size();
}

// fitness_calculator.py:32-41 (x-mean only).
double strength_number(const Vecs& v, const std::vector<int>& keep,
                       double max_norm) {
  std::vector<double> absdx, norms;
  absdx.reserve(keep.size());
  norms.reserve(keep.size());
  for (int i : keep) {
    absdx.push_back(std::fabs(v.dx(i)));
    norms.push_back(v.norm(i));
  }
  double var = var_of(norms);
  if (var > 1.0) var = 1.0;
  return mean_of(absdx) / max_norm * (1.0 - var);
}

// fitness_calculator.py:81-120 with the [2:3] broadcast quirk.
double horizontal_symmetry(const Vecs& v, const std::vector<int>& keep,
                           double lim0, double lim1) {
  int middle = static_cast<int>(lim1 / 2);
  std::vector<double> col_x, col_y;
  for (int i : keep) {
    double yy = v.y(i);
    if (yy < lim0 || yy > lim1) continue;
    double n = v.norm(i);
    double ndx = v.dx(i) / n;
    double ndy = v.dy(i) / n;
    if (yy < middle) {
      col_x.push_back(ndx);
      col_y.push_back(ndx);  // reference broadcasts ndx into both columns
    } else {
      col_x.push_back(-ndx);
      col_y.push_back(ndy);
    }
  }
  if (col_x.empty()) return 0.0;
  double var_x = var_of(col_x);
  double mean_x = std::fabs(mean_of(col_x));
  double mean_y = std::fabs(mean_of(col_y));
  return ((1.0 - var_x) + mean_x + (1.0 - mean_y)) / 3.0;
}

// fitness_calculator.py:124-159 (O(n^2), precedence quirk preserved).
double swarm(const Vecs& v, const std::vector<int>& keep) {
  const int n = static_cast<int>(keep.size());
  if (n == 0) return 0.0;
  std::vector<double> px(n), py(n), ang(n);
  for (int a = 0; a < n; ++a) {
    int i = keep[a];
    double nm = v.norm(i);
    px[a] = v.x(i);
    py[a] = v.y(i);
    ang[a] = std::acos(v.dx(i) / nm);
  }
  double score = 0.0;
  for (int a = 0; a < n; ++a) {
    double loss_sum = 0.0;
    for (int j = 0; j < n; ++j) {
      double ddx = px[j] - px[a];
      double ddy = py[j] - py[a];
      double df = (ddx * ddx + ddy * ddy) / 1.0e4;
      if (df > 1.0) df = 1.0;
      double close = df < 1.0 ? 1.0 : 0.0;
      double optimal = std::fmod(ang[a] + df * kPi, 2.0) * kPi;
      loss_sum += close * std::fabs(ang[j] - optimal);
    }
    score += (kPi - loss_sum / n) / kPi;
  }
  return score / n;
}

// fitness_calculator.py:166-215.
double rotation_symmetry(const Vecs& v, const std::vector<int>& keep,
                         double w, double h, double lim0, double lim1) {
  double cx = w / 2.0, cy = h / 2.0;
  std::vector<double> rx, ry;
  for (int i : keep) {
    double vcx = v.x(i) - cx;
    double vcy = v.y(i) - cy;
    double dist = std::sqrt(vcx * vcx + vcy * vcy);
    if (dist < lim0 || dist > lim1 || dist == 0.0) continue;
    double nm = v.norm(i);
    double fdx = v.dx(i) / nm;
    double fdy = v.dy(i) / nm;
    double x1 = vcx + fdx;
    double y1 = vcy + fdy;
    rx.push_back((x1 * vcx + y1 * vcy) / dist - dist);
    ry.push_back((-x1 * vcy + y1 * vcx) / dist);
  }
  if (rx.size() < 2) return 0.0;
  double vx = var_of(rx);
  double vy = var_of(ry);
  return ((1.0 - vx) * (1.0 - vx) + (1.0 - vy) * (1.0 - vy)) / 2.0;
}

// generate_illusion.py:564-609 — the per-structure switch.
double score_one(int structure, const Vecs& v, double w, double h) {
  std::vector<int> keep;
  switch (structure) {
    case 0: {  // Bands
      plausibility(v, 0.15, keep);
      if (keep.empty()) return 0.0;
      double step = h / 4.0;
      return horizontal_symmetry(v, keep, 0.0, step * 2.0);
    }
    case 1:
    case 3: {  // Circles / CirclesFree
      const double max_strength = 0.3;
      int n = plausibility(v, max_strength, keep);
      if (n <= 24) return 0.0;
      double dir = rotation_symmetry(v, keep, w, h, 0.0, h / 2.0);
      double stg = strength_number(v, keep, max_strength);
      return 0.7 * dir + 0.3 * stg;
    }
    case 2: {  // Free
      const double max_strength = 0.4;
      int n = plausibility(v, max_strength, keep);
      if (n == 0) return 0.0;
      double stg = strength_number(v, keep, max_strength);
      double cnt = (n < 15 ? n : 15) / 15.0;
      double sw = swarm(v, keep);
      return 0.5 * sw + 0.1 * stg + 0.4 * cnt;
    }
    default:
      return 0.0;
  }
}

}  // namespace

extern "C" {

// vectors: (pop, K, 4) row-major f64; mask: (pop, K) uint8 validity.
// Valid rows are compacted per candidate before scoring.
void score_population(int structure, const double* vectors,
                      const uint8_t* mask, int pop, int K, double w, double h,
                      double* out) {
  std::vector<double> compact(static_cast<size_t>(K) * 4);
  for (int p = 0; p < pop; ++p) {
    const double* block = vectors + static_cast<int64_t>(p) * K * 4;
    const uint8_t* m = mask + static_cast<int64_t>(p) * K;
    int count = 0;
    for (int k = 0; k < K; ++k) {
      if (m[k]) {
        for (int c = 0; c < 4; ++c) compact[4 * count + c] = block[4 * k + c];
        ++count;
      }
    }
    Vecs v{compact.data(), count};
    out[p] = score_one(structure, v, w, h);
  }
}

int native_abi_version() { return 1; }

}  // extern "C"
