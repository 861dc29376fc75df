// Native host-runtime kernels for mom6_tpu.
//
// The device compute path is jax/XLA; this library covers the HOST side of
// the framework the way the reference's Fortran/FMS layer does — the
// pieces that run per diagnostics segment on the CPU and are hot enough
// to matter at scale (large grids pulled back for ocean.stats and
// chksum_diag):
//
//  * repro_sum    — the extended-fixed-point order-invariant global sum
//                   (reference: src/framework/MOM_coms.F90:30-70, the
//                   6 x 2^46 limb design), bit-identical to
//                   framework/repro_sum.py's numpy implementation but
//                   one pass, no temporaries;
//  * bitcount    — per-element popcount of the IEEE bit pattern summed
//                   mod 1e9 (reference: MOM_checksums.F90:110,2678);
//  * field_stats — fused min/max/mean/NaN-count in one pass (the
//                   calculateStatistics triplet of MOM_checksums.F90).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).
// Built on demand by mom6_tpu/native/__init__.py with g++ -O3.

#include <cstdint>
#include <cmath>

namespace {
constexpr int kNLimb = 6;
constexpr int kBits = 46;
constexpr int kTopExp = 3 * kBits - 63;  // largest magnitude ~ 2^75
}

extern "C" {

// Accumulate x[0:n) * scale into limbs[6] (int64, base 2^46 signed
// digits relative to 2^kTopExp).  Callers may accumulate several arrays
// into the same limbs; integer addition keeps the result exactly
// order-invariant.  Returns the number of non-finite elements seen
// (they are skipped, mirroring the python path's NaN poisoning being a
// separate check).
long long mom6_repro_sum_acc(const double* x, long long n, double scale,
                             long long* limbs) {
  long long bad = 0;
  // per-element decomposition into 46-bit signed digits; the local
  // accumulation order over j is fixed, so the whole is associative
  const double inv_top = std::ldexp(1.0, -kTopExp);
  const double chunk = std::ldexp(1.0, kBits);
  long long acc[kNLimb] = {0, 0, 0, 0, 0, 0};
  for (long long i = 0; i < n; ++i) {
    double v = x[i] * scale;
    if (!std::isfinite(v)) { ++bad; continue; }
    double r = v * inv_top;
    for (int j = 0; j < kNLimb; ++j) {
      r *= chunk;
      double c = std::floor(r);
      acc[j] += static_cast<long long>(c);
      r -= c;
    }
  }
  for (int j = 0; j < kNLimb; ++j) limbs[j] += acc[j];
  return bad;
}

// Carry-propagate and convert the limb accumulator to a double.
double mom6_repro_sum_finish(long long* limbs) {
  for (int j = kNLimb - 1; j > 0; --j) {
    long long carry = limbs[j] >> kBits;
    limbs[j] -= carry << kBits;
    limbs[j - 1] += carry;
  }
  double total = 0.0;
  for (int j = 0; j < kNLimb; ++j) {
    total += static_cast<double>(limbs[j])
             * std::ldexp(1.0, kTopExp - (j + 1) * kBits);
  }
  return total;
}

// popcount of the IEEE-754 bit patterns, summed mod 1e9
// (MOM_checksums.F90 bitcount :2678, bc_modulus :110).
long long mom6_bitcount64(const double* x, long long n) {
  const long long kMod = 1000000000LL;
  unsigned long long acc = 0;
  const unsigned long long* bits =
      reinterpret_cast<const unsigned long long*>(x);
  for (long long i = 0; i < n; ++i) {
    acc += static_cast<unsigned long long>(__builtin_popcountll(bits[i]));
    if (acc >= (1ULL << 62)) acc %= kMod;
  }
  return static_cast<long long>(acc % kMod);
}

long long mom6_bitcount32(const float* x, long long n) {
  const long long kMod = 1000000000LL;
  unsigned long long acc = 0;
  const unsigned int* bits = reinterpret_cast<const unsigned int*>(x);
  for (long long i = 0; i < n; ++i) {
    acc += static_cast<unsigned long long>(__builtin_popcount(bits[i]));
    if (acc >= (1ULL << 62)) acc %= kMod;
  }
  return static_cast<long long>(acc % kMod);
}

// Fused statistics pass: out = {min, max, mean, nan_count}.
void mom6_field_stats(const double* x, long long n, double* out) {
  double mn = HUGE_VAL, mx = -HUGE_VAL, sum = 0.0, comp = 0.0;
  long long bad = 0;
  for (long long i = 0; i < n; ++i) {
    double v = x[i];
    if (std::isnan(v)) { ++bad; continue; }
    if (v < mn) mn = v;
    if (v > mx) mx = v;
    // Neumaier compensated accumulation for a stable mean
    double t = sum + v;
    comp += (std::fabs(sum) >= std::fabs(v)) ? (sum - t) + v : (v - t) + sum;
    sum = t;
  }
  long long good = n - bad;
  out[0] = (good > 0) ? mn : 0.0;
  out[1] = (good > 0) ? mx : 0.0;
  out[2] = (good > 0) ? (sum + comp) / static_cast<double>(good) : 0.0;
  out[3] = static_cast<double>(bad);
}

}  // extern "C"
