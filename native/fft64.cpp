// Double-precision host FFT backend.
//
// The second execution backend of the framework's dispatch story — the
// role the reference gives its GPU/Metal legs (gpu/fft_gpu.c:49-97
// backend vtable; the Metal leg is fake, fft_metal.m:257-268). Here the
// fast accelerator path is XLA on the device; THIS is the genuine
// host-native leg: an iterative table-twiddle radix-2 Cooley-Tukey in
// C++ double precision. It serves as
//   (1) an independent float64 oracle (a different codebase than both
//       numpy's pocketfft and the JAX registry — cross-checks both),
//   (2) the host-side serving fallback when no device is reachable
//       (fftlab/native consumers: ring buffer + WAV + this),
//   (3) the plan layer's ALGO_NATIVE row (plan_dft_1d_native), the
//       analog of the reference's ALGO_GPU_* plan paths
//       (fft_auto.c:220-229, 275-282) with the direction bug fixed
//       (fft_gpu.c:252,258 hardcodes FORWARD; this honors `inverse`).
//
// Layout: split re/im double arrays (the framework's design stance,
// SURVEY.md §7 / simd_fft.c:92-109), batch-first [batch, n] row-major.
// Power-of-two n only — arbitrary n rides the Python Bluestein layer on
// top of this (bluestein.c:79-148 semantics), same as the registry.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

bool is_pow2(int64_t n) { return n > 0 && (n & (n - 1)) == 0; }

// Bit-reversal permutation (radix2_dit.c:70-77 semantics, computed
// incrementally — no table).
void bit_reverse_permute(double* re, double* im, int64_t n) {
  for (int64_t i = 1, j = 0; i < n; ++i) {
    int64_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j |= bit;
    if (i < j) {
      double tr = re[i]; re[i] = re[j]; re[j] = tr;
      double ti = im[i]; im[i] = im[j]; im[j] = ti;
    }
  }
}

// One whole-array twiddle table: tw[k] = exp(sign * 2*pi*i * k / n),
// k < n/2. Stage m uses entries at stride n/m — one table serves every
// stage (the precompute the reference plans but never uses,
// fft_auto.c:199-212, actually consumed here).
void build_twiddles(int64_t n, int sign, std::vector<double>& twr,
                    std::vector<double>& twi) {
  int64_t half = n / 2;
  twr.resize(half > 0 ? half : 1);
  twi.resize(half > 0 ? half : 1);
  for (int64_t k = 0; k < half; ++k) {
    double ang = sign * 2.0 * kPi * (double)k / (double)n;
    twr[k] = std::cos(ang);
    twi[k] = std::sin(ang);
  }
}

// In-place radix-2 DIT butterflies on bit-reversed data
// (radix2_dit.c:84-112 hot loop, table twiddles instead of the running
// product — exact to the last ulp per stage).
void fft_pow2_inplace(double* re, double* im, int64_t n,
                      const std::vector<double>& twr,
                      const std::vector<double>& twi) {
  bit_reverse_permute(re, im, n);
  for (int64_t m = 2; m <= n; m <<= 1) {
    int64_t hm = m >> 1;
    int64_t step = n / m;  // twiddle stride for this stage
    for (int64_t k = 0; k < n; k += m) {
      for (int64_t j = 0; j < hm; ++j) {
        double wr = twr[j * step];
        double wi = twi[j * step];
        int64_t u = k + j;
        int64_t v = u + hm;
        double tr = re[v] * wr - im[v] * wi;
        double ti = re[v] * wi + im[v] * wr;
        re[v] = re[u] - tr;
        im[v] = im[u] - ti;
        re[u] += tr;
        im[u] += ti;
      }
    }
  }
}

}  // namespace

extern "C" {

// Batched in-place c2c FFT on split double planes.
//   re, im : [batch * n] row-major
//   inverse: 0 forward (unscaled), nonzero inverse (1/n scaled —
//            radix2_dit.c:115-119 convention; the scaling the
//            reference's cuFFT leg forgot, fft_cuda.cu:175-182)
// Returns 0, or -1 for bad arguments (n not a power of two / n < 1).
int32_t fftlab_fft64(double* re, double* im, int64_t batch, int64_t n,
                     int32_t inverse) {
  if (!re || !im || batch < 0 || !is_pow2(n)) return -1;
  std::vector<double> twr, twi;
  build_twiddles(n, inverse ? +1 : -1, twr, twi);
  for (int64_t b = 0; b < batch; ++b) {
    double* r = re + b * n;
    double* i = im + b * n;
    fft_pow2_inplace(r, i, n, twr, twi);
    if (inverse) {
      double s = 1.0 / (double)n;
      for (int64_t k = 0; k < n; ++k) {
        r[k] *= s;
        i[k] *= s;
      }
    }
  }
  return 0;
}

}  // extern "C"
