// Q15 fixed-point radix-2 FFT with block-floating-point scaling.
//
// Native analog of the reference's fixed-point track
// (optimizations/fixed_point_fft.c): Q15 int16 complex samples (:33-40),
// saturating rounding multiply (:55-86), precomputed Q15 twiddle table
// (:95-107), per-stage >>1 scaling to prevent overflow (:169-178),
// inverse via conjugation (:187-207), and block-floating-point
// normalization (:210-242). This is the embedded/host-side reduced
// precision reference the reduced-precision experiments are tested
// against.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

constexpr int32_t kQ15One = 32767;

// Saturating Q15 multiply with rounding (fixed_point_fft.c:55-86).
inline int16_t q15_mul(int16_t a, int16_t b) {
  int32_t p = (int32_t)a * (int32_t)b;  // Q30
  p += 1 << 14;                          // round
  p >>= 15;                              // back to Q15
  if (p > kQ15One) p = kQ15One;
  if (p < -32768) p = -32768;
  return (int16_t)p;
}

inline int16_t sat16(int32_t v) {
  if (v > kQ15One) return (int16_t)kQ15One;
  if (v < -32768) return (int16_t)-32768;
  return (int16_t)v;
}

void bit_reverse_permute(int16_t* re, int16_t* im, int n) {
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      int16_t t = re[i]; re[i] = re[j]; re[j] = t;
      t = im[i]; im[i] = im[j]; im[j] = t;
    }
  }
}

}  // namespace

extern "C" {

// In-place Q15 FFT. inverse: 0 = forward, 1 = inverse.
// Per-stage >>1 scaling in BOTH directions; returns the total block
// exponent (number of right shifts applied = log2(n)), so the true
// values are out * 2^exponent / 32768 (forward) — callers undo it.
// Returns a negative error code for invalid n.
int fftlab_q15_fft(int16_t* re, int16_t* im, int32_t n, int32_t inverse) {
  if (n < 2 || (n & (n - 1)) != 0) return -1;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;

  // Q15 twiddle table: w[j] = exp(-2*pi*i*j/n), j < n/2
  // (fixed_point_fft.c:95-107 precomputed table).
  std::vector<int16_t> twr((size_t)(n / 2)), twi((size_t)(n / 2));
  for (int j = 0; j < n / 2; ++j) {
    double ang = -2.0 * M_PI * j / n;
    double s = inverse ? -1.0 : 1.0;  // inverse = conjugated twiddles
    twr[(size_t)j] = sat16((int32_t)lrint(cos(ang) * 32767.0));
    twi[(size_t)j] = sat16((int32_t)lrint(s * sin(ang) * 32767.0));
  }

  bit_reverse_permute(re, im, n);

  for (int stage = 1; stage <= log2n; ++stage) {
    int mlen = 1 << stage;
    int half = mlen >> 1;
    int stride = n >> stage;  // twiddle index stride
    for (int k = 0; k < n; k += mlen) {
      for (int j = 0; j < half; ++j) {
        int16_t wr = twr[(size_t)(j * stride)];
        int16_t wi = twi[(size_t)(j * stride)];
        int u = k + j, v = k + j + half;
        // Accumulate the complex twiddle product in int32: each
        // q15_mul result spans the full int16 range, so their
        // sum/difference spans ~[-65535, 65535] — a bare int16 cast
        // would WRAP (not saturate) for inputs near full scale. The
        // >>1 block scaling below brings it back in range before the
        // final saturation.
        int32_t tr = (int32_t)q15_mul(re[v], wr) - q15_mul(im[v], wi);
        int32_t ti = (int32_t)q15_mul(re[v], wi) + q15_mul(im[v], wr);
        // butterfly with >>1 block scaling (fixed_point_fft.c:169-178)
        re[v] = sat16(((int32_t)re[u] - tr) >> 1);
        im[v] = sat16(((int32_t)im[u] - ti) >> 1);
        re[u] = sat16(((int32_t)re[u] + tr) >> 1);
        im[u] = sat16(((int32_t)im[u] + ti) >> 1);
      }
    }
  }
  return log2n;
}

// Block-floating-point normalization (fixed_point_fft.c:210-242): shift
// the block left so the max |value| uses full Q15 range; returns the
// number of left shifts applied.
int fftlab_q15_normalize(int16_t* re, int16_t* im, int32_t n) {
  int32_t maxv = 0;
  for (int i = 0; i < n; ++i) {
    int32_t a = re[i] < 0 ? -re[i] : re[i];
    int32_t b = im[i] < 0 ? -im[i] : im[i];
    if (a > maxv) maxv = a;
    if (b > maxv) maxv = b;
  }
  if (maxv == 0) return 0;
  int shifts = 0;
  while ((maxv << (shifts + 1)) <= kQ15One) ++shifts;
  if (shifts > 0) {
    for (int i = 0; i < n; ++i) {
      re[i] = (int16_t)(re[i] << shifts);
      im[i] = (int16_t)(im[i] << shifts);
    }
  }
  return shifts;
}

}  // extern "C"
