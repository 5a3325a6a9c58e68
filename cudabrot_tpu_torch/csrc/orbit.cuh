// Per-lane arithmetic shared by the classify and deposit kernels.
//
// Every function is __host__ __device__ and rounds each product and sum
// once (__fmul_rn/__fadd_rn on the device, plain operators on the host
// with contraction off), so the kernels equal the plain PyTorch versions
// in cudabrot_tpu_torch bitwise. The TPU's Mosaic kernels round the same
// way; only XLA's CPU backend contracts a*b+c into a fused multiply-add.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define CB_HD __host__ __device__ __forceinline__
#else
#define CB_HD inline
#endif

namespace cb {

#if defined(__CUDA_ARCH__)
CB_HD float fmul(float a, float b) { return __fmul_rn(a, b); }
CB_HD float fadd(float a, float b) { return __fadd_rn(a, b); }
CB_HD float fsub(float a, float b) { return __fsub_rn(a, b); }
CB_HD float fdiv(float a, float b) { return __fdiv_rn(a, b); }
#else
CB_HD float fmul(float a, float b) { return a * b; }
CB_HD float fadd(float a, float b) { return a + b; }
CB_HD float fsub(float a, float b) { return a - b; }
CB_HD float fdiv(float a, float b) { return a / b; }
#endif

// Clears the sign bit (NaNs included), as torch.abs and jnp.abs do.
CB_HD float fabs_(float a) { return fabsf(a); }

// Fractal maps, as the kernels' template argument (models/fractals.py
// kernel_id): the Mandelbrot map, the burning ship (|.| fold, no cull, no
// cycle detection), and the anti-Buddhabrot (interior emission, no cull).
enum Fractal { kBuddhabrot = 0, kBurningShip = 1, kAntiBuddhabrot = 2 };

template <int FR> struct Traits {
  static constexpr bool fold_abs = FR == kBurningShip;
  static constexpr bool use_cull = FR == kBuddhabrot;
  static constexpr bool interior = FR == kAntiBuddhabrot;
};

// One iteration z <- f(z) + c (models/fractals.step).
template <int FR>
CB_HD void step(float& zr, float& zi, float cr, float ci) {
  float ar = zr, ai = zi;
  if (Traits<FR>::fold_abs) {
    ar = fabs_(ar);
    ai = fabs_(ai);
  }
  float nzr = fadd(fsub(fmul(ar, ar), fmul(ai, ai)), cr);
  float nzi = fadd(fmul(fmul(2.0f, ar), ai), ci);
  zr = nzr;
  zi = nzi;
}

// Closed-form cardioid / period-2 bulb interior tests (cudabrot.cu:284-298).
CB_HD bool culled(float cr, float ci) {
  float imag_sq = fmul(ci, ci);
  float q = fsub(cr, 0.25f);
  q = fadd(fmul(q, q), imag_sq);
  bool card = fmul(q, fadd(q, fsub(cr, 0.25f))) < fmul(imag_sq, 0.25f);
  float t = fadd(cr, 1.0f);
  bool bulb = fadd(fmul(t, t), imag_sq) < 0.0625f;
  return card || bulb;
}

CB_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: jax.random's block function, bit for bit
// (ops/prng.threefry2x32).
CB_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

// uint32 random word -> uniform f32 in [lo, lo + span): the top 24 bits
// times 2^-24 (ops/prng.u32_to_domain).
CB_HD float u32_to_domain(uint32_t bits, float lo, float span) {
  float u = fmul(float(int32_t(bits >> 8)), 5.9604644775390625e-08f);
  return fadd(fmul(u, span), lo);
}

// Canvas quantization (ops/binning.points_to_bin_ids): points below the
// minimum are rejected before the divide; col/row truncate; the range
// test runs on the float quotient (trunc(x) < n  <=>  x < n for x >= 0),
// so no out-of-range float is ever converted. Returns -1 off-canvas.
struct CanvasQ {
  float min_re, min_im, d_re, d_im;
  int width, height;
};

CB_HD int64_t bin_id(const CanvasQ& q, float re, float im) {
  if (!(re >= q.min_re) || !(im >= q.min_im)) return -1;
  float col = fdiv(fsub(re, q.min_re), q.d_re);
  float row = fdiv(fsub(im, q.min_im), q.d_im);
  if (!(col < float(q.width)) || !(row < float(q.height))) return -1;
  return int64_t(int32_t(row)) * q.width + int32_t(col);
}

}  // namespace cb
