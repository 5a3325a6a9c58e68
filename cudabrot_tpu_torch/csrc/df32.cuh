// Double-float (df32) arithmetic for the extended-precision kernels:
// ~48-bit-mantissa reals as (hi, lo) float pairs with hi = RN(hi + lo).
//
// The same functions, in the same operation order, as
// cudabrot_tpu_torch/ops/df32.py (port of cudabrot_tpu/ops/df32.py). Every
// product and sum goes through cb::fmul/fadd/fsub (orbit.cuh), which round
// once on the device (__fmul_rn/__fadd_rn never contract) and on the host
// (plain operators; build host code with -ffp-contract=off). So the
// error-free transformations hold without the JAX module's runtime-zero
// product seal, which is dropped here as in ops/df32.py: p = RN(a * b).
// A product's error is the one fused operation: cb::ffma, spelled
// __fmaf_rn on the device (-fmad=false keeps every other product and sum
// apart) and std::fmaf on the host (glibc's rounds once).
// Everything is __host__ __device__, so g++ can build the functions into a
// CPU harness (tests/test_torch_df32.py) and hold them bitwise against the
// PyTorch versions.
#pragma once

#include <string.h>

#include <cmath>

#include "orbit.cuh"

namespace cb {
namespace df {

struct F2 {
  float hi, lo;
};

// RN(a * b + c), rounded once.
CB_HD float ffma(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

CB_HD uint32_t float_bits(float a) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(a);
#else
  uint32_t u;
  memcpy(&u, &a, sizeof u);
  return u;
#endif
}

CB_HD float bits_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float a;
  memcpy(&a, &u, sizeof a);
  return a;
#endif
}

// s = RN(a + b), s + e == a + b exactly (Knuth).
CB_HD F2 two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float v = fsub(s, a);
  const float e = fadd(fsub(a, fsub(s, v)), fsub(b, v));
  return {s, e};
}

// s + e == a + b exactly, requiring |a| >= |b| (or a == 0).
CB_HD F2 quick_two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float e = fsub(b, fsub(s, a));
  return {s, e};
}

// Bitmask Veltkamp split: hi keeps the top 12 mantissa bits, lo = a - hi
// is exact; all partial products of two halves fit 24 bits exactly. The
// two-products below no longer need it (one FFMA gives their error); it
// stays the JAX module's split, function for function with ops/df32.py.
CB_HD F2 split(float a) {
  const float hi = bits_float(float_bits(a) & 0xFFFFF000u);
  return {hi, fsub(a, hi)};
}

// p = RN(a * b) and its exact error e = RN(a * b - p), one fused
// multiply-add: p + e == a * b wherever the product does not overflow and
// the error is not subnormal. ops/df32.two_prod computes the same bits in
// float64 everywhere (signed zeros, subnormal errors, inf and NaN).
CB_HD F2 two_prod(float a, float b) {
  const float p = fmul(a, b);
  return {p, ffma(a, b, -p)};
}

CB_HD F2 two_prod_sqr(float a) {
  const float p = fmul(a, a);
  return {p, ffma(a, a, -p)};
}

CB_HD F2 add(F2 a, F2 b) {
  const F2 s = two_sum(a.hi, b.hi);
  return quick_two_sum(s.hi, fadd(s.lo, fadd(a.lo, b.lo)));
}

CB_HD F2 add_f(F2 a, float b) {
  const F2 s = two_sum(a.hi, b);
  return quick_two_sum(s.hi, fadd(s.lo, a.lo));
}

CB_HD F2 neg(F2 a) { return {-a.hi, -a.lo}; }

CB_HD F2 sub(F2 a, F2 b) { return add(a, neg(b)); }

// Drops a.lo * b.lo (below 2^-48 relative).
CB_HD F2 mul(F2 a, F2 b) {
  const F2 p = two_prod(a.hi, b.hi);
  const float e = fadd(p.lo, fadd(fmul(a.hi, b.lo), fmul(a.lo, b.hi)));
  return quick_two_sum(p.hi, e);
}

CB_HD F2 sqr(F2 a) {
  const F2 p = two_prod_sqr(a.hi);
  const float e = fadd(p.lo, fmul(2.0f, fmul(a.hi, a.lo)));
  return quick_two_sum(p.hi, e);
}

// The sign is carried by hi: flip both parts where hi is negative.
CB_HD F2 abs_(F2 a) { return a.hi < 0.0f ? neg(a) : a; }

// One df32 iteration z <- f(z) + c (f = z^2, or the burning ship's
// fold-then-square). Returns |z'|^2 of the new point from the hi parts.
template <int FR>
CB_HD float complex_sqr_add(F2& zr, F2& zi, F2 cr, F2 ci) {
  F2 ar = zr, ai = zi;
  if (Traits<FR>::fold_abs) {
    ar = abs_(ar);
    ai = abs_(ai);
  }
  const F2 r2 = sqr(ar), i2 = sqr(ai), x = mul(ar, ai);
  zr = add(add(r2, neg(i2)), cr);
  // Doubling a df pair is exact.
  zi = add(F2{fadd(x.hi, x.hi), fadd(x.lo, x.lo)}, ci);
  return fadd(fmul(zr.hi, zr.hi), fmul(zi.hi, zi.hi));
}

// 24-bit grid index (as f32) -> window offset: one rounded product.
CB_HD float grid_offset(float k, float step) {
  return fmul(fsub(k, 8388608.0f), step);
}

// Canvas quantization of a df32 point (ops/binning.points_to_bin_ids_df,
// and points_to_bin_ids_df_sharded for a row window): the offset from the
// canvas minimum is taken in df32, its hi part is multiplied by the rounded
// inverse pitch and truncated. The range test runs on the float product
// (for x >= 0, trunc(x) < n iff x < n), so no out-of-range float is
// converted. The histogram holds rows row_start .. row_start + row_count - 1
// (orbit.cuh CanvasQ): the global range test first, then the window's.
// Returns -1 off the canvas (NaN included) or outside the window. Written
// with selects, not early returns: inside the replay's orbit loop a branch
// would split the loop body the compiler interleaves.
//
// WINDOW is a compile-time switch: false compiles the whole canvas's test
// alone (the window is then (0, height)). The df32 replays run at their
// lone orbit's issue floor, where the window's two integer operations a
// point made the deep-zoom cell's replay_deposit_ext 4% slower on an H100
// (measured in PR 10), so the kernels take the window's
// instantiation for a shard only (deposit_ext.cu dispatch).
struct CanvasQDf {
  F2 min_re, min_im;
  float inv_d_re, inv_d_im;
  int width, height;
  int row_start, row_count;
};

template <bool WINDOW>
CB_HD int64_t bin_id_df(const CanvasQDf& q, F2 re, F2 im) {
  const float dx = add(re, neg(q.min_re)).hi;
  const float dy = add(im, neg(q.min_im)).hi;
  const float col = fmul(dx, q.inv_d_re);
  const float row = fmul(dy, q.inv_d_im);
  const bool ok = (dx >= 0.0f) & (dy >= 0.0f) & (col < float(q.width)) &
                  (row < float(q.height));
  const int32_t c = int32_t(ok ? col : 0.0f), r = int32_t(ok ? row : 0.0f);
  if constexpr (WINDOW) {
    const int32_t lr = r - q.row_start;
    // 0 <= lr < row_count as one unsigned compare (row_count >= 0).
    const bool in = ok & (uint32_t(lr) < uint32_t(q.row_count));
    return in ? int64_t(lr) * q.width + c : -1;
  } else {
    return ok ? int64_t(r) * q.width + c : -1;
  }
}

// Whether a df32 replay needs the window's instantiation of bin_id_df.
CB_HD bool is_window(const CanvasQDf& q) {
  return q.row_start != 0 || q.row_count != q.height;
}

}  // namespace df
}  // namespace cb
