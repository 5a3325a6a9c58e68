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

// Canvas quantization (ops/binning.points_to_bin_ids, and
// points_to_bin_ids_sharded for a row window): points below the minimum are
// off the canvas; col/row truncate; the range test runs on the float
// quotient (trunc(x) < n  <=>  x < n for x >= 0). The histogram holds rows
// row_start .. row_start + row_count - 1 of the canvas: (0, height) for a
// whole canvas, a shard's window for a row-sharded one. The global range
// test comes first, then the window's; the id is (row - row_start) * width
// + col. Returns -1 off the canvas or outside the window. Without a branch:
// the quotients are taken for every point and the tests select, so a warp
// whose lanes land on and off the canvas does not diverge, and a float
// reaches the integer conversion only in range.
struct CanvasQ {
  float min_re, min_im, d_re, d_im;
  int width, height;
  int row_start, row_count;
};

CB_HD int64_t bin_id(const CanvasQ& q, float re, float im) {
  const float col = fdiv(fsub(re, q.min_re), q.d_re);
  const float row = fdiv(fsub(im, q.min_im), q.d_im);
  const bool on = (re >= q.min_re) & (im >= q.min_im) &
                  (col < float(q.width)) & (row < float(q.height));
  const int32_t r = int32_t(on ? row : 0.0f) - q.row_start;
  // 0 <= r < row_count as one unsigned compare (row_count >= 0).
  const bool in = on & (uint32_t(r) < uint32_t(q.row_count));
  const int64_t b = int64_t(r) * q.width + int32_t(on ? col : 0.0f);
  return in ? b : -1;
}

// Adds v to a histogram cell: an atomic on the device (threads share the
// histogram), a plain add in the single-threaded host build.
CB_HD void deposit_add(uint32_t* cell, uint32_t v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(cell, v);
#else
  *cell += v;
#endif
}

#if defined(__CUDACC__)
// Adds a per-thread count to *dst with one atomic per warp. Every thread
// of the warp must reach it (the kernels never return early).
__device__ __forceinline__ void warp_sum_add(unsigned long long* dst,
                                             uint32_t v) {
#if defined(__CUDA_ARCH__)
  const uint32_t s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(dst, (unsigned long long)s);
#else
  if (v != 0) atomicAdd(dst, (unsigned long long)v);
#endif
}
#endif

// Where a replayed orbit's bins go (b = -1 off the canvas, and at the
// steps past the lane's own n that a warp runs for its longest lane). The
// fused replay adds each on-canvas point to the histogram; the bigtiles
// route writes step s's bin id, or the sentinel nbins, at out[s] for
// s <= n, so an orbit of n + 1 steps fills n + 1 consecutive slots of the
// id stream. CanvasIdSink writes the on-canvas ids only, into a stream
// filled with the sentinel beforehand: the same stream, without a store per
// off-canvas point. TileSink stages the ids in a row of shared memory
// (replay_ids' tile, below).
struct DepositSink {
  uint32_t* hist;
  CB_HD void operator()(int, int64_t b) const {
    if (b >= 0) deposit_add(hist + b, 1u);
  }
};

struct IdSink {
  int32_t* out;
  int32_t nbins;
  int n;
  CB_HD void operator()(int s, int64_t b) const {
    if (s <= n) out[s] = b >= 0 ? int32_t(b) : nbins;
  }
};

struct CanvasIdSink {
  int32_t* out;
  CB_HD void operator()(int s, int64_t b) const {
    if (b >= 0) out[s] = int32_t(b);
  }
};

// The staged id writer of the f32 replay_ids kernel (deposit.cu): a warp
// replays its 32 lanes in step, kTile steps at a time; each lane writes the
// ids of those steps into its row of a kTile x kTile tile in shared memory
// (TileSink), and then the warp stores the tile row by row, row r's words
// going to kTile consecutive slots of lane r's orbit (store_tile_word): one
// coalesced store of 128 bytes a row, where a store per point sends the 32
// lanes of a step to 32 sectors. Rows are kTileStride = 33 words apart, so
// the 32 lanes' writes of one step (words x * 33 + j) and their reads of
// one row (words r * 33 + x) each fall in 32 different banks.
constexpr int kTile = 32;
constexpr int kTileStride = kTile + 1;

struct TileSink {
  int32_t* row;  // this lane's row of the tile
  int32_t nbins;
  CB_HD void operator()(int s, int64_t b) const {
    row[s & (kTile - 1)] = b >= 0 ? int32_t(b) : nbins;
  }
};

// Stores v at *p in global memory. On the device the st.global form: the
// compiler then knows the store cannot alias shared memory, so the tile's
// loads for the next rows need not wait for it (through a generic pointer
// each row's loads waited for the last row's store).
CB_HD void store_global(int32_t* p, int32_t v) {
#if defined(__CUDA_ARCH__)
  __stcg(p, v);
#else
  *p = v;
#endif
}

// Thread x's word of row r of a tile holding steps t0..t0 + kTile - 1:
// stored at out[t0 + x] when that is one of the row's len slots (len = the
// lane's n + 1, 0 for a lane without an orbit). len never exceeds the steps
// the warp ran, so a word the tile's last, shorter span left stale is never
// stored.
CB_HD void store_tile_word(const int32_t* tile, int r, int x, int t0,
                           int len, int32_t* out) {
  if (t0 + x < len) store_global(out + t0 + x, tile[r * kTileStride + x]);
}

// A replayed lane: c, and z, the point of the next step it records.
struct ReplayLane {
  float cr, ci, zr, zi;
};

// Starts the replay of emission c: z starts at c (cudabrot.cu:323-324), and
// step 0 records z_1.
template <int FR>
CB_HD ReplayLane replay_start(float c_r, float c_i) {
  ReplayLane l{c_r, c_i, c_r, c_i};
  step<FR>(l.zr, l.zi, c_r, c_i);
  return l;
}

// Steps s0..s1 - 1 of a lane's replay: each step's bin goes to the sink,
// b = -1 past the lane's n, which records nothing. Returns the on-canvas
// point count. Pipelined by one step: point s is binned after step s + 1 is
// taken, so the binning, which the orbit never reads, and the next step's
// dependent chain sit in one iteration and the compiler interleaves them.
template <int FR, class Sink>
CB_HD uint32_t replay_span(ReplayLane& l, int n, int s0, int s1,
                           const CanvasQ& q, const Sink& sink) {
  uint32_t hits = 0;
  for (int s = s0; s < s1; ++s) {
    const float pr = l.zr, pi = l.zi;
    step<FR>(l.zr, l.zi, l.cr, l.ci);
    const int64_t bin = bin_id(q, pr, pi);
    const int64_t b = s <= n ? bin : -1;
    sink(s, b);
    hits += b >= 0;
  }
  return hits;
}

// Replays one emission: steps s = 0..n are recorded including the escape
// point, and each step's bin goes to the sink. Returns the on-canvas point
// count. The loop runs `steps` >= n + 1 times: the replay kernels' queue
// (deposit.cu) runs all the lanes of a warp for its longest lane's length,
// so the warp never diverges.
template <int FR, class Sink>
CB_HD uint32_t replay_orbit(float c_r, float c_i, int n, int steps,
                            const CanvasQ& q, const Sink& sink) {
  ReplayLane l = replay_start<FR>(c_r, c_i);
  return replay_span<FR>(l, n, 0, steps, q, sink);
}

}  // namespace cb
