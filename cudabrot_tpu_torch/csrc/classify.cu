// Persistent-lane classify pass for Hopper (sm_90a).
//
// Replaces the TPU classify kernel cudabrot_tpu/ops/pallas_kernels.py
// _make_kernel (called by classify_pass). Same function: every lane is an
// independent sampler that, the moment its sample finishes, draws a fresh
// c from Threefry-2x32 keyed by the pass seed over (lane id, window index),
// culls the cardioid and bulb, iterates z^2 + c with thin or step escape
// tracking and Brent cycle checks, band-filters, and queues in-band
// finishes in a pending register flushed every steps_per_flush steps (a
// second finish in one flush window overwrites the first: the unbiased
// thinning of the reference design, kept).
//
// Design. The TPU runs the lanes as (R, 128) vectors and the chunks as a
// sequential grid. Here one thread is one lane: its state lives in
// registers, is loaded once and stored once per pass, and the chunk grid
// is a loop inside the thread, flushing that lane's emission slots after
// each chunk. All arrays are lane-contiguous ([..., lane]), so every load
// and store of a warp is one coalesced 128-byte transaction. Threefry runs
// only on a refill: it is counter-based, so its words are the ones the TPU
// kernel draws every window and discards unless the lane finished.
//
// Bound. Operations: ~9 f32 operations per inner lane-step plus the
// boundary work per window and Threefry per draw, against the card's f32
// rate; memory traffic is a few bytes per lane per chunk. Escape-time
// divergence inside a warp is the cost the design cannot remove — a
// finished lane refills at once, so a warp's lanes stay busy, but their
// boundary branches diverge.
//
// Arithmetic rounds once per operation (orbit.cuh), so this kernel equals
// the plain PyTorch version (ops/classify.classify_pass_plain) bitwise.
//
// The file also holds threefry_bits, the compaction's selection words
// (the JAX engine draws them with jax.random.bits in XLA).
#include <cuda_runtime.h>

#include "orbit.cuh"

namespace {

constexpr float kBig = 1.0e30f;  // Brent "never matches" saved point
constexpr int kSave0 = 16;       // first Brent save index, doubling
constexpr int kStats = 5;        // drawn, culled, in_band, cycles, wasted

struct ClassifyArgs {
  float *cr, *ci, *zr, *zi, *sr, *si;
  int32_t *it, *sv, *dead, *vis;
  float* emit_c;          // (chunks, 2, lanes)
  int32_t* emit_it;       // (chunks, lanes), -1 = empty slot
  int32_t* stats;         // (5, lanes)
  const uint32_t* bits;   // (chunks, windows, 2, lanes) or null: threefry
  uint32_t k0, k1;
  int lanes, chunks, windows, unroll, min_it, max_it, detect;
  float dom_r0, dom_rspan, dom_i0, dom_ispan;
  float vx0, vx1, vy0, vy1;
};

template <int FR, bool THIN, bool VISIT>
__global__ void __launch_bounds__(256) classify_kernel(ClassifyArgs a) {
  using cb::fadd;
  using cb::fmul;
  using cb::fsub;
  using T = cb::Traits<FR>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.lanes) return;
  const size_t L = size_t(a.lanes);
  const int U = a.unroll;

  float cr = a.cr[lane], ci = a.ci[lane], zr = a.zr[lane], zi = a.zi[lane];
  float sr = a.sr[lane], si = a.si[lane];
  int it = a.it[lane], sv = a.sv[lane], dead = a.dead[lane];
  int vis = a.vis[lane];
  float p_cr = 0.0f, p_ci = 0.0f;
  int p_it = -1;
  int n_drawn = 0, n_cull = 0, n_band = 0, n_cyc = 0, n_waste = 0;

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      // --- inner window: U orbit updates ---
      float azr = zr, azi = zi;
      bool esc, cyc;
      int needed;
      if (THIN) {
        // Survival counter: escape is a point of no return, so the
        // 0-based escape index is it + (steps that stayed inside).
        int nesc = 0;
        float r2 = fmul(azr, azr), i2 = fmul(azi, azi);
        bool hit = false;
        for (int k = 0; k < U; ++k) {
          float nzr = fadd(fsub(r2, i2), cr);
          float nzi = T::fold_abs
                          ? fadd(fmul(2.0f, cb::fabs_(fmul(azr, azi))), ci)
                          : fadd(fmul(fmul(2.0f, azr), azi), ci);
          azr = nzr;
          azi = nzi;
          r2 = fmul(azr, azr);
          i2 = fmul(azi, azi);
          nesc += fadd(r2, i2) <= 4.0f;
          if (VISIT)
            hit |= (azr >= a.vx0) & (azr < a.vx1) & (azi >= a.vy0) &
                   (azi < a.vy1);
        }
        if (VISIT) vis |= int(hit);
        esc = nesc < U;
        needed = it + nesc;
        cyc = a.detect && azr == sr && azi == si && !esc;
      } else {
        esc = false;
        cyc = false;
        needed = 0;
        for (int k = 0; k < U; ++k) {
          cb::step<FR>(azr, azi, cr, ci);
          bool newly = fadd(fmul(azr, azr), fmul(azi, azi)) > 4.0f && !esc &&
                       !cyc;
          if (newly) needed = it + k;
          esc = esc || newly;
          if (a.detect) cyc = cyc || (azr == sr && azi == si && !esc);
        }
      }

      // --- boundary: termination, band filter, Brent, refill, stats ---
      const int it_new = it + U;
      const bool deadb = dead != 0;
      const bool fin = esc || cyc || it_new >= a.max_it || deadb;
      bool in_band;
      if (T::interior) {
        const bool esc_in_cap = esc && needed < a.max_it;
        in_band = (cyc || it_new >= a.max_it) && !esc_in_cap && !deadb;
        if (VISIT) in_band = in_band && vis != 0;
        if (in_band) p_it = a.max_it - 1;
      } else {
        in_band = esc && !deadb && needed >= a.min_it && needed < a.max_it;
        if (VISIT) in_band = in_band && vis != 0;
        if (in_band) p_it = needed;
      }
      if (in_band) {
        p_cr = cr;
        p_ci = ci;
      }
      n_band += in_band;
      n_cyc += cyc && !deadb;
      if (deadb) n_waste += U;
      if (esc && !deadb) n_waste += it_new - needed - 1;

      if (fin) {
        uint32_t rb_r, rb_i;
        const int gwin = chunk * a.windows + w;
        if (a.bits != nullptr) {
          const size_t base = size_t(gwin) * 2 * L + lane;
          rb_r = a.bits[base];
          rb_i = a.bits[base + L];
        } else {
          rb_r = uint32_t(lane);
          rb_i = uint32_t(gwin);
          cb::threefry2x32(a.k0, a.k1, rb_r, rb_i);
        }
        const float ncr = cb::u32_to_domain(rb_r, a.dom_r0, a.dom_rspan);
        const float nci = cb::u32_to_domain(rb_i, a.dom_i0, a.dom_ispan);
        const bool ncull = T::use_cull && cb::culled(ncr, nci);
        cr = ncr;
        ci = nci;
        zr = ncr;  // z starts at c (cudabrot.cu:323-324)
        zi = nci;
        it = 0;
        sr = kBig;
        si = kBig;
        sv = kSave0;
        dead = ncull;
        if (VISIT) vis = 0;
        n_drawn += 1;
        n_cull += ncull;
      } else {
        if (a.detect && it_new >= sv) {
          sr = azr;
          si = azi;
          sv = sv * 2;
        }
        zr = azr;
        zi = azi;
        it = it_new;
      }
    }
    // Flush this chunk's pending emission slot and clear it.
    a.emit_c[(size_t(chunk) * 2) * L + lane] = p_cr;
    a.emit_c[(size_t(chunk) * 2 + 1) * L + lane] = p_ci;
    a.emit_it[size_t(chunk) * L + lane] = p_it;
    p_cr = fmul(p_cr, 0.0f);
    p_ci = fmul(p_ci, 0.0f);
    p_it = -1;
  }

  a.cr[lane] = cr;
  a.ci[lane] = ci;
  a.zr[lane] = zr;
  a.zi[lane] = zi;
  a.sr[lane] = sr;
  a.si[lane] = si;
  a.it[lane] = it;
  a.sv[lane] = sv;
  a.dead[lane] = dead;
  a.vis[lane] = vis;
  const int counts[kStats] = {n_drawn, n_cull, n_band, n_cyc, n_waste};
  for (int s = 0; s < kStats; ++s) a.stats[size_t(s) * L + lane] = counts[s];
}

template <int FR, bool THIN, bool VISIT>
cudaError_t launch(const ClassifyArgs& a, cudaStream_t stream) {
  const int block = 256;
  const int grid = (a.lanes + block - 1) / block;
  classify_kernel<FR, THIN, VISIT><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const ClassifyArgs&, cudaStream_t);

template <int FR>
LaunchFn pick(int thin, int visit) {
  if (!thin) return visit ? nullptr : launch<FR, false, false>;
  return visit ? launch<FR, true, true> : launch<FR, true, false>;
}

// jax.random.bits(key, (n,), uint32) for the compaction's selection key:
// word i = x0 ^ x1 with (x0, x1) = threefry2x32(key, (0, i)), stored
// zero-extended in int64 (ops/prng.bits). One thread per word; the bound
// is the 8 bytes written per word.
__global__ void __launch_bounds__(256)
    threefry_bits_kernel(uint32_t k0, uint32_t k1, long long n,
                         long long* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t x0 = 0, x1 = uint32_t(i);
    cb::threefry2x32(k0, k1, x0, x1);
    out[i] = (long long)(x0 ^ x1);
  }
}

}  // namespace

// n < 2^32 words into out (int64). Returns the cudaError_t of the launch.
extern "C" int cb_threefry_bits(uint32_t k0, uint32_t k1, long long n,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  long long grid = (n + 255) / 256;
  if (grid > 132 * 64) grid = 132 * 64;  // grid-stride beyond this
  threefry_bits_kernel<<<int(grid), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, static_cast<long long*>(out));
  return int(cudaGetLastError());
}

// ptrs: cr, ci, zr, zi, sr, si, it, sv, dead, vis, emit_c, emit_it, stats,
//       bits (null for threefry).
// iargs: fractal, thin, visit, lanes, chunks, windows, unroll, min_it,
//        max_it, detect.
// fargs: dom_r0, dom_rspan, dom_i0, dom_ispan, vx0, vx1, vy0, vy1.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_classify(void** ptrs, const int* iargs, const float* fargs,
                           uint32_t k0, uint32_t k1, void* stream) {
  ClassifyArgs a;
  a.cr = static_cast<float*>(ptrs[0]);
  a.ci = static_cast<float*>(ptrs[1]);
  a.zr = static_cast<float*>(ptrs[2]);
  a.zi = static_cast<float*>(ptrs[3]);
  a.sr = static_cast<float*>(ptrs[4]);
  a.si = static_cast<float*>(ptrs[5]);
  a.it = static_cast<int32_t*>(ptrs[6]);
  a.sv = static_cast<int32_t*>(ptrs[7]);
  a.dead = static_cast<int32_t*>(ptrs[8]);
  a.vis = static_cast<int32_t*>(ptrs[9]);
  a.emit_c = static_cast<float*>(ptrs[10]);
  a.emit_it = static_cast<int32_t*>(ptrs[11]);
  a.stats = static_cast<int32_t*>(ptrs[12]);
  a.bits = static_cast<const uint32_t*>(ptrs[13]);
  a.k0 = k0;
  a.k1 = k1;
  const int fractal = iargs[0], thin = iargs[1], visit = iargs[2];
  a.lanes = iargs[3];
  a.chunks = iargs[4];
  a.windows = iargs[5];
  a.unroll = iargs[6];
  a.min_it = iargs[7];
  a.max_it = iargs[8];
  a.detect = iargs[9];
  a.dom_r0 = fargs[0];
  a.dom_rspan = fargs[1];
  a.dom_i0 = fargs[2];
  a.dom_ispan = fargs[3];
  a.vx0 = fargs[4];
  a.vx1 = fargs[5];
  a.vy0 = fargs[6];
  a.vy1 = fargs[7];
  LaunchFn fn = nullptr;
  switch (fractal) {
    case cb::kBuddhabrot: fn = pick<cb::kBuddhabrot>(thin, visit); break;
    case cb::kBurningShip: fn = pick<cb::kBurningShip>(thin, visit); break;
    case cb::kAntiBuddhabrot: fn = pick<cb::kAntiBuddhabrot>(thin, visit); break;
  }
  if (fn == nullptr || a.lanes <= 0) return int(cudaErrorInvalidValue);
  return int(fn(a, static_cast<cudaStream_t>(stream)));
}
