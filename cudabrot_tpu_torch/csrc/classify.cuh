// One lane of the f32 classify pass as __host__ __device__ functions: the
// window (U orbit steps and the boundary), the refill draw, the refill, and
// the slot a finished lane's draw takes in its warp's compacted refill; and
// the pass's slices, the runs of windows a warp takes from the queue, with
// the lane's load and store at a slice's ends. classify.cu runs them with S
// lanes per thread; host_harness.cpp runs them in a host emulation of the
// same warps, so a CPU build can be held bitwise against the plain PyTorch
// version (ops/classify.classify_pass_plain).
#pragma once

#include "orbit.cuh"

namespace cb {

constexpr float kBig = 1.0e30f;  // Brent "never matches" saved point
constexpr int kSave0 = 16;       // first Brent save index, doubling
constexpr int kStats = 5;        // drawn, culled, in_band, cycles, wasted

// The queue's words (ClassifyArgs::queue, uint32): the ticket counter, the
// warps that found the queue empty, and the base of this launch's progress
// values, then from word kQueueHead one progress word a (lane group,
// thread). The last warp to find the queue empty resets the first two and
// moves the base past every progress value the launch wrote, so the words
// need no clearing between launches: zero-filled once, they serve every
// launch on one stream.
constexpr int kTicket = 0, kExited = 1, kBase = 2, kQueueHead = 32;

struct ClassifyArgs {
  float *cr, *ci, *zr, *zi, *sr, *si;
  int32_t *it, *sv, *dead, *vis;
  float* emit_c;          // (chunks, 2, lanes)
  int32_t* emit_it;       // (chunks, lanes), -1 = empty slot
  int32_t* stats;         // (5, lanes)
  const uint32_t* bits;   // (chunks, windows, 2, lanes) or null: threefry
  uint32_t* queue;        // kQueueHead + 32 x lane groups words
  unsigned long long* late;  // 2 words or null: late warps, their items
  uint32_t k0, k1;
  int lanes, chunks, windows, unroll, min_it, max_it, detect;
  float dom_r0, dom_rspan, dom_i0, dom_ispan;
  float vx0, vx1, vy0, vy1;
};

// The C interface's arguments (classify.cu, host_harness.cpp).
// ptrs: cr, ci, zr, zi, sr, si, it, sv, dead, vis, emit_c, emit_it, stats,
//       bits (null for threefry), queue, late (null: not counted).
// iargs: fractal, thin, visit, lanes, chunks, windows, unroll, min_it,
//        max_it, detect (fractal, thin, visit and the unroll select the
//        instantiation).
// fargs: dom_r0, dom_rspan, dom_i0, dom_ispan, vx0, vx1, vy0, vy1.
inline ClassifyArgs classify_args(void** ptrs, const int* iargs,
                                  const float* fargs, uint32_t k0,
                                  uint32_t k1) {
  ClassifyArgs a;
  float** f[6] = {&a.cr, &a.ci, &a.zr, &a.zi, &a.sr, &a.si};
  for (int i = 0; i < 6; ++i) *f[i] = static_cast<float*>(ptrs[i]);
  a.it = static_cast<int32_t*>(ptrs[6]);
  a.sv = static_cast<int32_t*>(ptrs[7]);
  a.dead = static_cast<int32_t*>(ptrs[8]);
  a.vis = static_cast<int32_t*>(ptrs[9]);
  a.emit_c = static_cast<float*>(ptrs[10]);
  a.emit_it = static_cast<int32_t*>(ptrs[11]);
  a.stats = static_cast<int32_t*>(ptrs[12]);
  a.bits = static_cast<const uint32_t*>(ptrs[13]);
  a.queue = static_cast<uint32_t*>(ptrs[14]);
  a.late = static_cast<unsigned long long*>(ptrs[15]);
  a.k0 = k0;
  a.k1 = k1;
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
  return a;
}

// A lane's registers: its sampler state, its pending emission slot and its
// pass counters.
struct Lane {
  float cr, ci, zr, zi, sr, si;
  int it, sv, dead, vis;
  float p_cr, p_ci;
  int p_it;
  int n_drawn, n_cull, n_band, n_cyc, n_waste;
};

// The pass's windows (chunks x windows of it, chunk-major) cut into slices
// of `len` whole windows, `count` of them; a slice is the unit of work a
// warp takes from the queue for one lane group. The cut is a constant of
// the design, read from the plan. A slice's ends move its lanes through
// memory (~72 bytes a lane each way), so a slice holds at least
// kSliceWindows windows; the queue's tail is about one slice, so a pass is
// cut into up to kMaxSlices (on an H100 at 262,144 lanes: 0.13 ms a slice
// at canvas1k.default's plan, 0.3 ms at hires15k.fine's). A pass of fewer
// than kCutWindows windows is one slice: at the 512 of hires15k.medium's
// plan, 4 or 8 slices slowed the replay beside the pass by half and the
// pass with it, and one did not.
constexpr int kSliceWindows = 64, kMaxSlices = 64, kCutWindows = 2048;

struct Slices {
  int len, count;
};

CB_HD Slices slice_plan(int chunks, int windows) {
  const int total = chunks * windows;
  if (total < kCutWindows) return {total, 1};
  const int fewest = (total + kMaxSlices - 1) / kMaxSlices;
  const int len = fewest > kSliceWindows ? fewest : kSliceWindows;
  return {len, (total + len - 1) / len};
}

// A load that reads what another warp of the launch stored, from the L2
// (where that warp's stores and its release went), not from a stale L1 line.
template <class T>
CB_HD T ld_cg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// A lane at the start of the slice that begins at window w0 of the pass:
// its sampler state from the arrays, and its counters and pending emission
// as the slice before left them. At the pass's start the counters are zero
// and no emission is pending. Inside a chunk, the pending emission is the
// one the slice before wrote into the chunk's slot; at a chunk's start it
// is the slot of the chunk before, cleared as flush_lane clears it.
CB_HD Lane load_lane(const ClassifyArgs& a, int lane, int w0) {
  Lane l;
  l.cr = ld_cg(a.cr + lane);
  l.ci = ld_cg(a.ci + lane);
  l.zr = ld_cg(a.zr + lane);
  l.zi = ld_cg(a.zi + lane);
  l.sr = ld_cg(a.sr + lane);
  l.si = ld_cg(a.si + lane);
  l.it = ld_cg(a.it + lane);
  l.sv = ld_cg(a.sv + lane);
  l.dead = ld_cg(a.dead + lane);
  l.vis = ld_cg(a.vis + lane);
  if (w0 == 0) {
    l.p_cr = 0.0f;
    l.p_ci = 0.0f;
    l.p_it = -1;
    l.n_drawn = l.n_cull = l.n_band = l.n_cyc = l.n_waste = 0;
    return l;
  }
  const size_t L = size_t(a.lanes);
  int* const counts[kStats] = {&l.n_drawn, &l.n_cull, &l.n_band, &l.n_cyc,
                               &l.n_waste};
  for (int s = 0; s < kStats; ++s)
    *counts[s] = ld_cg(a.stats + size_t(s) * L + lane);
  const int chunk = w0 / a.windows;
  if (w0 % a.windows != 0) {
    l.p_cr = ld_cg(a.emit_c + (size_t(chunk) * 2) * L + lane);
    l.p_ci = ld_cg(a.emit_c + (size_t(chunk) * 2 + 1) * L + lane);
    l.p_it = ld_cg(a.emit_it + size_t(chunk) * L + lane);
  } else {
    l.p_cr = fmul(ld_cg(a.emit_c + (size_t(chunk - 1) * 2) * L + lane), 0.0f);
    l.p_ci =
        fmul(ld_cg(a.emit_c + (size_t(chunk - 1) * 2 + 1) * L + lane), 0.0f);
    l.p_it = -1;
  }
  return l;
}

// Writes the chunk's pending emission slot and clears it: at the chunk's
// end its flush, at a slice's end inside the chunk the hand-over to the
// next slice.
CB_HD void flush_lane(const ClassifyArgs& a, Lane& l, int chunk, int lane) {
  const size_t L = size_t(a.lanes);
  a.emit_c[(size_t(chunk) * 2) * L + lane] = l.p_cr;
  a.emit_c[(size_t(chunk) * 2 + 1) * L + lane] = l.p_ci;
  a.emit_it[size_t(chunk) * L + lane] = l.p_it;
  l.p_cr = fmul(l.p_cr, 0.0f);
  l.p_ci = fmul(l.p_ci, 0.0f);
  l.p_it = -1;
}

// Stores the lane's state and its counters so far at a slice's end.
CB_HD void store_lane(const ClassifyArgs& a, const Lane& l, int lane) {
  const size_t L = size_t(a.lanes);
  a.cr[lane] = l.cr;
  a.ci[lane] = l.ci;
  a.zr[lane] = l.zr;
  a.zi[lane] = l.zi;
  a.sr[lane] = l.sr;
  a.si[lane] = l.si;
  a.it[lane] = l.it;
  a.sv[lane] = l.sv;
  a.dead[lane] = l.dead;
  a.vis[lane] = l.vis;
  const int counts[kStats] = {l.n_drawn, l.n_cull, l.n_band, l.n_cyc,
                              l.n_waste};
  for (int s = 0; s < kStats; ++s) a.stats[size_t(s) * L + lane] = counts[s];
}

// One window of a lane: U orbit updates (U = a.unroll when the template's
// U is 0), then the boundary — termination, band filter into the pending
// slot, stats, Brent save — as selects, with no branch. Returns whether
// the lane finished; a finished lane then takes a refill, which overwrites
// every field the window moved on (z, it, the Brent point, dead, vis).
template <int FR, bool THIN, bool VISIT, int U>
CB_HD bool lane_window(const ClassifyArgs& a, Lane& l) {
  using T = Traits<FR>;
  const int u = U > 0 ? U : a.unroll;
  float azr = l.zr, azi = l.zi;
  bool esc, cyc;
  int needed;
  if (THIN) {
    // Survival counter: escape is a point of no return, so the 0-based
    // escape index is it + (steps that stayed inside).
    int nesc = 0;
    float r2 = fmul(azr, azr), i2 = fmul(azi, azi);
    bool hit = false;
#pragma unroll
    for (int k = 0; k < u; ++k) {
      const float nzr = fadd(fsub(r2, i2), l.cr);
      const float nzi = T::fold_abs
                            ? fadd(fmul(2.0f, fabs_(fmul(azr, azi))), l.ci)
                            : fadd(fmul(fmul(2.0f, azr), azi), l.ci);
      azr = nzr;
      azi = nzi;
      r2 = fmul(azr, azr);
      i2 = fmul(azi, azi);
      nesc += fadd(r2, i2) <= 4.0f;
      if (VISIT)
        hit |= (azr >= a.vx0) & (azr < a.vx1) & (azi >= a.vy0) &
               (azi < a.vy1);
    }
    if (VISIT) l.vis |= int(hit);
    esc = nesc < u;
    needed = l.it + nesc;
    cyc = a.detect && azr == l.sr && azi == l.si && !esc;
  } else {
    esc = false;
    cyc = false;
    needed = 0;
#pragma unroll
    for (int k = 0; k < u; ++k) {
      step<FR>(azr, azi, l.cr, l.ci);
      const bool newly =
          fadd(fmul(azr, azr), fmul(azi, azi)) > 4.0f && !esc && !cyc;
      needed = newly ? l.it + k : needed;
      esc = esc || newly;
      if (a.detect) cyc = cyc || (azr == l.sr && azi == l.si && !esc);
    }
  }

  const int it_new = l.it + u;
  const bool deadb = l.dead != 0;
  const bool fin = esc || cyc || it_new >= a.max_it || deadb;
  bool in_band;
  int band_it;
  if (T::interior) {
    const bool esc_in_cap = esc && needed < a.max_it;
    in_band = (cyc || it_new >= a.max_it) && !esc_in_cap && !deadb;
    band_it = a.max_it - 1;
  } else {
    in_band = esc && !deadb && needed >= a.min_it && needed < a.max_it;
    band_it = needed;
  }
  if (VISIT) in_band = in_band && l.vis != 0;
  l.p_it = in_band ? band_it : l.p_it;
  l.p_cr = in_band ? l.cr : l.p_cr;
  l.p_ci = in_band ? l.ci : l.p_ci;
  l.n_band += in_band;
  l.n_cyc += cyc && !deadb;
  l.n_waste += deadb ? u : (esc ? it_new - needed - 1 : 0);
  const bool save = a.detect && it_new >= l.sv;
  l.sr = save ? azr : l.sr;
  l.si = save ? azi : l.si;
  l.sv = save ? l.sv * 2 : l.sv;
  l.zr = azr;
  l.zi = azi;
  l.it = it_new;
  return fin;
}

// A refill's new sample: c from the Threefry words of (lane, gwin) (or
// from the bits tensor), and whether the cardioid/bulb cull kills it.
struct Draw {
  float cr, ci;
  int cull;
};

template <int FR>
CB_HD Draw draw_sample(const ClassifyArgs& a, int lane, int gwin) {
  uint32_t rb_r, rb_i;
  if (a.bits != nullptr) {
    const size_t base = size_t(gwin) * 2 * size_t(a.lanes) + lane;
    rb_r = a.bits[base];
    rb_i = a.bits[base + size_t(a.lanes)];
  } else {
    rb_r = uint32_t(lane);
    rb_i = uint32_t(gwin);
    threefry2x32(a.k0, a.k1, rb_r, rb_i);
  }
  Draw d;
  d.cr = u32_to_domain(rb_r, a.dom_r0, a.dom_rspan);
  d.ci = u32_to_domain(rb_i, a.dom_i0, a.dom_ispan);
  d.cull = Traits<FR>::use_cull && culled(d.cr, d.ci);
  return d;
}

template <bool VISIT>
CB_HD void refill(Lane& l, const Draw& d) {
  l.cr = d.cr;
  l.ci = d.ci;
  l.zr = d.cr;  // z starts at c (cudabrot.cu:323-324)
  l.zi = d.ci;
  l.it = 0;
  l.sr = kBig;
  l.si = kBig;
  l.sv = kSave0;
  l.dead = d.cull;
  if (VISIT) l.vis = 0;
  l.n_drawn += 1;
  l.n_cull += d.cull;
}

CB_HD int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The refill slot of thread t's sub-lane j in its warp, where bit t of
// masks[q] says that thread t's sub-lane q finished: slots run through
// sub-lane 0's finished threads in thread order, then sub-lane 1's, and so
// on, so the warp's F finished (thread, sub-lane) pairs take 0..F-1.
template <int S>
CB_HD int refill_slot(const uint32_t (&masks)[S], int t, int j) {
  int s = popc32(masks[j] & ((1u << t) - 1u));
  for (int q = 0; q < j; ++q) s += popc32(masks[q]);
  return s;
}

}  // namespace cb
