// Extended-precision (df32) persistent-lane classify pass for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cudabrot_tpu/ops/pallas_kernels_ext.py
// _make_kernel_ext (called by classify_pass_ext). Same function as the f32
// classify pass (classify.cu) with the orbit carried as double-float
// (hi, lo) f32 pairs (df32.cuh, ~2^-48 relative): samples are drawn on the
// 2^24-point grid of the sample window, c = centre (+) (k - 2^23) * step in
// df32; escape tracking is always the survival counter; Brent compares hi
// parts only; the cull runs on the f32 approximation of c; the emission
// payload is the 24-bit grid indices (kr, ki), which round-trip exactly to
// the replay. The window centre and the pitches are kernel arguments.
//
// Layout. As in classify.cu, each thread carries S = kLanesPerThread
// lanes: thread t of global warp g holds lanes (g * S + j) * 32 + t, so
// every load and store of a warp is 32 consecutive lanes of a
// lane-contiguous array. A lane's 16 state words, its pending emission and
// its 5 counters live in registers across the pass, loaded and stored
// once; the chunk grid is a loop inside the thread, flushing the emission
// slots after each chunk. With S = 2 a thread carries two independent df32
// chains, whose dependent operations the compiler interleaves; the
// package's build carries one (below).
//
// The window. U df32 updates, unrolled for U in {1, 2, 4, 8, 16, 32} (a
// run-time loop otherwise), then the part of the boundary every lane
// takes (classify_ext.cuh ext_window): the finish test, the counter and
// the Brent save, as selects. A lane that did not finish adds nothing to
// any stat. The rest of the boundary (the band filter, the pending
// emission, the stats and the refill, ext_finish) only a finished lane
// needs: the warp votes, and a warp with no finished lane skips it. At the
// deep zoom a lane lives ~460 steps, so at U = 1 93% of warp-windows skip
// it. A finished lane draws its own refill (Threefry of (lane, window)):
// Threefry is 2.7% of the kernel there, too little to compact.
//
// Bound. Operations: the df32 step (FFMA two-products, df32.cuh) and the
// skipped boundary per lane-step, the whole boundary and the draw per
// refill, against the card's f32 rate; memory traffic is a few bytes per
// lane per chunk. The df32 step is a long dependent chain, so latency
// limits a thread: the resident warps hide it.
//
// Arithmetic rounds once per operation, so this kernel equals
// ops/classify_ext.classify_pass_ext_plain bitwise.
#include <cuda_runtime.h>

#include "classify_ext.cuh"

namespace {

constexpr int kBlock = 128;  // 4 warps

// Lanes per thread. 1 (40 registers, no spills) was faster than 2 (72) at
// the zoom cell on an NVIDIA H100 80GB HBM3, 700.00 W (least of 2 rounds
// of 5 passes, PERF.md section 6): 3.83 against 4.01 ms a pass at U = 1,
// and than 2 held to 64 registers (8 blocks an SM, spilling; 3.84) or to
// 4 blocks an SM (3.88); at U = 2, 3.38-3.42 against 3.42-3.57
// (measured in PR 9): the resident warps hide the df32 chain's latency
// better than a second chain in the thread.
constexpr int kLanesPerThread = 1;

template <int FR, bool VISIT, int S, int U>
__global__ void __launch_bounds__(kBlock)
    classify_ext_kernel(cb::ClassifyExtArgs a) {
  const int t = threadIdx.x & 31;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  if (warp * S * 32 >= a.lanes) return;  // warp-uniform
  const int u = U > 0 ? U : a.unroll;

  int lane[S];
  bool live[S];
  cb::ExtLane L[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lane[j] = (warp * S + j) * 32 + t;
    live[j] = lane[j] < a.lanes;
    L[j] = cb::load_ext_lane(a, live[j] ? lane[j] : 0);
  }

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      bool fin[S];
      bool any = false;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        fin[j] = cb::ext_window<FR, VISIT, U>(a, L[j]) && live[j];
        any = any || fin[j];
      }
      // Every lane of the warp reaches the vote; lanes past a.lanes take
      // part with fin false.
      if (!__any_sync(0xffffffffu, any)) continue;
      const int gwin = chunk * a.windows + w;
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (fin[j]) cb::ext_finish<FR, VISIT>(a, L[j], lane[j], gwin, u);
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (live[j]) cb::flush_ext_lane(a, L[j], chunk, lane[j]);
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (live[j]) cb::store_ext_lane(a, L[j], lane[j]);
}

template <int FR, bool VISIT, int U>
cudaError_t launch(const cb::ClassifyExtArgs& a, cudaStream_t stream) {
  constexpr int S = kLanesPerThread;
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int grid = (warps + kBlock / 32 - 1) / (kBlock / 32);
  classify_ext_kernel<FR, VISIT, S, U><<<grid, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const cb::ClassifyExtArgs&, cudaStream_t);

// The instantiation for a window of `unroll` updates: unrolled for the
// powers of two up to 32, a run-time loop (U = 0) otherwise.
template <int FR, bool VISIT>
LaunchFn pick_unroll(int unroll) {
  switch (unroll) {
    case 1: return launch<FR, VISIT, 1>;
    case 2: return launch<FR, VISIT, 2>;
    case 4: return launch<FR, VISIT, 4>;
    case 8: return launch<FR, VISIT, 8>;
    case 16: return launch<FR, VISIT, 16>;
    case 32: return launch<FR, VISIT, 32>;
  }
  return launch<FR, VISIT, 0>;
}

template <int FR>
LaunchFn pick(int visit, int unroll) {
  return visit ? pick_unroll<FR, true>(unroll)
               : pick_unroll<FR, false>(unroll);
}

}  // namespace

// Arguments as classify_ext.cuh classify_ext_args documents them. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int cb_classify_ext(void** ptrs, const int* iargs,
                               const float* fargs, uint32_t k0, uint32_t k1,
                               void* stream) {
  const cb::ClassifyExtArgs a =
      cb::classify_ext_args(ptrs, iargs, fargs, k0, k1);
  const int visit = iargs[1];
  LaunchFn fn = nullptr;
  switch (iargs[0]) {
    case cb::kBuddhabrot: fn = pick<cb::kBuddhabrot>(visit, a.unroll); break;
    case cb::kBurningShip:
      fn = pick<cb::kBurningShip>(visit, a.unroll);
      break;
    case cb::kAntiBuddhabrot:
      fn = pick<cb::kAntiBuddhabrot>(visit, a.unroll);
      break;
  }
  if (fn == nullptr || a.lanes <= 0 || a.unroll <= 0)
    return int(cudaErrorInvalidValue);
  return int(fn(a, static_cast<cudaStream_t>(stream)));
}
