// Histogram deposit kernels for Hopper (sm_90a).
//
// Replace the TPU deposit kernel cudabrot_tpu/ops/binning.py
// _pallas_scatter_kernel (called by _pallas_scatter_call, entry
// scatter_pallas) and, fused with it, the XLA replay loop that feeds it
// (engines/pallas_engine.py _batched_replay / _blocked_replay).
//
//  * cb_deposit_ids: the exact function of scatter_pallas — count a flat
//    int32 id stream into a uint32 histogram; ids outside [0, nbins) (the
//    sentinel nbins) are dropped. One global atomicAdd per id.
//  * cb_replay_deposit: what the render's main path runs. Each compacted
//    emission (c, iters) is replayed: z starts at c, steps s = 0..iters are
//    recorded including the escape point, each on-canvas point binned
//    (points_to_bin_ids, strict rounding) and added with atomicAdd straight
//    into the global histogram. The TPU path materializes up to 2^27 ids
//    per pass (~512 MB) and streams them through its scatter; here no id
//    ever reaches device memory, and one kernel serves every band. The
//    batch arrives sorted by descending orbit length, and the card's warps
//    work through it as a queue (deposit_ext.cu's, longest first): each
//    resident warp takes the next group of 32 emissions from a global
//    counter, runs its lanes in step for the group's longest orbit with
//    only each lane's own steps recorded (orbit.cuh replay_orbit,
//    branch-free binning), and takes another. The wrapper puts
//    binning.REPLAY_WARPS_PER_SM resident warps on each SM, the count that
//    served the deep (a few thousand orbits, the longest ~20,000 steps),
//    northstar and default (~3e6 orbits of ~40 points, bound by the
//    atomics' throughput) batches alike, and at the default batch each take
//    is several groups, so the counter's atomics do not serialize the
//    warps.
//
//  * cb_replay_ids: the replay (orbit.cuh replay_orbit, one thread per
//    emission in blocks of 256) writing ids instead of adding them, for
//    the bigtiles route: emission i writes
//    the bin id of each of its iters + 1 steps, or the sentinel nbins off
//    the canvas, at off[i] + s of a flat int32 stream (off: the exclusive
//    prefix sum of the orbit lengths, int64). Every slot is written
//    exactly once, so no atomics, and the ids are the fused kernel's bins
//    exactly. It replaces the XLA scan of pallas_engine.py
//    _blocked_replay that materializes the TPU scatter's ids. Bound: ~15
//    operations per point plus 4 bytes written per id; each thread writes
//    its orbit's ids to consecutive addresses.
//
//  * cb_mh_deposit: the Metropolis-Hastings deposit, the function of
//    ops/binning.py mh_scatter (an XLA scatter-add of a materialized
//    (V, capacity) weight array in the JAX engine). One thread per
//    emission: it computes the tenure's total q and its Bresenham spread
//    over the recorded bins (mh.cuh mh_deposit_one, pure u32 arithmetic)
//    and adds each share with atomicAdd; the recorded-bin count and the
//    mass q are summed into two 64-bit device totals, so the engine's
//    counters need no second pass and no (V, capacity) temporary exists.
//    It reads the emission buffers in the classify kernel's own layout
//    (chunks, V, lanes), so the engine deposits without compacting.
//
// Bound. The deposit is a random read-modify-write per orbit point: the
// floor is the atomic throughput of the L2 (a 1000^2 uint32 histogram is
// 4 MB and stays in the 50 MB L2), not the bytes the function must move
// (its inputs are read once). The replay's f32 work is ~15 operations per
// point, in a dependent chain per orbit: a lone long orbit's chain is the
// floor at deep bands. Integer adds commute, so the histogram equals the
// plain PyTorch versions (ops/binning.py) bitwise whatever the order of the
// atomics and whatever mapping of emissions to warps.
#include <cuda_runtime.h>

#include "mh.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    deposit_ids_kernel(const int32_t* ids, long long n, uint32_t* hist,
                       int32_t nbins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t b = ids[i];
    if (b >= 0 && b < nbins) atomicAdd(hist + b, 1u);
  }
}

constexpr int kQueueBlock = 128;  // 4 warps: one per SM sub-partition

// The queue: each warp takes the next `take` groups of 32 emissions until
// none is left. The group index is broadcast from lane 0, so the loop's
// exit is warp-uniform and every lane reaches the warp sum. The lanes
// replay their orbits in step, for the group's longest orbit; a lane past
// the batch's end runs the group's first emission and records nothing
// (n = -1). Taking several groups at once spares the counter (one address,
// so its atomics serialize) at batches of many short orbits.
template <int FR>
__global__ void __launch_bounds__(kQueueBlock)
    replay_deposit_kernel(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          cb::CanvasQ q, int take,
                          unsigned long long* next,
                          unsigned long long* hits) {
  const int lane = threadIdx.x & 31;
  const int groups = (k + 31) / 32;
  uint32_t local = 0;
  for (;;) {
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd(next, (unsigned long long)take);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= (unsigned long long)groups) break;
    const int end = int(first) + take < groups ? int(first) + take : groups;
    for (int g = int(first); g < end; ++g) {
      const int i = g * 32 + lane;
      const int e = i < k ? i : g * 32;
      const int n = i < k ? iters[i] : -1;
      const int steps = __reduce_max_sync(0xffffffffu, n) + 1;
      if (steps > 0)
        local += cb::replay_orbit<FR>(cr[e], ci[e], n, steps, q,
                                      cb::DepositSink{hist});
    }
  }
  cb::warp_sum_add(hits, local);
}

template <int FR>
__global__ void __launch_bounds__(kBlock)
    replay_ids_kernel(const float* cr, const float* ci, const int32_t* iters,
                      const long long* off, int k, int32_t* ids,
                      cb::CanvasQ q, unsigned long long* hits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t local = 0;
  const int n = i < k ? iters[i] : -1;
  if (n >= 0)
    local = cb::replay_orbit<FR>(cr[i], ci[i], n, n + 1, q,
                                 cb::IdSink{ids + off[i], q.width * q.height});
  cb::warp_sum_add(hits, local);
}

__global__ void __launch_bounds__(kBlock)
    mh_deposit_kernel(cb::mh::MhDepositArgs a, unsigned long long* totals) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t n = 0, q = 0;
  if (e < a.n) cb::mh::mh_deposit_one(a, e, n, q);
  cb::warp_sum_add(totals, n);
  cb::warp_sum_add(totals + 1, q);
}

template <int FR>
cudaError_t launch_replay(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          const cb::CanvasQ& q, int warps, int take,
                          unsigned long long* next, unsigned long long* hits,
                          cudaStream_t stream) {
  // `warps` resident warps in all, no more than the batch has takes.
  const int takes = ((k + 31) / 32 + take - 1) / take;
  const int w = warps < takes ? warps : takes;
  const int grid = (w + kQueueBlock / 32 - 1) / (kQueueBlock / 32);
  replay_deposit_kernel<FR><<<grid, kQueueBlock, 0, stream>>>(
      cr, ci, iters, k, hist, q, take, next, hits);
  return cudaGetLastError();
}

template <int FR>
cudaError_t launch_ids(const float* cr, const float* ci, const int32_t* iters,
                       const long long* off, int k, int32_t* ids,
                       const cb::CanvasQ& q, unsigned long long* hits,
                       cudaStream_t stream) {
  const int grid = (k + kBlock - 1) / kBlock;
  replay_ids_kernel<FR><<<grid, kBlock, 0, stream>>>(cr, ci, iters, off, k,
                                                      ids, q, hits);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_deposit_ids(const void* ids, long long n, void* hist,
                              int nbins, void* stream) {
  if (n <= 0) return 0;
  long long grid = (n + kBlock - 1) / kBlock;
  if (grid > 132 * 64) grid = 132 * 64;  // grid-stride beyond this
  deposit_ids_kernel<<<int(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, static_cast<uint32_t*>(hist),
      nbins);
  return int(cudaGetLastError());
}

// warps: the resident warps to launch (the SMs times the warps per SM);
// take: the groups of 32 a warp takes from the queue at once; next: one
// zeroed uint64, the queue's counter; hits: one uint64 the kernel adds the
// on-canvas point count to. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int cb_replay_deposit(int fractal, const void* cr, const void* ci,
                                 const void* iters, int k, void* hist,
                                 float min_re, float min_im, float d_re,
                                 float d_im, int width, int height,
                                 int warps, int take, void* next, void* hits,
                                 void* stream) {
  if (k <= 0) return 0;
  if (warps <= 0 || take <= 0) return int(cudaErrorInvalidValue);
  const cb::CanvasQ q{min_re, min_im, d_re, d_im, width, height};
  const auto* pcr = static_cast<const float*>(cr);
  const auto* pci = static_cast<const float*>(ci);
  const auto* pit = static_cast<const int32_t*>(iters);
  auto* ph = static_cast<uint32_t*>(hist);
  auto* pn = static_cast<unsigned long long*>(next);
  auto* phits = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fractal) {
    case cb::kBuddhabrot:
      return int(launch_replay<cb::kBuddhabrot>(pcr, pci, pit, k, ph, q,
                                                 warps, take, pn, phits, s));
    case cb::kBurningShip:
      return int(launch_replay<cb::kBurningShip>(pcr, pci, pit, k, ph, q,
                                                  warps, take, pn, phits, s));
    case cb::kAntiBuddhabrot:
      return int(launch_replay<cb::kAntiBuddhabrot>(
          pcr, pci, pit, k, ph, q, warps, take, pn, phits, s));
  }
  return int(cudaErrorInvalidValue);
}

// The id-stream replay of the bigtiles route: arguments as
// cb_replay_deposit, with off (k,) int64 the first slot of each emission in
// ids, the int32 stream of off[k-1] + iters[k-1] + 1 slots, in place of the
// histogram. Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_replay_ids(int fractal, const void* cr, const void* ci,
                             const void* iters, const void* off, int k,
                             void* ids, float min_re, float min_im,
                             float d_re, float d_im, int width, int height,
                             void* hits, void* stream) {
  if (k <= 0) return 0;
  const cb::CanvasQ q{min_re, min_im, d_re, d_im, width, height};
  const auto* pcr = static_cast<const float*>(cr);
  const auto* pci = static_cast<const float*>(ci);
  const auto* pit = static_cast<const int32_t*>(iters);
  const auto* po = static_cast<const long long*>(off);
  auto* pids = static_cast<int32_t*>(ids);
  auto* phits = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fractal) {
    case cb::kBuddhabrot:
      return int(launch_ids<cb::kBuddhabrot>(pcr, pci, pit, po, k, pids, q,
                                             phits, s));
    case cb::kBurningShip:
      return int(launch_ids<cb::kBurningShip>(pcr, pci, pit, po, k, pids, q,
                                              phits, s));
    case cb::kAntiBuddhabrot:
      return int(launch_ids<cb::kAntiBuddhabrot>(pcr, pci, pit, po, k, pids,
                                                 q, phits, s));
  }
  return int(cudaErrorInvalidValue);
}

// bins: (chunks, slots, lanes) int32; t, rep: (chunks * lanes,) int32 with
// n = chunks * lanes emissions. totals: two uint64 the kernel adds the
// recorded-bin count and the deposited mass to. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int cb_mh_deposit(const void* bins, const void* t, const void* rep,
                             long long n, int slots, int lanes, void* hist,
                             int nbins, void* totals, void* stream) {
  if (n <= 0) return 0;
  if (slots <= 0 || lanes <= 0 || n % lanes != 0)
    return int(cudaErrorInvalidValue);
  const cb::mh::MhDepositArgs a{
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(t),
      static_cast<const int32_t*>(rep),  n, slots, lanes,
      static_cast<uint32_t*>(hist),      nbins};
  const long long grid = (n + kBlock - 1) / kBlock;
  mh_deposit_kernel<<<unsigned(grid), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned long long*>(totals));
  return int(cudaGetLastError());
}
