// Histogram deposit kernels for Hopper (sm_90a).
//
// Replace the TPU deposit kernel cudabrot_tpu/ops/binning.py
// _pallas_scatter_kernel (called by _pallas_scatter_call, entry
// scatter_pallas) and, fused with it, the XLA replay loop that feeds it
// (engines/pallas_engine.py _batched_replay / _blocked_replay).
//
//  * cb_deposit_ids: the exact function of scatter_pallas — count a flat
//    int32 id stream into a uint32 histogram; ids outside [0, nbins) (the
//    sentinel nbins) are dropped. The --scatter pallas route runs it on the
//    replay_ids(_ext) stream of each group of kept orbits. Each thread
//    reads 16 bytes (four ids) a load, evict-first (the stream is read
//    once and must not push the histogram out of the L2), and adds each
//    in-range id with one global atomicAdd (a RED). Bound: on an NVIDIA
//    H100 80GB HBM3 at 700 W, random REDs at full occupancy reach 8.76e7
//    a ms into a 4 MB buffer and 1.83e7 into 108 MB (chip_smoke.py phase
//    3c), and the kernel reaches 0.94-0.98 of that ceiling on random ids,
//    0.84-0.85 on the default and deep cells' streams and 2.1 of it on
//    bigcanvas's (its bins cluster in the L2); far below the byte bound (4
//    bytes an id, 8 a bin). Where the stream is nearly all sentinels (the
//    deep zoom: 99.3%) the loads bound it, and there the 16-byte loads
//    took it from 0.243 to 0.157 ms against a byte bound of 0.147. Tried
//    and dropped (measured in PR 13): summing a warp's equal ids before
//    one RED (__match_any_sync over 32 consecutive ids:
//    they repeat at most 1.5% of the time, at deep) and privatizing a band
//    of the histogram in a thread-block cluster's distributed shared
//    memory (16 blocks of 128 KB, the stream read once a band: 2.6x
//    slower at 1000^2, not applicable beyond a few bands).
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
//    warps. With one warp per group in place of the queue (its ~190
//    groups placed by the block scheduler) the northstar batch took 9-10%
//    longer in both kernels; the deep and default batches were level, and
//    replay_ids' bigcanvas batch 4-5% faster (measured in PR 7).
//
//  * Both replays bin into a row window of the canvas (orbit.cuh CanvasQ):
//    the whole canvas, or the rows of one shard of a row-sharded histogram
//    (parallel/sharded_hist.py), whose ids are local to the shard.
//
//  * cb_replay_ids: the same queue writing ids instead of adding them, for
//    the bigtiles route: emission i writes the bin id of each of its
//    iters + 1 steps, or the sentinel nbins off the canvas, at off[i] + s of
//    a flat int32 stream (off: the exclusive prefix sum of the orbit
//    lengths, int64). Every slot is written exactly once, so no atomics, and
//    the ids are the fused kernel's bins exactly. It replaces the XLA scan
//    of pallas_engine.py _blocked_replay that materializes the TPU
//    scatter's ids. Bound: the 4 bytes written per id (~15 operations per
//    point beside them). A store per point would send a warp's 32 lanes
//    (32 orbits, one step each) to 32 sectors 4 bytes apiece; so each warp
//    stages its lanes' ids for 32 steps in a tile of shared memory and
//    stores the tile row by row, 32 consecutive ids of one orbit per store
//    (orbit.cuh TileSink, store_tile_word). The queue puts the long orbits
//    of a deep band on every SM, where a thread per orbit in blocks of 256
//    left the northstar batch's ~190 groups on 24 of them.
//
//  * cb_mh_deposit: the Metropolis-Hastings deposit, the function of
//    ops/binning.py mh_scatter (an XLA scatter-add of a materialized
//    (V, capacity) weight array in the JAX engine) and its two totals. It
//    reads the emission buffers in the classify kernel's own layout
//    (chunks, V, lanes), gated by emit_it itself (a slot with emit_it < 0
//    deposits nothing), and adds its totals straight into the engine's two
//    int64 counters: the engine's deposit step is this one launch. A grid
//    sized to the SMs walks the slots in groups of 32 lanes of one chunk:
//    each lane reads its slot's gate, t and rep (coalesced) and computes its
//    tenure's n recorded bins and mass q (mh.cuh mh_slot, three u32
//    divisions); a warp scan of n numbers the group's (emission, k) pairs,
//    and the warp deals them out 32 at a time, each lane finding its pair's
//    emission by a binary search over the scan (pair_owner), taking n and q
//    from that emission's lane by shuffles and computing its own share d_k
//    (mh_share), and adds it with one atomic. So the ~67% of depositable
//    slots of a crop (n ~ 1.2) and the ~10% of a deep zoom (n ~ 6.4 of V =
//    8) both fill the lanes, where a thread per slot loops to its own n
//    while its warp waits for the longest. Each block reduces its totals and
//    adds them with one atomic each: the earlier thread-per-slot kernel's
//    warps each added two to the same two words, which took two thirds of
//    its time at the mhcrop cell on an H100 (PERF.md). Summing a round's
//    equal bins before one atomic (__match_any_sync) made the kernel
//    slower there: fewer than 1 in 10,000 of a warp group's pairs share a
//    bin at the mhcrop cell, 1 in 2,700 at mhzoom. Bound: max(bytes /
//    3.35 TB/s, pairs / the histogram atomic rate deposit_ids reaches on a
//    1000^2 histogram, a measured rate rather than a published peak),
//    bytes = slots x 12 (gate, t, rep) + pairs x 4 (a bin).
//
// Bound. The deposit is a random read-modify-write per orbit point: the
// floor is the atomic throughput of the L2 (a 1000^2 uint32 histogram is
// 4 MB and stays in the 50 MB L2), not the bytes the function must move
// (its inputs are read once). The replay's f32 work is ~15 operations per
// point, in a dependent chain per orbit: a lone long orbit's chain is the
// floor at deep bands. Integer adds commute, so the histogram equals the
// plain PyTorch versions (ops/binning.py) bitwise whatever the order of the
// atomics, whatever mapping of emissions (and MH pairs) to warps, and
// however equal bins are summed before their atomic.
#include <cuda_runtime.h>

#include <cstdint>

#include "mh.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ void add_id(uint32_t* hist, int32_t b,
                                       int32_t nbins) {
  if (uint32_t(b) < uint32_t(nbins)) atomicAdd(hist + b, 1u);
}

// A grid-stride loop over the stream's 16-byte words; the 0..3 ids before
// the first 16-byte boundary and the 0..3 after the last whole word are
// added by the first threads.
__global__ void __launch_bounds__(kBlock)
    deposit_ids_kernel(const int32_t* ids, long long n, uint32_t* hist,
                       int32_t nbins) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head =
      (long long)((16u - (reinterpret_cast<uintptr_t>(ids) & 15u)) & 15u) / 4;
  if (head > n) head = n;
  if (tid < head) add_id(hist, ids[tid], nbins);
  const int4* v = reinterpret_cast<const int4*>(ids + head);
  const long long nv = (n - head) / 4;
  for (long long i = tid; i < nv; i += stride) {
    const int4 q = __ldcs(v + i);
    add_id(hist, q.x, nbins);
    add_id(hist, q.y, nbins);
    add_id(hist, q.z, nbins);
    add_id(hist, q.w, nbins);
  }
  const long long t = head + 4 * nv + tid;
  if (t < n) add_id(hist, ids[t], nbins);
}

constexpr int kQueueBlock = 128;  // 4 warps: one per SM sub-partition
constexpr int kQueueWarps = kQueueBlock / 32;

// The queue: each warp takes the next `take` groups of 32 emissions until
// none is left, and runs body(e, n, steps) on each: lane j of group g has
// emission e = 32 g + j, its n (-1 past the batch's end, where e is the
// group's first emission and nothing is recorded) and the group's longest
// orbit's `steps`, which every lane runs. The group index is broadcast from
// lane 0, so the loop's exit is warp-uniform and every lane reaches the
// warp sum. Taking several groups at once spares the counter (one address,
// so its atomics serialize) at batches of many short orbits. Returns the
// lane's on-canvas count.
template <class Body>
__device__ __forceinline__ uint32_t replay_queue(const int32_t* iters, int k,
                                                 int take,
                                                 unsigned long long* next,
                                                 const Body& body) {
  const int lane = threadIdx.x & 31;
  const int groups = (k + 31) / 32;
  uint32_t local = 0;
  auto group = [&](int g) {
    const int i = g * 32 + lane;
    const int e = i < k ? i : g * 32;
    const int n = i < k ? iters[i] : -1;
    const int steps = __reduce_max_sync(0xffffffffu, n) + 1;
    if (steps > 0) local += body(e, n, steps);
  };
  for (;;) {
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd(next, (unsigned long long)take);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= (unsigned long long)groups) break;
    const int end = int(first) + take < groups ? int(first) + take : groups;
    for (int g = int(first); g < end; ++g) group(g);
  }
  return local;
}

template <int FR>
__global__ void __launch_bounds__(kQueueBlock)
    replay_deposit_kernel(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          cb::CanvasQ q, int take,
                          unsigned long long* next,
                          unsigned long long* hits) {
  const cb::DepositSink sink{hist};
  cb::warp_sum_add(hits, replay_queue(iters, k, take, next,
                                      [&](int e, int n, int steps) {
    return cb::replay_orbit<FR>(cr[e], ci[e], n, steps, q, sink);
  }));
}

template <int FR>
__global__ void __launch_bounds__(kQueueBlock)
    replay_ids_kernel(const float* cr, const float* ci, const int32_t* iters,
                      const long long* off, int k, int32_t* ids,
                      cb::CanvasQ q, int take, unsigned long long* next,
                      unsigned long long* hits) {
  const int32_t nbins = q.width * q.row_count;  // the sentinel
  // Per warp: the tile, and each row's orbit (its first slot and length).
  __shared__ int32_t tile[kQueueWarps][cb::kTile * cb::kTileStride];
  __shared__ int32_t* row_out[kQueueWarps][32];
  __shared__ int row_len[kQueueWarps][32];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  int32_t* const t = tile[wb];
  const cb::TileSink sink{t + lane * cb::kTileStride, nbins};
  auto body = [&](int e, int n, int steps) {
    row_out[wb][lane] = ids + off[e];
    row_len[wb][lane] = n + 1;
    cb::ReplayLane l = cb::replay_start<FR>(cr[e], ci[e]);
    uint32_t h = 0;
    for (int t0 = 0; t0 < steps; t0 += cb::kTile) {
      const int t1 = t0 + cb::kTile < steps ? t0 + cb::kTile : steps;
      h += cb::replay_span<FR>(l, n, t0, t1, q, sink);
      __syncwarp();
#pragma unroll 8
      for (int r = 0; r < 32; ++r)
        cb::store_tile_word(t, r, lane, t0, row_len[wb][r], row_out[wb][r]);
      __syncwarp();
    }
    return h;
  };
  cb::warp_sum_add(hits, replay_queue(iters, k, take, next, body));
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMhBlock = 256;
constexpr int kMhWarps = kMhBlock / 32;

// pair_owner's read of lane j's prefix sum: a shuffle (device code only).
struct WarpIncl {
  uint32_t v;
  CB_HD uint32_t operator()(int j) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(kFull, v, j);
#else
    return v;
#endif
  }
};

__global__ void __launch_bounds__(kMhBlock)
    mh_deposit_kernel(cb::mh::MhDepositArgs a, unsigned long long* dep_out,
                      unsigned long long* mass_out) {
  const int lane = threadIdx.x & 31;
  const uint32_t per_chunk = uint32_t(a.lanes + 31) / 32u;
  const uint32_t groups = uint32_t(a.n / a.lanes) * per_chunk;
  const uint32_t nwarps = gridDim.x * kMhWarps;
  unsigned long long dep = 0, mass = 0;
  for (uint32_t g = blockIdx.x * kMhWarps + (threadIdx.x >> 5); g < groups;
       g += nwarps) {
    // 32 lanes of one chunk: slot e = chunk * lanes + l.
    const uint32_t chunk = g / per_chunk;
    const uint32_t l0 = (g - chunk * per_chunk) * 32u, l = l0 + lane;
    uint32_t n = 0, q = 0;
    if (l < uint32_t(a.lanes))
      cb::mh::mh_slot(a, (long long)chunk * a.lanes + l, n, q);
    dep += n;
    mass += q;
    uint32_t incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t total = __shfl_sync(kFull, incl, 31);
    const int32_t* rows =
        a.bins + (long long)chunk * a.slots * a.lanes + l0;
    for (uint32_t p0 = 0; p0 < total; p0 += 32) {
      const uint32_t p = p0 + lane;
      const int j = cb::mh::pair_owner(p, WarpIncl{incl});
      const uint32_t nj = __shfl_sync(kFull, n, j);
      const uint32_t qj = __shfl_sync(kFull, q, j);
      const uint32_t k = p - (__shfl_sync(kFull, incl, j) - nj);
      if (p < total) {
        const uint32_t d = cb::mh::mh_share(k, qj, nj);
        const int32_t bin = rows[(long long)k * a.lanes + j];
        if (d != 0 && bin >= 0 && bin < a.nbins) atomicAdd(a.hist + bin, d);
      }
    }
  }
  __shared__ unsigned long long part[2][kMhWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dep += __shfl_xor_sync(kFull, dep, o);
    mass += __shfl_xor_sync(kFull, mass, o);
  }
  if (lane == 0) {
    part[0][threadIdx.x >> 5] = dep;
    part[1][threadIdx.x >> 5] = mass;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sd = 0, sm = 0;
    for (int w = 0; w < kMhWarps; ++w) {
      sd += part[0][w];
      sm += part[1][w];
    }
    if (sd != 0) atomicAdd(dep_out, sd);
    if (sm != 0) atomicAdd(mass_out, sm);
  }
}

// The queue's blocks: `warps` resident warps in all (iargs of the C
// functions), no more than the batch has takes.
int queue_blocks(int k, int warps, int take) {
  const int groups = (k + 31) / 32;
  const int takes = (groups + take - 1) / take;
  const int w = warps < takes ? warps : takes;
  return (w + kQueueWarps - 1) / kQueueWarps;
}

// The replay's share of an SM's shared memory, in percent, where its grid
// fills its resident warps. The replay uses none, so with no preference an
// SM that takes its blocks first is set up for the most L1, where one block
// of the next pass's classify (4 KB) fits beside them and not the six its
// registers allow: at canvas1k.default's plan 896 of classify's 1,024
// blocks started only once the replay had left (measured on an H100). A
// partial grid (a few thousand orbits, hires15k.medium's) leaves SMs free
// and keeps no preference: there the replay sets the pass, and classify
// blocks beside it cost 8% of the rate (measured on an H100).
constexpr int kReplayCarveout = 25;

// Sets replay_deposit_kernel<FR>'s preferred carveout (-1: none) on the
// current device where it differs from the one set there last.
template <int FR>
cudaError_t carve(int percent) {
  constexpr int kDevices = 64;
  static int last[kDevices];  // percent + 2; 0: not set yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && last[dev] == percent + 2) return cudaSuccess;
  e = cudaFuncSetAttribute(replay_deposit_kernel<FR>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           percent);
  if (e == cudaSuccess && dev < kDevices) last[dev] = percent + 2;
  return e;
}

template <int FR>
cudaError_t launch_replay(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          const cb::CanvasQ& q, int warps, int take,
                          unsigned long long* next, unsigned long long* hits,
                          cudaStream_t stream) {
  const int blocks = queue_blocks(k, warps, take);
  const cudaError_t e =
      carve<FR>(blocks * kQueueWarps >= warps ? kReplayCarveout : -1);
  if (e != cudaSuccess) return e;
  replay_deposit_kernel<FR><<<blocks, kQueueBlock, 0, stream>>>(
      cr, ci, iters, k, hist, q, take, next, hits);
  return cudaGetLastError();
}

template <int FR>
cudaError_t launch_ids(const float* cr, const float* ci, const int32_t* iters,
                       const long long* off, int k, int32_t* ids,
                       const cb::CanvasQ& q, int warps, int take,
                       unsigned long long* next, unsigned long long* hits,
                       cudaStream_t stream) {
  replay_ids_kernel<FR><<<queue_blocks(k, warps, take), kQueueBlock, 0,
                          stream>>>(cr, ci, iters, off, k, ids, q, take, next,
                                    hits);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_deposit_ids(const void* ids, long long n, void* hist,
                              int nbins, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  // A thread a 16-byte word, 64 blocks an SM at most (grid-stride beyond).
  long long grid = ((n + 3) / 4 + kBlock - 1) / kBlock;
  if (grid > 64LL * sms) grid = 64LL * sms;
  deposit_ids_kernel<<<int(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, static_cast<uint32_t*>(hist),
      nbins);
  return int(cudaGetLastError());
}

// row_start, row_count: the rows of the canvas the histogram holds,
// (0, height) for a whole canvas or a shard's window (hist then holds
// row_count * width cells); warps: the resident warps to launch (the SMs
// times the warps per SM); take: the groups of 32 a warp takes from the
// queue at once; next: one zeroed uint64, the queue's counter; hits: one
// uint64 the kernel adds the count of points deposited into the histogram
// to. Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_replay_deposit(int fractal, const void* cr, const void* ci,
                                 const void* iters, int k, void* hist,
                                 float min_re, float min_im, float d_re,
                                 float d_im, int width, int height,
                                 int row_start, int row_count, int warps,
                                 int take, void* next, void* hits,
                                 void* stream) {
  if (k <= 0) return 0;
  if (warps <= 0 || take <= 0 || row_count < 0)
    return int(cudaErrorInvalidValue);
  const cb::CanvasQ q{min_re, min_im, d_re, d_im,
                      width, height, row_start, row_count};
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
// histogram; the sentinel is row_count * width. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int cb_replay_ids(int fractal, const void* cr, const void* ci,
                             const void* iters, const void* off, int k,
                             void* ids, float min_re, float min_im,
                             float d_re, float d_im, int width, int height,
                             int row_start, int row_count, int warps,
                             int take, void* next, void* hits,
                             void* stream) {
  if (k <= 0) return 0;
  if (warps <= 0 || take <= 0 || row_count < 0)
    return int(cudaErrorInvalidValue);
  const cb::CanvasQ q{min_re, min_im, d_re, d_im,
                      width, height, row_start, row_count};
  const auto* pcr = static_cast<const float*>(cr);
  const auto* pci = static_cast<const float*>(ci);
  const auto* pit = static_cast<const int32_t*>(iters);
  const auto* po = static_cast<const long long*>(off);
  auto* pids = static_cast<int32_t*>(ids);
  auto* pn = static_cast<unsigned long long*>(next);
  auto* phits = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fractal) {
    case cb::kBuddhabrot:
      return int(launch_ids<cb::kBuddhabrot>(pcr, pci, pit, po, k, pids, q,
                                             warps, take, pn, phits, s));
    case cb::kBurningShip:
      return int(launch_ids<cb::kBurningShip>(pcr, pci, pit, po, k, pids, q,
                                              warps, take, pn, phits, s));
    case cb::kAntiBuddhabrot:
      return int(launch_ids<cb::kAntiBuddhabrot>(
          pcr, pci, pit, po, k, pids, q, warps, take, pn, phits, s));
  }
  return int(cudaErrorInvalidValue);
}

// bins: (chunks, slots, lanes) int32; gate (nullptr: none), t, rep:
// (chunks * lanes,) int32 with n = chunks * lanes emissions; a slot with
// gate < gate_min deposits nothing. deposits, mass: one int64 each, which
// the kernel adds the recorded-bin count and the deposited mass to.
// blocks: the grid (the SMs times the blocks per SM). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int cb_mh_deposit(const void* bins, const void* gate,
                             int gate_min, const void* t, const void* rep,
                             long long n, int slots, int lanes, void* hist,
                             int nbins, void* deposits, void* mass,
                             int blocks, void* stream) {
  if (n <= 0) return 0;
  if (slots <= 0 || lanes <= 0 || n % lanes != 0 || blocks <= 0 ||
      n / lanes * ((lanes + 31LL) / 32) >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  const cb::mh::MhDepositArgs a{
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(t),
      static_cast<const int32_t*>(rep),  n, slots, lanes,
      static_cast<uint32_t*>(hist),      nbins,
      static_cast<const int32_t*>(gate), gate_min};
  mh_deposit_kernel<<<unsigned(blocks), kMhBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned long long*>(deposits),
      static_cast<unsigned long long*>(mass));
  return int(cudaGetLastError());
}
