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
// thinning of the reference design, kept). The lane's window, draw, refill
// and slot functions are in classify.cuh.
//
// Layout. The TPU runs the lanes as (R, 128) vectors and the chunks as a
// sequential grid. Here each thread carries S = kLanesPerThread lanes:
// thread t of the warp that runs lane group g holds lanes
// (g * S + j) * 32 + t, j < S, so every load and store of a warp is 32
// consecutive lanes of a lane-contiguous ([..., lane]) array, one coalesced
// 128-byte transaction. The lanes' state lives in registers through a
// slice of the pass (below), and the chunk grid is a loop inside the
// thread, flushing the emission slots after each chunk. The window of U
// orbit updates is unrolled for U in {1, 2, 4, 8, 16, 32} (a runtime loop
// otherwise), and its boundary is selects: the S lanes' windows run
// without a branch.
//
// The slice queue. The pass runs beside the previous pass's replay, whose
// high-priority blocks take the SMs first; blocks of this kernel that find
// no room start only when replay blocks exit (the room is the replay's
// shared-memory carveout, deposit.cu kReplayCarveout, and the registers).
// With a pass's work tied to each block, a block that started late
// finished late, and the pass waited for it. So the work is a queue of
// items (lane group, slice), a slice being a run of whole windows
// (classify.cuh slice_plan: up to 64 a pass, a short pass whole), taken in
// slice-major order from a ticket counter by whichever warps are resident:
// a warp that arrives late takes what is left, or nothing. At a slice's ends the lanes go through the arrays they are loaded
// from and stored to once a pass without the queue (classify.cuh load_lane,
// store_lane): the state, the stat rows (read-added), and, where a slice
// ends inside a chunk, the pending emission in that chunk's slot. Item
// (g, s) starts once (g, s - 1) has released its lanes: one progress word a
// (group, thread), stored with release order by the thread that stored those
// lanes and read with acquire order by the thread that loads them (the same
// thread index: a lane's thread is fixed by its id). The draws stay
// Threefry(key, (lane, window)), so the cut changes no result.
//
// Bound. Operations: ~9 f32 operations per inner lane-step, ~40 per window
// boundary, and per refill draw the Threefry-2x32 block (integer adds,
// rotates and xors: the ALU pipe, 64 lanes a clock per SM, half the f32
// rate), the domain map and the cull. At the default band [20,100) a lane
// draws every ~3.3 windows, and with one lane per thread nearly every warp
// has a finished lane at every window: a divergent refill made the whole
// warp pay a Threefry block every step, 30% of its lanes using it. So the
// refill is compacted: the warp ballots its S * 32 finished flags, each
// finished (thread, sub-lane) pair writes its lane id into the warp's
// shared-memory queue at the slot the popcounts give it
// (classify.cuh refill_slot), and after __syncwarp the warp computes the F
// queued draws in ceil(F / 32) full passes, thread q taking slots q,
// q + 32, ...; after a second __syncwarp each finished lane reads its own
// slot. The draw of lane L at window g is Threefry(key, (L, g)) whichever
// thread computes it, so S changes no result.
//
// What orders the queue. All 32 threads of a warp reach every ballot and
// both __syncwarp calls of a window: the early return drops whole warps,
// a thread whose lanes lie past `lanes` runs a stand-in copy of lane 0
// with its finish masked off (`live`), and F, summed from the ballots, is
// the same in every thread, so `F == 0` skips both barriers for the whole
// warp. Within a window the first __syncwarp orders the q_lane writes
// before the draws read them, and the second orders the q_draw writes
// before the finished lanes read them. Across windows no third barrier is
// needed: every read of q_lane in window w comes before w's second
// __syncwarp, and the next write of q_lane comes after it; every read of
// q_draw in window w comes before the next window's first __syncwarp, and
// the next write of q_draw comes after it. chip_smoke.py's phase 12 runs
// the kernel repeatedly on one input and holds every run to the first
// bit for bit.
//
// Arithmetic rounds once per operation (orbit.cuh), so this kernel equals
// the plain PyTorch version (ops/classify.classify_pass_plain) bitwise.
//
// The file also holds threefry_bits, the compaction's selection words
// (the JAX engine draws them with jax.random.bits in XLA), and
// pass_counters, the pass's counter sums over this kernel's stat rows.
#include <cuda_runtime.h>

#include "classify.cuh"
#include "counters.cuh"

namespace {

constexpr int kBlock = 128;  // 4 warps
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocks = 8;

// Lanes per thread. 2 was the fastest of 1, 2 and 4 on an H100 at the
// default cell and level with 4 at the deep one (measured in PR 6);
// S = 4 leaves too few warps resident to hide the draws' scattered loads.
constexpr int kLanesPerThread = 2;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Windows [w0, w1) of the pass for lane group g, the warp's item: the
// lanes' state, counters and pending emissions loaded at w0, the windows
// run chunk by chunk with a flush at each chunk's end (or, where the slice
// ends inside a chunk, the hand-over into the chunk's slot), and the state
// and counters stored at w1.
template <int FR, bool THIN, bool VISIT, int S, int U>
__device__ void classify_slice(const cb::ClassifyArgs& a, int g, int w0,
                               int w1, int* q_lane, cb::Draw* q_draw) {
  const int t = threadIdx.x & 31;
  int lane[S];
  bool live[S];
  cb::Lane L[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lane[j] = (g * S + j) * 32 + t;
    live[j] = lane[j] < a.lanes;
    L[j] = cb::load_lane(a, live[j] ? lane[j] : 0, w0);
  }

  for (int chunk = w0 / a.windows; chunk * a.windows < w1; ++chunk) {
    const int c0 = chunk * a.windows;
    const int wz = w1 - c0 < a.windows ? w1 - c0 : a.windows;
    for (int w = w0 > c0 ? w0 - c0 : 0; w < wz; ++w) {
      bool fin[S];
      uint32_t mask[S];
      int F = 0;
#pragma unroll
      for (int j = 0; j < S; ++j)
        fin[j] = cb::lane_window<FR, THIN, VISIT, U>(a, L[j]) && live[j];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        mask[j] = __ballot_sync(kFull, fin[j]);
        F += __popc(mask[j]);
      }
      if (F == 0) continue;  // warp-uniform
      const int gwin = c0 + w;
      int slot[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        slot[j] = cb::refill_slot<S>(mask, t, j);
        if (fin[j]) q_lane[slot[j]] = lane[j];
      }
      __syncwarp();
      for (int q = t; q < F; q += 32)
        q_draw[q] = cb::draw_sample<FR>(a, q_lane[q], gwin);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (fin[j]) cb::refill<VISIT>(L[j], q_draw[slot[j]]);
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (live[j]) cb::flush_lane(a, L[j], chunk, lane[j]);
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (live[j]) cb::store_lane(a, L[j], lane[j]);
}

// kMinBlocks a SM: a full SM holds the grid's share (1,024 blocks over 132
// SMs at 262,144 lanes), which caps a thread at 64 registers.
template <int FR, bool THIN, bool VISIT, int S, int U>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    classify_kernel(cb::ClassifyArgs a) {
  __shared__ int q_lane[kWarps][32 * S];
  __shared__ cb::Draw q_draw[kWarps][32 * S];
  const int t = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int groups = (a.lanes + 32 * S - 1) / (32 * S);
  if (warp >= groups) return;  // warp-uniform

  // Items (lane group, slice) in slice-major order: every group's slice 0,
  // then every group's slice 1, and so on. A warp takes the next item from
  // the ticket counter until none is left, so warps that become resident
  // late (behind another kernel's blocks) take fewer items, or none.
  uint32_t* const head = a.queue;
  const uint32_t base = ld_acquire(head + cb::kBase);
  const cb::Slices sl = cb::slice_plan(a.chunks, a.windows);
  const int windows = a.chunks * a.windows;
  const uint32_t items = uint32_t(groups) * uint32_t(sl.count);
  uint32_t first = items;
  int taken = 0;
  for (;; ++taken) {
    uint32_t item = 0;
    if (t == 0) item = atomicAdd(head + cb::kTicket, 1u);
    item = __shfl_sync(kFull, item, 0);
    if (taken == 0) first = item;
    if (item >= items) break;
    const int s = int(item / uint32_t(groups));
    const int g = int(item - uint32_t(s) * uint32_t(groups));
    // Thread t of the warp that ran (g, s - 1) stored the lanes thread t
    // loads here, then released its progress word: acquiring it orders
    // those stores before these loads. (g, s - 1) was taken before (g, s)
    // by a running warp, so the wait ends.
    uint32_t* const progress =
        head + cb::kQueueHead + size_t(g) * 32 + t;
    if (s > 0) {
      const uint32_t need = base + uint32_t(s);
      while (!__all_sync(kFull, int(ld_acquire(progress) - need) >= 0))
        __nanosleep(256);
    }
    const int w0 = s * sl.len;
    const int w1 = w0 + sl.len < windows ? w0 + sl.len : windows;
    classify_slice<FR, THIN, VISIT, S, U>(a, g, w0, w1, q_lane[wb],
                                          q_draw[wb]);
    st_release(progress, base + uint32_t(s) + 1u);
  }

  if (t != 0) return;
  // A late warp: its first take came after every warp of the grid could
  // have taken one, so it was not resident at the launch.
  if (a.late != nullptr && first >= uint32_t(groups)) {
    atomicAdd(a.late, 1ull);
    atomicAdd(a.late + 1, (unsigned long long)taken);
  }
  // The last warp to find the queue empty: every item has finished and no
  // warp reads the queue again, so it resets the counters for the next
  // launch and moves the base past this launch's progress values.
  if (atomicAdd(head + cb::kExited, 1u) == uint32_t(groups) - 1u) {
    head[cb::kTicket] = 0u;
    head[cb::kExited] = 0u;
    head[cb::kBase] = base + uint32_t(sl.count);
  }
}

// One warp a lane group, as many as the queue can give work at once.
template <int FR, bool THIN, bool VISIT, int S, int U>
cudaError_t launch(const cb::ClassifyArgs& a, cudaStream_t stream) {
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int grid = (warps + kWarps - 1) / kWarps;
  classify_kernel<FR, THIN, VISIT, S, U><<<grid, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const cb::ClassifyArgs&, cudaStream_t);

// The instantiation for a window of `unroll` updates: unrolled for the
// powers of two up to 32, a runtime loop (U = 0) otherwise.
template <int FR, bool THIN, bool VISIT, int S>
LaunchFn pick_unroll(int unroll) {
  switch (unroll) {
    case 1: return launch<FR, THIN, VISIT, S, 1>;
    case 2: return launch<FR, THIN, VISIT, S, 2>;
    case 4: return launch<FR, THIN, VISIT, S, 4>;
    case 8: return launch<FR, THIN, VISIT, S, 8>;
    case 16: return launch<FR, THIN, VISIT, S, 16>;
    case 32: return launch<FR, THIN, VISIT, S, 32>;
  }
  return launch<FR, THIN, VISIT, S, 0>;
}

template <int FR>
LaunchFn pick(int thin, int visit, int unroll) {
  constexpr int S = kLanesPerThread;
  if (!thin) return visit ? nullptr
                          : pick_unroll<FR, false, false, S>(unroll);
  return visit ? pick_unroll<FR, true, true, S>(unroll)
               : pick_unroll<FR, true, false, S>(unroll);
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

// The counters of one pass (counters.cuh), in one launch on the stream
// the counters run on.
//
// Replaces no TPU kernel: the JAX engine sums the stat rows in XLA
// (cudabrot_tpu/engines/pallas_engine.py _classify_and_compact, "stats")
// and the port ran about seventeen PyTorch launches a pass for the same
// sums and adds, over the whole kept batch. Bound: bytes, the stat rows
// (5 x lanes words) and the counted batch slots (4 bytes each) read once,
// over the HBM rate. The kernel reads each input once, in 16-byte vectors,
// eight in flight a thread, and only the kept prefix of the batch, whose
// kept emissions come first (its count is n_valid on the device, read by
// every thread, with no host round trip). Each thread sums
// into 64-bit registers, a block through warp shuffles and shared memory,
// and one thread a total adds the block's sum with a 64-bit atomicAdd:
// integer adds commute modulo 2^64, so the totals are the plain version's
// bit for bit in any order of the blocks. The grid is a few blocks
// (ops/pass_counters.py BLOCKS): the kernel runs while the pass's replay
// holds the multiprocessors, and a grid that needs room on all of them
// waits for the replay's blocks, holding back the next classify.
struct CountersArgs {
  const int32_t* stats;  // kRows x width
  long long width;
  const int32_t* iters;  // n
  long long n;
  const long long* n_valid;
  long long capacity, steps;
  unsigned long long* totals[cb::counters::kTotals];
};

__device__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(cb::counters::kThreads)
    pass_counters_kernel(CountersArgs a) {
  namespace pc = cb::counters;
  constexpr int kSums = pc::kRows + 1, kWarps = pc::kThreads / 32;
  __shared__ long long part[kSums][kWarps];
  const long long nv = *a.n_valid;
  const long long k = pc::batch_bound(a.n, nv, a.capacity);
  long long s[kSums];
  pc::thread_sums(a.stats, a.width, a.iters, k,
                  (long long)blockIdx.x * blockDim.x + threadIdx.x,
                  (long long)gridDim.x * blockDim.x, s);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const long long v = warp_sum(s[i]);
    if (lane == 0) part[i][w] = v;
  }
  __syncthreads();
  if (threadIdx.x >= pc::kTotals) return;
  long long sum[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    sum[i] = 0;
    for (int j = 0; j < kWarps; ++j) sum[i] += part[i][j];
  }
  long long add[pc::kTotals];
  pc::block_adds(blockIdx.x, sum, nv, a.capacity, a.steps, add);
  const long long v = add[threadIdx.x];
  if (v != 0)
    atomicAdd(a.totals[threadIdx.x], (unsigned long long)v);
}

}  // namespace

// The counters of a pass into the render's int64 totals. stats: kRows x
// width int32 words (classify's stat rows); iters: n int32 slots of the
// kept batch (n = 0: none), of which the first min(n_valid, capacity, n)
// are read; n_valid: one int64
// on the device; steps: the pass's lane-steps; totals: kTotals pointers to
// one int64 each, in counters.cuh's order; blocks: the grid (a
// grid-stride loop). Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_pass_counters(const void* stats, long long width,
                                const void* iters, long long n,
                                const void* n_valid, long long capacity,
                                long long steps, void* const* totals,
                                int blocks, void* stream) {
  namespace pc = cb::counters;
  if (width < 0 || n < 0 || blocks <= 0 || (n > 0 && iters == nullptr))
    return int(cudaErrorInvalidValue);
  CountersArgs a;
  a.stats = static_cast<const int32_t*>(stats);
  a.width = width;
  a.iters = static_cast<const int32_t*>(iters);
  a.n = n;
  a.n_valid = static_cast<const long long*>(n_valid);
  a.capacity = capacity;
  a.steps = steps;
  for (int i = 0; i < pc::kTotals; ++i)
    a.totals[i] = static_cast<unsigned long long*>(totals[i]);
  pass_counters_kernel<<<blocks, pc::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

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

// Arguments as classify.cuh classify_args documents them. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int cb_classify(void** ptrs, const int* iargs, const float* fargs,
                           uint32_t k0, uint32_t k1, void* stream) {
  const cb::ClassifyArgs a = cb::classify_args(ptrs, iargs, fargs, k0, k1);
  const int thin = iargs[1], visit = iargs[2];
  LaunchFn fn = nullptr;
  switch (iargs[0]) {
    case cb::kBuddhabrot:
      fn = pick<cb::kBuddhabrot>(thin, visit, a.unroll);
      break;
    case cb::kBurningShip:
      fn = pick<cb::kBurningShip>(thin, visit, a.unroll);
      break;
    case cb::kAntiBuddhabrot:
      fn = pick<cb::kAntiBuddhabrot>(thin, visit, a.unroll);
      break;
  }
  if (fn == nullptr || a.lanes <= 0 || a.unroll <= 0 || a.queue == nullptr)
    return int(cudaErrorInvalidValue);
  return int(fn(a, static_cast<cudaStream_t>(stream)));
}
