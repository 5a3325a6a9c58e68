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
// thread t of global warp g holds lanes (g * S + j) * 32 + t, j < S, so
// every load and store of a warp is 32 consecutive lanes of a
// lane-contiguous ([..., lane]) array, one coalesced 128-byte transaction.
// The lanes' state lives in registers, is loaded once and stored once per
// pass, and the chunk grid is a loop inside the thread, flushing the
// emission slots after each chunk. The window of U orbit updates is
// unrolled for U in {1, 2, 4, 8, 16, 32} (a runtime loop otherwise), and
// its boundary is selects: the S lanes' windows run without a branch.
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

// Lanes per thread. 2 was the fastest of 1, 2 and 4 on an H100 at the
// default cell and level with 4 at the deep one (measured in PR 6);
// S = 4 leaves too few warps resident to hide the draws' scattered loads.
constexpr int kLanesPerThread = 2;

template <int FR, bool THIN, bool VISIT, int S, int U>
__global__ void __launch_bounds__(kBlock) classify_kernel(cb::ClassifyArgs a) {
  __shared__ int q_lane[kWarps][32 * S];
  __shared__ cb::Draw q_draw[kWarps][32 * S];
  const int t = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  if (warp * S * 32 >= a.lanes) return;  // warp-uniform

  int lane[S];
  bool live[S];
  cb::Lane L[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lane[j] = (warp * S + j) * 32 + t;
    live[j] = lane[j] < a.lanes;
    L[j] = cb::load_lane(a, live[j] ? lane[j] : 0);
  }

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      bool fin[S];
      uint32_t mask[S];
      int F = 0;
#pragma unroll
      for (int j = 0; j < S; ++j)
        fin[j] = cb::lane_window<FR, THIN, VISIT, U>(a, L[j]) && live[j];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        mask[j] = __ballot_sync(0xffffffffu, fin[j]);
        F += __popc(mask[j]);
      }
      if (F == 0) continue;  // warp-uniform
      const int gwin = chunk * a.windows + w;
      int slot[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        slot[j] = cb::refill_slot<S>(mask, t, j);
        if (fin[j]) q_lane[wb][slot[j]] = lane[j];
      }
      __syncwarp();
      for (int q = t; q < F; q += 32)
        q_draw[wb][q] = cb::draw_sample<FR>(a, q_lane[wb][q], gwin);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (fin[j]) cb::refill<VISIT>(L[j], q_draw[wb][slot[j]]);
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (live[j]) cb::flush_lane(a, L[j], chunk, lane[j]);
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (live[j]) cb::store_lane(a, L[j], lane[j]);
}

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
  if (fn == nullptr || a.lanes <= 0 || a.unroll <= 0)
    return int(cudaErrorInvalidValue);
  return int(fn(a, static_cast<cudaStream_t>(stream)));
}
