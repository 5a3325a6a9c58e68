// Metropolis-Hastings classify passes for Hopper (sm_90a): the chain over
// the f32 orbit and over the df32 orbit (deep-zoom windows).
//
// Replaces the TPU kernels cudabrot_tpu/ops/pallas_kernels_mh.py
// _make_kernel_mh (called by classify_pass_mh) and _make_kernel_ext_mh
// (called by classify_pass_ext_mh). Same function: every lane runs one
// Markov chain over the 2^24-point sample grid whose stationary density
// follows the number of orbit points a sample puts on the canvas window.
// The orbit evaluation of a proposal is its target evaluation: the inner
// window counts in-window positions and records their canvas bins in a
// per-lane reservoir of V slots; at the boundary a finished proposal is
// accepted or rejected, a retiring tenure goes to the lane's pending
// emission (rep, target, recorded bins; collisions merge by weighted
// reservoir sampling), and the next proposal is a multi-scale mutation of
// the chain state or a uniform restart.
//
// The df32 kernel runs the same chain over the double-float orbit of
// classify_ext.cu: c = centre (+) (k - 2^23) * step in df32, the cull on
// the f32 approximation of c, Brent on hi parts. Its window test and bin
// quantization run in centre-relative coordinates, (z.hi - centre.hi) +
// (z.lo - centre.lo): absolute f32 bounds collapse to an empty interval
// once the span drops below the f32 ulp of the centre, the regime that
// kernel exists for.
//
// Design. mh.cuh holds the lane's functions, templates on the orbit
// policy, shared with the host harness, and both kernels run one warp
// template (mh_pass below). A lane's 18 scalar state words (22 at df32),
// the pending triple and the 8 counters live in registers across the pass,
// loaded and stored once; the TPU's sequential chunk grid and its VMEM
// pending scratch become loops and registers in the thread. Each kernel is
// a template on V in {2, 4, 8, 16, 32} and on the window's U, unrolled at
// compile time. Thread t of warp g carries S lanes, (g * S + j) * 32 + t,
// so all lane-contiguous arrays load and store coalesced. The three
// V-word reservoirs (vb, xb and the pending bins) live in registers or in
// one column of shared memory per lane, as each kernel's build says.
//
// Both kernels compact their warps' boundary draws, as classify.cu does
// its refills. A finished proposal needs two Threefry-2x32 blocks (~70
// instructions each); at the crop cell 94% of warp-windows have a finished
// lane, so with the draw inside the lane's branch the whole warp paid both
// blocks at nearly every window. After the window the warp ballots its
// finished lanes, each writes its lane id at the slot the popcounts give
// it (classify.cuh refill_slot), and after a __syncwarp the warp computes
// the 2F blocks of its F finished lanes in ceil(2F / 32) full passes
// (entry q: lane q_lane[q / 2], block q % 2, mh.cuh mh_block); after a
// second __syncwarp each finished lane reads its four words back and
// resolves (mh_resolve). A block is Threefry of (lane, window), whichever
// thread computes it, so the words, and the pass, are those of a lane
// that draws its own, bit for bit: the compaction saved 4-7% of the f32
// kernel at mhcrop. At mhzoom 79% of the df32 kernel's warp-windows have
// a finished lane (a proposal every ~340 lane-steps, a window of 16), and
// compacted it was 1-2% faster at V = 8, level at V = 32.
//
// Bound. Operations: the orbit step (f32, or the df32 step with FFMA
// two-products plus the centre-relative window coordinates), the window
// test, the LCG and the reservoir test per inner step, the chain boundary
// per window, against the card's f32 rate, and the Threefry blocks on the
// integer ALU; memory traffic is a few words per lane per chunk. Warps
// still diverge in mh_resolve (only finished lanes resolve) and in
// record_visit (only in-window steps quantize a bin); the df32 step is a
// long dependent chain, so latency limits a thread.
//
// Arithmetic rounds once per operation, so these kernels equal
// ops/classify_mh.classify_pass_mh_plain (ext = False, True) bitwise.
#include <cuda_runtime.h>

#include <type_traits>

#include "classify.cuh"
#include "mh.cuh"

namespace {

using Args = cb::mh::ClassifyMhArgs;
using cb::mh::OrbitDf;
using cb::mh::OrbitF32;

constexpr int kBlock = 128;  // 4 warps
constexpr int kWarps = kBlock / 32;

// Each kernel's build, chosen by measurement (the f32 kernel at the
// mhcrop cell in PR 7, the df32 one at mhzoom in PR 9).
//  * Lanes per thread, S: 1 for both kernels. At f32, 1 was faster than
//    2 at mhcrop.
//  * Where a lane's three V-word reservoirs live, `shared`: 1 the chain's
//    xb and p_b, which only a boundary touches, in shared memory
//    (mh.cuh SharedSlots) and the visit reservoir vb in registers
//    (RegSlots, the run-time slot's write an unrolled predicated select);
//    2 all three in shared memory, so record_visit's write is one indexed
//    store. At f32, 1 was the fastest at V = 8 by 1-2% (64 registers,
//    against 80 and 54-56 with 0, all in registers, and 2), 2 at V = 32.
//    At df32, 2 was the fastest at mhzoom at both widths (on an NVIDIA
//    H100 80GB HBM3, 700.00 W, least of 2 rounds of 3 passes in each of
//    two runs, PERF.md section 6): V = 8 14.61 and 14.70 ms a pass against
//    15.41-15.51 with 1 and 15.75-15.86 with 0; V = 32 16.39-16.46 against
//    18.93-19.02 and 19.68-19.78. The df32 orbit's registers leave the
//    reservoirs none (80 registers with 1 at V = 8, 158 at V = 32). Two
//    lanes a thread spilled (255 registers) and took 19.67-19.68 ms at
//    V = 8, 20.88-21.01 at V = 32.
//  * The window is unrolled at compile time for U in {4, 8, 16, 32}
//    (launch below; 6-8% faster a pass at mhcrop, U = 16; at mhzoom, the
//    same card and runs, 14.61-14.70 ms against 15.87-15.96 as a loop at
//    V = 8, and level at V = 32, 16.31-16.39 as a loop); any other U runs
//    the loop.
template <class Orbit>
struct Build;
template <>
struct Build<OrbitF32> {
  static constexpr int S = 1;
  static constexpr int shared = 1;
};
template <>
struct Build<OrbitDf> {
  static constexpr int S = 1;
  static constexpr int shared = 2;
};

// The chain's reservoirs are in shared memory in both builds.
using ChainSlots = cb::mh::SharedSlots;
template <class Orbit, int V>
using VisitSlots = std::conditional_t<(Build<Orbit>::shared >= 2),
                                      cb::mh::SharedSlots,
                                      cb::mh::RegSlots<V>>;

// The bytes of a block's shared reservoirs.
template <class Orbit>
constexpr size_t slot_bytes(int V) {
  constexpr int arrays = Build<Orbit>::shared == 1 ? 2 : 3;
  return size_t(arrays) * V * kBlock * Build<Orbit>::S * sizeof(int32_t);
}

// One block's share of a pass: S lanes a thread, thread t of global warp
// g holding lanes (g * S + j) * 32 + t. Each window: the lanes' windows
// (mh_window, unrolled for U > 0), mh_advance for the unfinished, then the
// finished lanes' boundary draws, compacted, and mh_resolve.
template <class Orbit, int FR, int V, int U>
__device__ __forceinline__ void mh_pass(const Args& a) {
  using B = Build<Orbit>;
  constexpr int S = B::S;
  __shared__ int q_lane[kWarps][32 * S];
  __shared__ uint2 q_words[kWarps][64 * S];
  // The shared reservoirs: array r's word k of the lane in column c at
  // slots_s[(r * V + k) * kBlock * S + c], one column per (sub-lane,
  // thread), so a warp's 32 lanes touch 32 banks.
  extern __shared__ int32_t slots_s[];
  const int t = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  if (warp * S * 32 >= a.lanes) return;  // warp-uniform

  using CS = ChainSlots;
  using VS = VisitSlots<Orbit, V>;
  int lane[S];
  bool live[S];
  cb::mh::MhLane<V, Orbit, VS, CS> L[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lane[j] = (warp * S + j) * 32 + t;
    live[j] = lane[j] < a.lanes;
    const int stride = kBlock * S;
    int32_t* col = slots_s + j * kBlock + threadIdx.x;
    L[j].ch.xb = {col, stride};
    L[j].ch.p_b = {col + V * stride, stride};
    if constexpr (std::is_same_v<VS, cb::mh::SharedSlots>)
      L[j].vb = {col + 2 * V * stride, stride};
    cb::mh::load_mh_lane(a, live[j] ? lane[j] : 0, L[j]);
  }

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      const int gwin = chunk * a.windows + w;
      bool fin[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        fin[j] = cb::mh::mh_window<FR, U>(a, L[j]);
        if (!fin[j]) cb::mh::mh_advance(a, L[j], U > 0 ? U : a.unroll);
        fin[j] = fin[j] && live[j];
      }
      uint32_t mask[S];
      int F = 0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        mask[j] = __ballot_sync(0xffffffffu, fin[j]);
        F += __popc(mask[j]);
      }
      if (F == 0) continue;  // warp-uniform
      int slot[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        slot[j] = cb::refill_slot<S>(mask, t, j);
        if (fin[j]) q_lane[wb][slot[j]] = lane[j];
      }
      __syncwarp();
      for (int q = t; q < 2 * F; q += 32) {
        uint32_t x0, x1;
        cb::mh::mh_block(a, q_lane[wb][q >> 1], gwin, q & 1, x0, x1);
        q_words[wb][q] = make_uint2(x0, x1);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (fin[j]) {
          const uint2 m = q_words[wb][2 * slot[j]];
          const uint2 c = q_words[wb][2 * slot[j] + 1];
          cb::mh::mh_resolve<FR>(a, L[j], m.x, m.y, c.x, c.y);
        }
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (live[j]) cb::mh::flush_mh_lane(a, L[j], chunk, lane[j]);
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (live[j]) cb::mh::store_mh_lane(a, L[j], lane[j]);
}

template <int FR, int V, int U>
__global__ void __launch_bounds__(kBlock) classify_mh_kernel(Args a) {
  mh_pass<OrbitF32, FR, V, U>(a);
}

template <int FR, int V, int U>
__global__ void __launch_bounds__(kBlock) classify_ext_mh_kernel(Args a) {
  mh_pass<OrbitDf, FR, V, U>(a);
}

template <class Orbit, int FR, int V, int U>
cudaError_t launch_u(const Args& a, cudaStream_t stream) {
  constexpr int S = Build<Orbit>::S;
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int grid = (warps + kWarps - 1) / kWarps;
  constexpr size_t smem = slot_bytes<Orbit>(V);
  auto kernel = [] {
    if constexpr (std::is_same_v<Orbit, OrbitDf>)
      return classify_ext_mh_kernel<FR, V, U>;
    else
      return classify_mh_kernel<FR, V, U>;
  }();
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Orbit, int FR, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (a.unroll) {
    case 4: return launch_u<Orbit, FR, V, 4>(a, stream);
    case 8: return launch_u<Orbit, FR, V, 8>(a, stream);
    case 16: return launch_u<Orbit, FR, V, 16>(a, stream);
    case 32: return launch_u<Orbit, FR, V, 32>(a, stream);
  }
  return launch_u<Orbit, FR, V, 0>(a, stream);
}

template <class Orbit, int FR>
cudaError_t pick_slots(int slots, const Args& a, cudaStream_t s) {
  switch (slots) {
    case 2: return launch<Orbit, FR, 2>(a, s);
    case 4: return launch<Orbit, FR, 4>(a, s);
    case 8: return launch<Orbit, FR, 8>(a, s);
    case 16: return launch<Orbit, FR, 16>(a, s);
    case 32: return launch<Orbit, FR, 32>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <class Orbit>
int classify(void** ptrs, const int* iargs, const float* fargs, uint32_t k0,
             uint32_t k1, void* stream) {
  const Args a = cb::mh::classify_mh_args(std::is_same_v<Orbit, OrbitDf>, ptrs,
                                          iargs, fargs, k0, k1);
  if (a.lanes <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int slots = iargs[1];
  switch (iargs[0]) {
    case cb::kBuddhabrot:
      return int(pick_slots<Orbit, cb::kBuddhabrot>(slots, a, s));
    case cb::kBurningShip:
      return int(pick_slots<Orbit, cb::kBurningShip>(slots, a, s));
    case cb::kAntiBuddhabrot:
      return int(pick_slots<Orbit, cb::kAntiBuddhabrot>(slots, a, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Arguments as mh.cuh classify_mh_args documents them (the 20 arrays of
// MhLaneState, the 24 of ExtMhLaneState). Each returns the cudaError_t of
// the launch (0 = launched).
extern "C" int cb_classify_mh(void** ptrs, const int* iargs,
                              const float* fargs, uint32_t k0, uint32_t k1,
                              void* stream) {
  return classify<OrbitF32>(ptrs, iargs, fargs, k0, k1, stream);
}

extern "C" int cb_classify_ext_mh(void** ptrs, const int* iargs,
                                  const float* fargs, uint32_t k0,
                                  uint32_t k1, void* stream) {
  return classify<OrbitDf>(ptrs, iargs, fargs, k0, k1, stream);
}
