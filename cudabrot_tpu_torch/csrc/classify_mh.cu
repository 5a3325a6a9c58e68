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
// policy, shared with the host harness. A lane's 18 scalar state words (22
// at df32), the pending triple and the 8 counters live in registers across
// the pass, loaded and stored once; the TPU's sequential chunk grid and its
// VMEM pending scratch become loops and registers in the thread. Each
// kernel is a template on V in {2, 4, 8, 16, 32}. The three reservoirs (vb,
// xb and the pending bins, V words each): the df32 kernel keeps them in
// registers (mh.cuh RegSlots: the run-time slot's write an unrolled
// predicated select), the f32 kernel the chain's two in one column of
// shared memory per lane (SharedSlots). All arrays are lane-contiguous.
//
// The f32 kernel compacts its warps' boundary draws, as classify.cu does
// its refills. A finished proposal needs two Threefry-2x32 blocks (~70
// instructions each); at the crop cell 94% of warp-windows have a finished
// lane, so with the draw inside the lane's branch the whole warp paid both
// blocks at nearly every window. Here thread t of warp g carries
// S = kLanesPerThread lanes, (g * S + j) * 32 + t; after the window the
// warp ballots its finished lanes, each writes its lane id at the slot the
// popcounts give it (classify.cuh refill_slot), and after a __syncwarp the
// warp computes the 2F blocks of its F finished lanes in ceil(2F / 32)
// full passes (entry q: lane q_lane[q / 2], block q % 2, mh.cuh mh_block);
// after a second __syncwarp each finished lane reads its four words back
// and resolves (mh_resolve). A block is Threefry of (lane, window),
// whichever thread computes it, so the words, and the pass, are the
// one-thread-per-lane kernel's bit for bit. But a window there is 16 steps
// and a lane resolves a proposal every ~190: the compaction saved 4-7% of
// the one-thread-per-lane kernel. The window's steps cost more, so the kernel
// also unrolls the window at compile time and keeps the chain's two
// reservoirs in shared memory, which leaves a lane 64 registers at V = 8.
// The df32
// kernel keeps one thread per lane and the run-time window
// (mh.cuh classify_mh_lane): its df32 step (~50 registers, ~110
// instructions) leaves the draws a small share.
//
// Bound. Operations: the orbit step (f32, or 94 f32 operations at df32
// plus the centre-relative window coordinates), the window test, the LCG
// and the reservoir test per inner step, the chain boundary per window,
// against the card's f32 rate, and the Threefry blocks on the integer ALU;
// memory traffic is a few words per lane per chunk. Warps still diverge in
// mh_resolve (only finished lanes resolve) and in record_visit (only
// in-window steps quantize a bin); the df32 step is a long dependent chain,
// so latency limits a thread.
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

// Lanes per thread of the f32 kernel: 1, faster than 2 at the mhcrop cell
// (chip_smoke.py --mh-study builds 2 with -DCB_MH_LANES_PER_THREAD).
#ifndef CB_MH_LANES_PER_THREAD
#define CB_MH_LANES_PER_THREAD 1
#endif
constexpr int kLanesPerThread = CB_MH_LANES_PER_THREAD;
static_assert(kLanesPerThread == 1 || kLanesPerThread == 2,
              "CB_MH_LANES_PER_THREAD must be 1 or 2");

// Where the f32 kernel keeps a lane's three V-word reservoirs: 1 (the
// package's) the chain's xb and p_b, which only a boundary touches, in
// shared memory and the visit reservoir vb in registers (64 registers at
// V = 8, 96 at V = 32); the study builds (-DCB_MH_SHARED_SLOTS) 0, all in
// registers (80 and 154), and 2, all three in shared memory, so
// record_visit's write is one indexed store (54-56 at every V). 1 was the
// fastest at the mhcrop cell (V = 8) by 1-2%, 2 at V = 32 (chip_smoke.py
// --mh-study).
#ifndef CB_MH_SHARED_SLOTS
#define CB_MH_SHARED_SLOTS 1
#endif
static_assert(CB_MH_SHARED_SLOTS >= 0 && CB_MH_SHARED_SLOTS <= 2,
              "CB_MH_SHARED_SLOTS must be 0, 1 or 2");
template <int V>
using ChainSlots = std::conditional_t<(CB_MH_SHARED_SLOTS >= 1),
                                      cb::mh::SharedSlots,
                                      cb::mh::RegSlots<V>>;
template <int V>
using VisitSlots = std::conditional_t<(CB_MH_SHARED_SLOTS >= 2),
                                      cb::mh::SharedSlots,
                                      cb::mh::RegSlots<V>>;
// Shared-memory reservoirs of a lane, and the bytes of a block's.
constexpr int kSharedSlotArrays = CB_MH_SHARED_SLOTS == 0   ? 0
                                  : CB_MH_SHARED_SLOTS == 1 ? 2
                                                            : 3;
constexpr size_t slot_bytes(int V, int S) {
  return size_t(kSharedSlotArrays) * V * kBlock * S * sizeof(int32_t);
}

// The f32 kernel's window: 1 (the package's) unrolls it at compile time
// for U in {4, 8, 16, 32}, so the steps of a window are scheduled together
// (6-8% faster a pass at the mhcrop cell, U = 16); the study build
// -DCB_MH_WINDOW_UNROLL=0 runs the loop at the run-time U, as the df32
// kernel does.
#ifndef CB_MH_WINDOW_UNROLL
#define CB_MH_WINDOW_UNROLL 1
#endif

template <int FR, int V, int S, int U>
__global__ void __launch_bounds__(kBlock) classify_mh_kernel(Args a) {
  __shared__ int q_lane[kWarps][32 * S];
  __shared__ uint2 q_words[kWarps][64 * S];
  // The shared reservoirs: array r's word k of the lane in column c at
  // slots_s[(r * V + k) * kBlock * S + c], one column per (sub-lane,
  // thread), so a warp's 32 lanes touch 32 banks.
  extern __shared__ int32_t slots_s[];
  const int t = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  if (warp * S * 32 >= a.lanes) return;  // warp-uniform

  int lane[S];
  bool live[S];
  cb::mh::MhLane<V, OrbitF32, VisitSlots<V>, ChainSlots<V>> L[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lane[j] = (warp * S + j) * 32 + t;
    live[j] = lane[j] < a.lanes;
    const int stride = kBlock * S;
    int32_t* col = slots_s + j * kBlock + threadIdx.x;
    if constexpr (std::is_same_v<ChainSlots<V>, cb::mh::SharedSlots>) {
      L[j].ch.xb = {col, stride};
      L[j].ch.p_b = {col + V * stride, stride};
    }
    if constexpr (std::is_same_v<VisitSlots<V>, cb::mh::SharedSlots>)
      L[j].vb = {col + 2 * V * stride, stride};
    cb::mh::load_mh_lane(a, live[j] ? lane[j] : 0, L[j]);
  }

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      bool fin[S];
      uint32_t mask[S];
      int F = 0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        fin[j] = cb::mh::mh_window<FR, U>(a, L[j]);
        if (!fin[j]) cb::mh::mh_advance(a, L[j], U > 0 ? U : a.unroll);
        fin[j] = fin[j] && live[j];
      }
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

template <int FR, int V>
__global__ void __launch_bounds__(256) classify_ext_mh_kernel(Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) cb::mh::classify_mh_lane<FR, V, OrbitDf>(a, lane);
}

template <int FR, int V, int U>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int S = kLanesPerThread;
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int grid = (warps + kWarps - 1) / kWarps;
  constexpr size_t smem = slot_bytes(V, S);
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        classify_mh_kernel<FR, V, S, U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  classify_mh_kernel<FR, V, S, U><<<grid, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Orbit, int FR, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<Orbit, OrbitDf>) {
    const int block = 256;
    const int grid = (a.lanes + block - 1) / block;
    classify_ext_mh_kernel<FR, V><<<grid, block, 0, stream>>>(a);
    return cudaGetLastError();
  } else {
#if CB_MH_WINDOW_UNROLL
    switch (a.unroll) {
      case 4: return launch_f32<FR, V, 4>(a, stream);
      case 8: return launch_f32<FR, V, 8>(a, stream);
      case 16: return launch_f32<FR, V, 16>(a, stream);
      case 32: return launch_f32<FR, V, 32>(a, stream);
    }
#endif
    return launch_f32<FR, V, 0>(a, stream);
  }
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
