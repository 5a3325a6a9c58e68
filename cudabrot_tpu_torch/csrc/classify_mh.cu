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
// Design. As in classify.cu, one thread is one lane (mh.cuh holds the lane
// function, a template on the orbit policy, shared with the host harness):
// the 18 scalar state words (22 at df32), the three reservoirs (vb, xb and
// the pending bins, V words each), the pending triple and the 8 counters
// live in registers across the pass, loaded and stored once; the TPU's
// sequential chunk grid and its VMEM pending scratch become loops and
// registers in the thread. Each kernel is a template on V in {2, 4, 8, 16,
// 32}: the reservoir slot is a run-time index, and with V a compile-time
// constant the write is an unrolled predicated select, so the arrays stay
// out of local memory while registers last. The df32 step alone takes ~50
// registers, so occupancy there is set by registers (the build log lists
// registers and spills per instantiation). All arrays are lane-contiguous.
//
// Bound. Operations: the orbit step (f32, or 94 f32 operations at df32
// plus the centre-relative window coordinates), the window test, the LCG
// and the reservoir test per inner step, the chain boundary per window,
// against the card's f32 rate; memory traffic is a few words per lane per
// chunk. Warps diverge at the boundary (only finished lanes resolve and
// redraw) and in record_visit (only in-window steps quantize a bin); the
// df32 step is a long dependent chain, so latency limits a thread.
//
// Arithmetic rounds once per operation, so these kernels equal
// ops/classify_mh.classify_pass_mh_plain (ext = False, True) bitwise.
#include <cuda_runtime.h>

#include <type_traits>

#include "mh.cuh"

namespace {

using Args = cb::mh::ClassifyMhArgs;
using cb::mh::OrbitDf;
using cb::mh::OrbitF32;

template <int FR, int V>
__global__ void __launch_bounds__(256) classify_mh_kernel(Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) cb::mh::classify_mh_lane<FR, V, OrbitF32>(a, lane);
}

template <int FR, int V>
__global__ void __launch_bounds__(256) classify_ext_mh_kernel(Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) cb::mh::classify_mh_lane<FR, V, OrbitDf>(a, lane);
}

template <class Orbit, int FR, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int block = 256;
  const int grid = (a.lanes + block - 1) / block;
  if constexpr (std::is_same_v<Orbit, OrbitDf>)
    classify_ext_mh_kernel<FR, V><<<grid, block, 0, stream>>>(a);
  else
    classify_mh_kernel<FR, V><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
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
