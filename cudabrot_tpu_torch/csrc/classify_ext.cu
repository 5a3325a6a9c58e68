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
// the replay.
//
// Design. As in classify.cu, one thread is one lane: the 16 state words,
// the pending emission triple and the 5 counters live in registers across
// the whole pass, loaded and stored once; the TPU's sequential chunk grid
// and its VMEM pending scratch become the loops over chunks and windows
// inside the thread (classify_ext.cuh holds the lane function, shared with
// the host harness). All arrays are lane-contiguous, so a warp's loads and
// stores coalesce. The window centre and the pitches are kernel arguments
// (the TPU kernel's SMEM constants guard against XLA constant folding, a
// matter that does not arise here).
//
// Bound. Operations: 94 f32 operations per df32 lane-step against the
// card's f32 rate; memory traffic is a few bytes per lane per chunk. The
// df32 step is a long dependent chain (two_prod -> error sum ->
// quick_two_sum, three times over), so latency, not issue rate, limits a
// thread; enough resident warps hide it only while registers allow.
//
// Arithmetic rounds once per operation, so this kernel equals
// ops/classify_ext.classify_pass_ext_plain bitwise.
#include <cuda_runtime.h>

#include "classify_ext.cuh"

namespace {

template <int FR, bool VISIT>
__global__ void __launch_bounds__(256)
    classify_ext_kernel(cb::ClassifyExtArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) cb::classify_ext_lane<FR, VISIT>(a, lane);
}

template <int FR, bool VISIT>
cudaError_t launch(const cb::ClassifyExtArgs& a, cudaStream_t stream) {
  const int block = 256;
  const int grid = (a.lanes + block - 1) / block;
  classify_ext_kernel<FR, VISIT><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int FR>
cudaError_t pick(int visit, const cb::ClassifyExtArgs& a, cudaStream_t s) {
  return visit ? launch<FR, true>(a, s) : launch<FR, false>(a, s);
}

}  // namespace

// Arguments as classify_ext.cuh classify_ext_args documents them. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int cb_classify_ext(void** ptrs, const int* iargs,
                               const float* fargs, uint32_t k0, uint32_t k1,
                               void* stream) {
  const cb::ClassifyExtArgs a =
      cb::classify_ext_args(ptrs, iargs, fargs, k0, k1);
  if (a.lanes <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int visit = iargs[1];
  switch (iargs[0]) {
    case cb::kBuddhabrot: return int(pick<cb::kBuddhabrot>(visit, a, s));
    case cb::kBurningShip: return int(pick<cb::kBurningShip>(visit, a, s));
    case cb::kAntiBuddhabrot:
      return int(pick<cb::kAntiBuddhabrot>(visit, a, s));
  }
  return int(cudaErrorInvalidValue);
}
