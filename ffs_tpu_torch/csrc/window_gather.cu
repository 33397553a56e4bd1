// Fixed-size shoebox windows at per-reflection offsets, for Hopper (sm_90a).
//
// Replaces the TPU kernels ffs_tpu/ops/window_gather.py: _gather_planes_kernel
// (entry window_gather_planes; the integrator's resident frame blocks and its
// six hi/lo corner-field planes) and _gather_kernel (entry window_gather; the
// detector-mask windows).  Contract of both:
//
//     out[a, p, r, c] = img[p, y0[a] + r, x0[a] + c]   for r < bh, c < 128
//
// with img (P, Hp, Wp) of 4-byte elements (int32 or float32: the copy moves
// bits, so one kernel serves both) and out (A, P, bh, 128); the single-plane
// entry is the P = 1 case with out (A, bh, 128).  The Python wrappers check
// the contract on the host before a launch (Wp % 128 == 0, Wp >= 256,
// bh % 8 == 0, 0 <= x0 < Wp - 128, 0 <= y0, y0 + bh <= Hp), so the kernel
// reads no index it was not promised.
//
// What bounds it on the H100: bytes.  The copy does no arithmetic, so the
// least time is (4 B x P x the image pixels under the union of the windows,
// read once + 4 B x A x P x bh x 128 written) / 3.35 TB/s; the windows of a
// chunk overlap, so the union is smaller than their sum.  The TPU kernel
// had to DMA two aligned 128-lane blocks per row and align them with a lane
// rotate, because its DMAs could not start at an arbitrary lane.  A GPU load
// can, so the design is the simple one: one block per (window, plane), one
// thread per output column, each thread walking the bh rows.  A warp then
// reads 128 consecutive bytes of a source row (coalesced, at most two cache
// lines past the unaligned start) and writes one aligned 128-byte segment of
// the output row, and the bh loads of a thread are independent, so many are
// in flight.  The output keeps the TPU kernel's 128-column width so that the
// integrator's step ports one to one; a window of the bbox's own width would
// move ~5x fewer bytes and is a later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
    gather_windows_kernel(const uint32_t* __restrict__ img, long long plane_stride, int wp,
                          const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
                          int bh, uint32_t* __restrict__ out) {
  const int a = blockIdx.x;
  const int p = blockIdx.y;
  const int planes = gridDim.y;
  const int c = threadIdx.x;
  const uint32_t* src = img + p * plane_stride + static_cast<long long>(y0[a]) * wp + x0[a] + c;
  uint32_t* dst = out + (static_cast<long long>(a) * planes + p) * bh * kLanes + c;
#pragma unroll 8
  for (int r = 0; r < bh; ++r) {
    dst[static_cast<long long>(r) * kLanes] = __ldg(src + static_cast<long long>(r) * wp);
  }
}

int launch(const void* img, int planes, int hp, int wp, const void* y0, const void* x0, int a,
           int bh, void* out, void* stream) {
  if (a == 0) return 0;
  dim3 grid(a, planes);
  gather_windows_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), static_cast<long long>(hp) * wp, wp,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(x0), bh,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (P, Hp, Wp) 4-byte elements; y0, x0 (A,) int32 on the device; out
// (A, P, bh, 128).  Launches on `stream`; returns the launch error (0 on
// success).
extern "C" int ffs_window_gather_planes(const void* img, int planes, int hp, int wp,
                                        const void* y0, const void* x0, int a, int bh,
                                        void* out, void* stream) {
  return launch(img, planes, hp, wp, y0, x0, a, bh, out, stream);
}

// img (Hp, Wp) 4-byte elements; out (A, bh, 128).  Otherwise as above.
extern "C" int ffs_window_gather(const void* img, int hp, int wp, const void* y0,
                                 const void* x0, int a, int bh, void* out, void* stream) {
  return launch(img, 1, hp, wp, y0, x0, a, bh, out, stream);
}
