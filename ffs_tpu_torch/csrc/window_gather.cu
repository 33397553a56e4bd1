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
//
// Three more entries replace the TPU's gather variants, each the same copy
// loop with another output lane map, input layout or window count per block
// (bounded by bytes the same way):
//   * ffs_window_gather_planes_packed (_gather_planes_packed_kernel, entry
//     window_gather_planes_packed): out (A/4, P, bh, 128), lanes 32g..32g+31
//     of row i = columns 0..31 of window 4i+g.  Thread c serves window
//     4i + c/32, so each warp still reads 128 consecutive bytes of one
//     window row and the block writes one aligned 512-byte output row.  It
//     writes a quarter of the plane-first gather's bytes.
//   * ffs_window_gather_planes_pl (_gather_planes_pl_kernel, entry
//     window_gather_planes_pl): the plane-last input (Hp, Wp/128, P, 128);
//     column x of plane p sits at ((y*Wb + x/128)*P + p)*128 + x%128, so a
//     warp's 32 columns span at most two 512-byte runs.  The output equals
//     the plane-first gather's.
//   * ffs_window_gather_probe (the inner kernel of make_probe_gather,
//     tools/measure_window_gather.py): the plane-first gather with `r`
//     windows per block (the TPU's windows per grid program; a block walks
//     its r windows and all planes in turn), and a single-block form that
//     reads only the aligned 128-column block holding x0 and rotates it,
//     out[a,q,r,c] = img[q, y0+r, 128*xblk + (c + shift) % 128] with
//     xblk = min(x0/128, Wp/128 - 2), shift = x0 - 128*xblk: the TPU
//     probe's result, which is the window itself only where shift == 0.
//     The TPU probe's DMA pipeline depth (`slots`) has no counterpart: a GPU
//     keeps loads in flight through its resident warps and each thread's
//     unrolled row loop, which the hardware, not the caller, schedules.

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

// Lanes 32g..32g+31 of output row i hold columns 0..31 of window 4i+g.
__global__ void __launch_bounds__(kLanes)
    gather_packed_kernel(const uint32_t* __restrict__ img, long long plane_stride, int wp,
                         const int32_t* __restrict__ y0, const int32_t* __restrict__ x0, int bh,
                         uint32_t* __restrict__ out) {
  const int i = blockIdx.x;
  const int p = blockIdx.y;
  const int planes = gridDim.y;
  const int c = threadIdx.x;
  const int a = 4 * i + c / 32;
  const uint32_t* src =
      img + p * plane_stride + static_cast<long long>(y0[a]) * wp + x0[a] + c % 32;
  uint32_t* dst = out + (static_cast<long long>(i) * planes + p) * bh * kLanes + c;
#pragma unroll 8
  for (int r = 0; r < bh; ++r) {
    dst[static_cast<long long>(r) * kLanes] = __ldg(src + static_cast<long long>(r) * wp);
  }
}

// Plane-last source (Hp, Wb, P, 128); output as the plane-first gather's.
__global__ void __launch_bounds__(kLanes)
    gather_pl_kernel(const uint32_t* __restrict__ img, int wb, const int32_t* __restrict__ y0,
                     const int32_t* __restrict__ x0, int bh, uint32_t* __restrict__ out) {
  const int a = blockIdx.x;
  const int p = blockIdx.y;
  const int planes = gridDim.y;
  const int x = x0[a] + threadIdx.x;
  const long long row_stride = static_cast<long long>(wb) * planes * kLanes;
  const uint32_t* src = img + static_cast<long long>(y0[a]) * row_stride +
                        (static_cast<long long>(x / kLanes) * planes + p) * kLanes + x % kLanes;
  uint32_t* dst = out + (static_cast<long long>(a) * planes + p) * bh * kLanes + threadIdx.x;
#pragma unroll 8
  for (int r = 0; r < bh; ++r) {
    dst[static_cast<long long>(r) * kLanes] = __ldg(src + r * row_stride);
  }
}

// The measurement probe: block k serves windows k*r .. k*r+r-1, every plane.
template <bool SINGLE>
__global__ void __launch_bounds__(kLanes)
    gather_probe_kernel(const uint32_t* __restrict__ img, int planes, long long plane_stride,
                        int wp, const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
                        int a_count, int bh, int r_windows, uint32_t* __restrict__ out) {
  const int c = threadIdx.x;
  const int first = blockIdx.x * r_windows;
  const int last = min(first + r_windows, a_count);
  for (int a = first; a < last; ++a) {
    int col = x0[a] + c;
    if (SINGLE) {
      const int xblk = min(x0[a] / kLanes, wp / kLanes - 2);
      const int shift = x0[a] - kLanes * xblk;
      col = kLanes * xblk + (c + shift) % kLanes;
    }
    for (int p = 0; p < planes; ++p) {
      const uint32_t* src = img + p * plane_stride + static_cast<long long>(y0[a]) * wp + col;
      uint32_t* dst = out + (static_cast<long long>(a) * planes + p) * bh * kLanes + c;
#pragma unroll 8
      for (int r = 0; r < bh; ++r) {
        dst[static_cast<long long>(r) * kLanes] = __ldg(src + static_cast<long long>(r) * wp);
      }
    }
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

// img (P, Hp, Wp) 4-byte elements; y0, x0 (A,) int32 on the device, A a
// multiple of 4; out (A/4, P, bh, 128).  Returns the launch error.
extern "C" int ffs_window_gather_planes_packed(const void* img, int planes, int hp, int wp,
                                               const void* y0, const void* x0, int a, int bh,
                                               void* out, void* stream) {
  if (a == 0) return 0;
  gather_packed_kernel<<<dim3(a / 4, planes), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), static_cast<long long>(hp) * wp, wp,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(x0), bh,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// img (Hp, Wb, P, 128) 4-byte elements (plane-last); out (A, P, bh, 128).
extern "C" int ffs_window_gather_planes_pl(const void* img, int hp, int wb, int planes,
                                           const void* y0, const void* x0, int a, int bh,
                                           void* out, void* stream) {
  if (a == 0) return 0;
  (void)hp;
  gather_pl_kernel<<<dim3(a, planes), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), wb, static_cast<const int32_t*>(y0),
      static_cast<const int32_t*>(x0), bh, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// img (P, Hp, Wp) 4-byte elements; out (A, P, bh, 128); `single` selects the
// one-block form, `r` the windows per block.
extern "C" int ffs_window_gather_probe(const void* img, int planes, int hp, int wp,
                                       const void* y0, const void* x0, int a, int bh,
                                       int single, int r, void* out, void* stream) {
  if (a == 0) return 0;
  const int blocks = (a + r - 1) / r;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(img);
  const auto* ys = static_cast<const int32_t*>(y0);
  const auto* xs = static_cast<const int32_t*>(x0);
  auto* dst = static_cast<uint32_t*>(out);
  const long long stride = static_cast<long long>(hp) * wp;
  if (single) {
    gather_probe_kernel<true><<<blocks, kLanes, 0, s>>>(src, planes, stride, wp, ys, xs, a, bh,
                                                        r, dst);
  } else {
    gather_probe_kernel<false><<<blocks, kLanes, 0, s>>>(src, planes, stride, wp, ys, xs, a, bh,
                                                         r, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
