// Dispersion threshold -> packed strong words, for Hopper (sm_90a).
//
// Replaces the TPU kernel ffs_tpu/ops/dispersion_pallas.py:
// _dispersion_packed_kernel (entry dispersion_packed_raw) together with its
// XLA bit pack _pack_pcw.  Output: the (B, H, 2*nwl) int32 [pc | w32] rows
// (bit t of word j = column 32j+t; pc = inclusive per-row word prefix count).
//
// What bounds it on the H100: bytes.  Per Eiger 16M u16 frame it reads the
// 36 MB frame, the 18 MB mask and the 36 MB precomputed mask box count, and
// writes 4.7 MB of words; the window arithmetic is ~50 flops per pixel, far
// below the card's ratio of flops to bytes.  The design therefore touches
// each input once from device memory: a block stages its 16 x 128 output
// tile plus the 3-pixel halo in shared memory (the halo re-reads, ~1.4x, hit
// L2), keeps the window sums in shared memory and registers, and never
// writes the dense strong plane the TPU kernel had to emit for its matmul
// pack: a warp ballots 32 predicate bits straight into one word.  The row
// prefix of word counts needs the whole row, so a second launch scans each
// row's nwl words with __popc and warp shuffles (a later change may fuse it
// by giving a block whole rows).

#include "common.cuh"

extern "C" const char* ffs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img: (B, H, W) pixels of `pixel_type` (0 uint16, 1 uint32, 2 int32); mask
// (H, W) u8; mbox (H, W) u16 or null; pcw (B, H, 2*nwl) int32.  Launches on
// `stream` and returns the first launch error (0 on success).
extern "C" int ffs_dispersion_packed(const void* img, int pixel_type, const void* mask,
                                     const void* mbox, void* pcw, int B, int H, int W,
                                     int nwl, float trusted_max, int min_count,
                                     float nsig_b, float nsig_s, int signal_test,
                                     void* stream) {
  using namespace ffs_kernels;
  const auto* msk = static_cast<const uint8_t*>(mask);
  const auto* mb = static_cast<const uint16_t*>(mbox);
  auto* out = static_cast<int32_t*>(pcw);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto pixel) {
    using T = decltype(pixel);
    if (signal_test) {
      return launch_tile<T, true, false>(img, msk, mb, out, nullptr, B, H, W, nwl,
                                         trusted_max, min_count, nsig_b, nsig_s, s);
    }
    return launch_tile<T, false, false>(img, msk, mb, out, nullptr, B, H, W, nwl,
                                        trusted_max, min_count, nsig_b, nsig_s, s);
  };
  cudaError_t err;
  switch (pixel_type) {
    case kU16: err = launch(uint16_t{}); break;
    case kU32: err = launch(uint32_t{}); break;
    case kI32: err = launch(int32_t{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_pc_scan(out, B, H, W, nwl, s));
}
