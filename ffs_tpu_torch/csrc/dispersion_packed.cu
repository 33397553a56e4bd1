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
//
// The second entry, ffs_dispersion_fused, replaces the TPU kernel
// _dispersion_kernel (entry dispersion_fused): the same predicate, emitted as
// a dense u8 strong plane (optional) and the (B, H, W) int32 rowcum, the
// inclusive per-row prefix count of strong pixels.  It runs the two launches
// above into [pc | w32] scratch rows and then the rowcum expansion of
// common.cuh, a thread per pixel.  Folding the prefix into the tile kernel
// was the alternative; it was not taken because a 128-column tile does not
// own its row's prefix (a third pass over the dense rowcum would be needed),
// while the words hold the row's prefix at 1/32 of the size: the expansion
// reads 4.7 MB of words and pc a frame and writes 72 MB of rowcum (plus 18
// MB of strong), so it is bound by its writes, which the TPU kernel had to
// make too.  The predicate stays in one place for the packed and rowcum
// entries, as the TPU kernels shared _dispersion_predicate.

#include "common.cuh"

extern "C" const char* ffs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

cudaError_t packed(const void* img, int pixel_type, const uint8_t* mask, const uint16_t* mbox,
                   int32_t* out, int B, int H, int W, int nwl, float trusted_max, int min_count,
                   float nsig_b, float nsig_s, int signal_test, cudaStream_t s) {
  using namespace ffs_kernels;
  auto launch = [&](auto pixel) {
    using T = decltype(pixel);
    if (signal_test) {
      return launch_tile<T, true, false>(img, mask, mbox, out, nullptr, B, H, W, nwl,
                                         trusted_max, min_count, nsig_b, nsig_s, s);
    }
    return launch_tile<T, false, false>(img, mask, mbox, out, nullptr, B, H, W, nwl,
                                        trusted_max, min_count, nsig_b, nsig_s, s);
  };
  cudaError_t err;
  switch (pixel_type) {
    case kU16: err = launch(uint16_t{}); break;
    case kU32: err = launch(uint32_t{}); break;
    case kI32: err = launch(int32_t{}); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_pc_scan(out, B, H, W, nwl, s);
}

}  // namespace

// img: (B, H, W) pixels of `pixel_type` (0 uint16, 1 uint32, 2 int32); mask
// (H, W) u8; mbox (H, W) u16 or null; pcw (B, H, 2*nwl) int32.  Launches on
// `stream` and returns the first launch error (0 on success).
extern "C" int ffs_dispersion_packed(const void* img, int pixel_type, const void* mask,
                                     const void* mbox, void* pcw, int B, int H, int W,
                                     int nwl, float trusted_max, int min_count,
                                     float nsig_b, float nsig_s, int signal_test,
                                     void* stream) {
  return static_cast<int>(packed(img, pixel_type, static_cast<const uint8_t*>(mask),
                                 static_cast<const uint16_t*>(mbox), static_cast<int32_t*>(pcw),
                                 B, H, W, nwl, trusted_max, min_count, nsig_b, nsig_s,
                                 signal_test, static_cast<cudaStream_t>(stream)));
}

// As ffs_dispersion_packed, with pcw as (B, H, 2*nwl) int32 scratch, then the
// dense outputs: strong (B, H, W) u8 or null, rowcum (B, H, W) int32.
extern "C" int ffs_dispersion_fused(const void* img, int pixel_type, const void* mask,
                                    const void* mbox, void* pcw, void* strong, void* rowcum,
                                    int B, int H, int W, int nwl, float trusted_max,
                                    int min_count, float nsig_b, float nsig_s, int signal_test,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<int32_t*>(pcw);
  cudaError_t err = packed(img, pixel_type, static_cast<const uint8_t*>(mask),
                           static_cast<const uint16_t*>(mbox), words, B, H, W, nwl,
                           trusted_max, min_count, nsig_b, nsig_s, signal_test, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(ffs_kernels::launch_rowcum_expand(
      words, static_cast<uint8_t*>(strong), static_cast<int32_t*>(rowcum), B, H, W, nwl, s));
}
