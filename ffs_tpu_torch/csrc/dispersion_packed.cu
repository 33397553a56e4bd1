// Dispersion threshold -> packed strong words, for Hopper (sm_90a).
//
// Replaces the TPU kernel ffs_tpu/ops/dispersion_pallas.py:
// _dispersion_packed_kernel (entry dispersion_packed_raw) together with its
// XLA bit pack _pack_pcw.  Output: the (B, H, 2*nwl) int32 [pc | w32] rows
// (bit t of word j = column 32j+t; pc = inclusive per-row word prefix count).
//
// Its bound on the H100 is set by bytes.  Per Eiger 16M u16 frame it must
// read the 36 MB frame and the 18 MB mask and write 4.7 MB of words; the window
// arithmetic is ~40 flops a pixel, far below the card's ratio of flops to
// bytes.  The 7x7 mask count is an integer, so the kernel counts it from
// the mask it reads anyway (__popc of each column's mask bits, integer
// horizontal sums) and reads no precomputed count.  The design is the row
// walker of common.cuh: each input byte comes from device memory once (the
// 32-column strip halos, ~7%, come from L2), the vertical sums live in a
// register ring, and a thread forms the horizontal trees of its four
// columns from three 16-byte shared loads per quantity, so shared-memory
// traffic stays near ten accesses a pixel.  Loads run a row ahead; a
// step writes the vertical sums of its newest row and finishes the row
// before it, so one barrier a step separates them.  The variance test's
// square root depends only on the integer mask count and comes from a
// table; the signal test's runs only where a column passed the rest.  A
// warp's 8-lane groups OR their predicate nibbles into words, so no dense
// strong plane is written.  Measured on the H100 the walker is bound by
// instruction issue (about a hundred SASS instructions a pixel), not by
// its bytes.
// The row prefix of word counts needs the whole row; a second launch scans
// each row's nwl words with __popc and warp shuffles.
//
// The second entry, ffs_dispersion_fused, replaces the TPU kernel
// _dispersion_kernel (entry dispersion_fused): the same predicate, emitted as
// a dense u8 strong plane (optional) and the (B, H, W) int32 rowcum, the
// inclusive per-row prefix count of strong pixels.  It runs the two launches
// above into [pc | w32] scratch rows and then the rowcum expansion of
// common.cuh, a thread per pixel: the words hold the row's prefix at 1/32 of
// the size, and the expansion is bound by its 72 MB a frame of rowcum writes,
// which the TPU kernel had to make too.

#include "common.cuh"

// CUDA's message for `code`, or for the window-gather probe's own codes
// past 100000 (window_gather.cu): a libcuda without cuTensorMapEncodeTiled,
// or 100001 + the CUresult of a refused tensor map.
extern "C" const char* ffs_cuda_error_string(int code) {
  if (code == 100000) return "libcuda has no cuTensorMapEncodeTiled entry point";
  if (code > 100000) {
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code - 100001)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace ffs_kernels {
namespace {

constexpr int kR = 3;  // window radius
// Rows in flight ahead of the computed one.  On the H100 one row ran faster
// than four: it keeps the walker near 64-73 registers, and the extra
// resident blocks hide more latency than deeper prefetch did.
constexpr int kPrefetch = 1;

// One strip x segment of one frame: rows y0 .. y1-1 of the strip's words.
template <typename T, bool SIGNAL>
__global__ void __launch_bounds__(kMaxWalkerThreads)
dispersion_walker(const T* __restrict__ img, const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ pcw, int H, int W, int nwl, int wps, int seg_rows,
                  float trusted_max, float min_count, float nsig_b, float nsig_s) {
  __shared__ FirstPassShared sh[2];  // double-buffered: one barrier a step
  const int t = threadIdx.x;
  const int word0 = blockIdx.x * wps;
  const int x = word0 * 32 - kHaloThreads * kCols + t * kCols;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(H, y0 + seg_rows);
  const int b = blockIdx.z;
  const T* frame = img + static_cast<size_t>(b) * H * W;
  const int nw = n_words(W);
  sh[0].init(t);
  sh[1].init(t);
  // ring rows i-7 .. i: the step of row i writes the vertical sums of
  // centre row i-3 and finishes centre row i-4 from the previous step's
  Ring<2 * kR + 2> ring;
  ring.clear();
  walk_rows<kPrefetch>(frame, mask, x, H, W, y0 - kR, y1 + kR + 1,
                      [&](const RowIn<T>& r, int i) {
    ring.push(r);
    first_vertical(ring, sh[i & 1], t);
    const int o = i - kR - 1;  // the output row
    if (o >= y0) {
      const uint32_t bits = first_horizontal<SIGNAL>(sh[(i - 1) & 1], t, ring.v[3],
                                                     ring.mask_nibble(kR + 1), trusted_max,
                                                     min_count, nsig_b, nsig_s);
      store_word(bits, t, word0, nw, pcw + (static_cast<size_t>(b) * H + o) * (2 * nwl) + nwl);
    }
    __syncthreads();
  });
}

cudaError_t packed(const void* img, int pixel_type, const uint8_t* mask, int32_t* out, int B,
                   int H, int W, int nwl, int wps, int seg_rows, float trusted_max,
                   int min_count, float nsig_b, float nsig_s, int signal_test, cudaStream_t s) {
  dim3 grid, block;
  if (!walker_grid(B, H, W, nwl, wps, seg_rows, grid, block)) return cudaErrorInvalidValue;
  const float mc = static_cast<float>(min_count);
  auto launch = [&](auto pixel) {
    using T = decltype(pixel);
    const T* frames = static_cast<const T*>(img);
    if (signal_test) {
      dispersion_walker<T, true><<<grid, block, 0, s>>>(
          frames, mask, out, H, W, nwl, wps, seg_rows, trusted_max, mc, nsig_b, nsig_s);
    } else {
      dispersion_walker<T, false><<<grid, block, 0, s>>>(
          frames, mask, out, H, W, nwl, wps, seg_rows, trusted_max, mc, nsig_b, nsig_s);
    }
    return cudaGetLastError();
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
}  // namespace ffs_kernels

// img: (B, H, W) pixels of `pixel_type` (0 uint16, 1 uint32, 2 int32); mask
// (H, W) u8; pcw (B, H, 2*nwl) int32; wps words a strip and seg_rows rows a
// segment (ops/dispersion_packed.walker_tiling).  Launches on `stream` and
// returns the first launch error (0 on success).
extern "C" int ffs_dispersion_packed(const void* img, int pixel_type, const void* mask,
                                     void* pcw, int B, int H, int W, int nwl, int wps,
                                     int seg_rows, float trusted_max, int min_count,
                                     float nsig_b, float nsig_s, int signal_test,
                                     void* stream) {
  return static_cast<int>(ffs_kernels::packed(
      img, pixel_type, static_cast<const uint8_t*>(mask), static_cast<int32_t*>(pcw), B, H, W,
      nwl, wps, seg_rows, trusted_max, min_count, nsig_b, nsig_s, signal_test,
      static_cast<cudaStream_t>(stream)));
}

// As ffs_dispersion_packed, with pcw as (B, H, 2*nwl) int32 scratch, then the
// dense outputs: strong (B, H, W) u8 or null, rowcum (B, H, W) int32.
extern "C" int ffs_dispersion_fused(const void* img, int pixel_type, const void* mask,
                                    void* pcw, void* strong, void* rowcum, int B, int H, int W,
                                    int nwl, int wps, int seg_rows, float trusted_max,
                                    int min_count, float nsig_b, float nsig_s, int signal_test,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<int32_t*>(pcw);
  const int rc = ffs_dispersion_packed(img, pixel_type, mask, pcw, B, H, W, nwl, wps, seg_rows,
                                       trusted_max, min_count, nsig_b, nsig_s, signal_test,
                                       stream);
  if (rc != 0) return rc;
  return static_cast<int>(ffs_kernels::launch_rowcum_expand(
      words, static_cast<uint8_t*>(strong), static_cast<int32_t*>(rowcum), B, H, W, nwl, s));
}

// The widest strip a walker block takes, in 32-column words: the wrapper
// splits a frame's words into strips of at most this many.
extern "C" int ffs_walker_max_strip_words() { return ffs_kernels::kMaxStripWords; }

// Resident dispersion walker blocks a multiprocessor of the current device
// holds for strips of `wps` words (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 on error; the wrapper's tiling fills the card with that many a SM.
extern "C" int ffs_dispersion_walker_blocks_per_sm(int pixel_type, int signal_test, int wps) {
  using namespace ffs_kernels;
  if (wps < 1 || wps > kMaxStripWords) return -1;
  int n = -1;
  auto query = [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, walker_threads(wps), 0);
  };
  cudaError_t err;
  const bool sig = signal_test != 0;
  switch (pixel_type) {
    case kU16: err = sig ? query(dispersion_walker<uint16_t, true>)
                         : query(dispersion_walker<uint16_t, false>); break;
    case kU32: err = sig ? query(dispersion_walker<uint32_t, true>)
                         : query(dispersion_walker<uint32_t, false>); break;
    case kI32: err = sig ? query(dispersion_walker<int32_t, true>)
                         : query(dispersion_walker<int32_t, false>); break;
    default: return -1;
  }
  return err == cudaSuccess ? n : -1;
}
