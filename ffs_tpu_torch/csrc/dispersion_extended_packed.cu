// Extended (erosion) dispersion -> packed strong words, for Hopper (sm_90a).
//
// Replaces the TPU kernel ffs_tpu/ops/dispersion_extended_pallas.py:
// _ext_kernel in packed mode (entry dispersion_extended_packed_raw) together
// with the XLA bit pack _pack_pcw.  Same [pc | w32] output as
// dispersion_packed.cu, with nwl taken from pad128(W + 20).  The stages:
//   1. first pass: the r=3 background test (dispersion predicate without the
//      signal test);
//   2. erosion: a first-pass pixel survives iff no valid background pixel
//      (mask && !first) lies within Chebyshev distance 2;
//   3. second pass: the 11x11 background (mask && !survived) count n and
//      intensity sum x; strong iff mask, I <= trusted_max, n > 0, survived,
//      I > 0 and I >= mean + nsig_s*sqrt(mean), mean = n > 1 ? x/n : 0 (the
//      reference's n > 1 quirk) -> words.
//
// Its bound on the H100 is set by bytes, the same 59 MB an Eiger 16M u16
// frame as dispersion_packed.cu (frame, mask, words), if no stage's
// intermediate reaches device memory.  So all three stages run in one
// launch, in the row walker of common.cuh, with a 10-pixel halo (3 + 2 + 5)
// and nothing of theirs in device memory.  Walking down its segment, a
// thread pushes image row i into an 8-row register ring of its four
// columns (the first pass reads the newest seven); the row leaving the
// ring goes to the thread's own slots of a 16-row shared-memory ring, from
// which the second pass reads its 11 rows back.  The step is
// software-pipelined: each stage writes its shared row of vertical sums for
// the next step and finishes the row whose sums the previous step wrote,
// so one barrier a step separates all three (double-buffered) and the
// stages' latencies overlap.  Step i finishes
//   * first-pass row i-4 (common.cuh first_vertical / first_horizontal);
//   * erosion row i-7: the background bits of five first-pass rows, ORed
//     as nibbles, then across the +-2 neighbouring columns from one shared
//     word of each neighbour;
//   * second-pass row i-13: the 11-row background count is a __popc of each
//     column's background bits and the horizontal count a byte sum (exact
//     in any order); only the background intensity sum x needs the
//     canonical tree11, vertical over the shared ring's rows i-17 .. i-7,
//     horizontal from five 16-byte shared loads for four outputs, and only
//     where a column can pass, as are the mean and its square root.
// The 7x7 mask count comes from the mask bits, so no precomputed count is
// read.  A second launch scans the words into pc.  Measured on the H100 the
// walker is bound by instruction issue, not bytes.  Registers set its
// occupancy: an 18-row register ring took 246-250 registers and one block
// a multiprocessor; the shared ring (64 KB a block) leaves 128 registers
// and two blocks, and ran faster.
//
// The second entry, ffs_dispersion_extended_fused, replaces the TPU kernel
// _ext_kernel in rowcum mode (entry dispersion_extended_fused): the same
// stages into [pc | w32] scratch rows, then the rowcum expansion of
// common.cuh (see dispersion_packed.cu).  Outputs: a dense u8 strong plane
// (optional) and the (B, H, W) int32 inclusive per-row prefix count.

#include "common.cuh"

namespace ffs_kernels {
namespace {

constexpr int kHalo = 10;  // first-pass radius 3 + erosion 2 + second-pass radius 5
constexpr int kRing = 8;   // image rows i-7 .. i in registers
constexpr int kSlots = 16;  // image rows i-22 .. i-7 in the shared ring (a power of 2)
// Rows in flight ahead of the computed one.  On the H100 two rows fit the
// walker in 128 registers without spills (two blocks a multiprocessor);
// four spilled and one was slower.
constexpr int kPrefetch = 2;

// Dynamic shared memory of a block of `threads`: the shared ring of image
// rows, one float4 (four columns) a thread and row.
inline size_t ring_bytes(int threads) {
  return static_cast<size_t>(kSlots) * threads * sizeof(float4);
}

// Each stage's shared row, double-buffered (one barrier a step).
struct ExtendedShared {
  FirstPassShared first[2];
  uint32_t er[2][kMaxWalkerThreads + 2 * kPad];  // background nibble ORed over 5 rows
  float4 x2[2][kMaxWalkerThreads + 2 * kPad];    // vertical 11-sums of background I
  uint32_t n2[2][kMaxWalkerThreads + 2 * kPad];  // vertical 11-counts, four bytes
};

// Two blocks a multiprocessor: 128 registers a thread at most.
template <typename T>
__global__ void __launch_bounds__(kMaxWalkerThreads, 2)
extended_walker(const T* __restrict__ img, const uint8_t* __restrict__ mask,
                int32_t* __restrict__ pcw, int H, int W, int nwl, int wps, int seg_rows,
                float trusted_max, float min_count, float nsig_b, float nsig_s) {
  __shared__ ExtendedShared sh;
  extern __shared__ float4 rows[];  // [kSlots][blockDim.x]: row r at slot r & 15
  const int t = threadIdx.x;
  const int word0 = blockIdx.x * wps;
  const int x = word0 * 32 - kHaloThreads * kCols + t * kCols;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(H, y0 + seg_rows);
  const int b = blockIdx.z;
  const T* frame = img + static_cast<size_t>(b) * H * W;
  const int nw = n_words(W);
  if (t < 2 * kPad) {  // the zero slots beside the stages' shared rows
    const int e = t < kPad ? t : blockDim.x + t;
    for (int q = 0; q < 2; ++q) {
      sh.x2[q][e] = make_float4(0.f, 0.f, 0.f, 0.f);
      sh.er[q][e] = sh.n2[q][e] = 0;
    }
  }
  // the walk's first step finishes a first-pass row from sums no step has
  // written: start them at zero (a mask count of 0 fails the test)
  for (int q = 0; q < 2; ++q) {
    sh.first[q].init(t);
    sh.first[q].x[t + kPad] = sh.first[q].y[t + kPad] = make_float4(0.f, 0.f, 0.f, 0.f);
    sh.first[q].m[t + kPad] = 0;
  }
  __syncthreads();
  Ring<kRing> ring;  // v[k] = row i-7+k
  ring.clear();
  uint32_t bg1h = 0;  // first-pass background nibbles, rows f-4 .. f (f = i-4)
  uint32_t fh = 0;    // first-pass nibbles, rows f-3 .. f
  uint32_t svh = 0;   // survived nibbles, rows e-6 .. e (e = i-7)
  uint32_t bg2h[kCols] = {0, 0, 0, 0};  // column j's background bits, bit k = row e-k

  // The step of image row i: each stage finishes the row whose shared sums
  // the previous step wrote and writes its own for the next step.
  walk_rows<kPrefetch>(frame, mask, x, H, W, y0 - kHalo, y1 + kHalo + 3,
                      [&](const RowIn<T>& r, int i) {
    const int q = i & 1, p = q ^ 1;
    ring.push(r);
    // row i-7 leaves the register ring for the thread's own shared slots,
    // where the second pass reads it back (no other thread does: no barrier)
    rows[((i - 7) & (kSlots - 1)) * blockDim.x + t] =
        make_float4(ring.v[0][0], ring.v[0][1], ring.v[0][2], ring.v[0][3]);
    // 1. first pass: vertical sums of centre row i-3; row f = i-4 finished
    first_vertical(ring, sh.first[q], t);
    const float (&src_f)[kCols] = ring.v[3];
    const uint32_t first = first_horizontal<false>(sh.first[p], t, src_f, ring.mask_nibble(4),
                                                   trusted_max, min_count, nsig_b, 0.f);
    bg1h = ((bg1h << 4) | (ring.mask_nibble(4) & ~first)) & 0xfffffu;
    fh = ((fh << 4) | first) & 0xffffu;
    // 2. erosion: no background within rows i-8..i-4 (OR of the five
    // nibbles, centre i-6) for the next step; row e = i-7 finished from the
    // previous step's, within columns -2..+2 (the neighbours' nibbles)
    sh.er[q][t + kPad] = (bg1h | (bg1h >> 4) | (bg1h >> 8) | (bg1h >> 12) | (bg1h >> 16)) & 0xfu;
    const uint32_t nbr = sh.er[p][t + kPad - 1] | (sh.er[p][t + kPad] << 4) |
                         (sh.er[p][t + kPad + 1] << 8);
    uint32_t surv = (fh >> 12) & 0xfu;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if ((nbr >> (2 + j)) & 0x1fu) surv &= ~(1u << j);
    }
    svh = ((svh << 4) | surv) & 0xfffffffu;
    // 3. second pass: vertical sums over image rows e-10 .. e (the shared
    // ring's rows i-17 .. i-7, centre e-5 = i-12); row o = i-13 finished
    // from the previous step's
    const uint32_t bg2 = ring.mask_nibble(7) & ~surv;
    float v2[11][kCols];
#pragma unroll
    for (int k = 0; k < 11; ++k) {
      f4_to(rows[((i - 17 + k) & (kSlots - 1)) * blockDim.x + t], v2[k]);
    }
    float vx[kCols];
    uint32_t cnt = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      bg2h[j] = ((bg2h[j] << 1) | ((bg2 >> j) & 1u)) & 0x7ffu;
      const uint32_t bits = bg2h[j];
      vx[j] = tree11([&](int k) { return ((bits >> (10 - k)) & 1u) ? v2[k][j] : 0.f; });
      cnt |= static_cast<uint32_t>(__popc(bits)) << (8 * j);
    }
    sh.x2[q][t + kPad] = make_float4(vx[0], vx[1], vx[2], vx[3]);
    sh.n2[q][t + kPad] = cnt;
    const int o = i - kHalo - 3;
    if (o >= y0) {  // uniform: not a warm-up step
      // columns 4t-8 .. 4t+11 of the five neighbouring slots; output
      // column 4t+j takes entries j+3 .. j+13.  The count first (byte
      // sums); the intensity tree, mean and square root only where a
      // column can pass.
      uint32_t cw[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) cw[s] = sh.n2[p][t + kPad - 2 + s];
      uint32_t nsum = 0;
#pragma unroll
      for (int k = 3; k <= 13; ++k) nsum += bytes_at(cw, k);
      uint32_t strong = (svh >> 24) & ring.mask_nibble(13);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float src = v2[4][j];
        if (!(src <= trusted_max && ((nsum >> (8 * j)) & 0xffu) > 0 && src > 0.f)) {
          strong &= ~(1u << j);
        }
      }
      if (strong != 0) {
        float ax[20];
#pragma unroll
        for (int s = 0; s < 5; ++s) f4_to(sh.x2[p][t + kPad - 2 + s], ax + 4 * s);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float xs = tree11([&](int k) { return ax[j + 3 + k]; });
          const float n = static_cast<float>((nsum >> (8 * j)) & 0xffu);
          const float src = v2[4][j];
          const float mean = n > 1.f ? __fdiv_rn(xs, fmaxf(n, 1.f)) : 0.f;
          if (!(src >= fadd(mean, fmul(nsig_s, __fsqrt_rn(mean))))) strong &= ~(1u << j);
        }
      }
      store_word(strong, t, word0, nw, pcw + (static_cast<size_t>(b) * H + o) * (2 * nwl) + nwl);
    }
    __syncthreads();
  });
}

cudaError_t extended(const void* img, int pixel_type, const uint8_t* mask, int32_t* out, int B,
                     int H, int W, int nwl, int wps, int seg_rows, float trusted_max,
                     int min_count, float nsig_b, float nsig_s, cudaStream_t s) {
  dim3 grid, block;
  if (!walker_grid(B, H, W, nwl, wps, seg_rows, grid, block)) return cudaErrorInvalidValue;
  const float mc = static_cast<float>(min_count);
  auto launch = [&](auto pixel) {
    using T = decltype(pixel);
    // the shared ring takes the block past 48 KB: opt in on the current
    // device (the attribute is per device, and cheap to set every launch)
    const cudaError_t opt_in = cudaFuncSetAttribute(
        extended_walker<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring_bytes(kMaxWalkerThreads)));
    if (opt_in != cudaSuccess) return opt_in;
    extended_walker<T><<<grid, block, ring_bytes(block.x), s>>>(
        static_cast<const T*>(img), mask, out, H, W, nwl, wps, seg_rows, trusted_max, mc,
        nsig_b, nsig_s);
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
extern "C" int ffs_dispersion_extended_packed(const void* img, int pixel_type, const void* mask,
                                              void* pcw, int B, int H, int W, int nwl, int wps,
                                              int seg_rows, float trusted_max, int min_count,
                                              float nsig_b, float nsig_s, void* stream) {
  return static_cast<int>(ffs_kernels::extended(
      img, pixel_type, static_cast<const uint8_t*>(mask), static_cast<int32_t*>(pcw), B, H, W,
      nwl, wps, seg_rows, trusted_max, min_count, nsig_b, nsig_s,
      static_cast<cudaStream_t>(stream)));
}

// As ffs_dispersion_extended_packed, with pcw as (B, H, 2*nwl) int32 scratch,
// then the dense outputs: strong (B, H, W) u8 or null, rowcum (B, H, W) int32.
extern "C" int ffs_dispersion_extended_fused(const void* img, int pixel_type, const void* mask,
                                             void* pcw, void* strong, void* rowcum, int B,
                                             int H, int W, int nwl, int wps, int seg_rows,
                                             float trusted_max, int min_count, float nsig_b,
                                             float nsig_s, void* stream) {
  const int rc = ffs_dispersion_extended_packed(img, pixel_type, mask, pcw, B, H, W, nwl, wps,
                                                seg_rows, trusted_max, min_count, nsig_b,
                                                nsig_s, stream);
  if (rc != 0) return rc;
  return static_cast<int>(ffs_kernels::launch_rowcum_expand(
      static_cast<const int32_t*>(pcw), static_cast<uint8_t*>(strong),
      static_cast<int32_t*>(rowcum), B, H, W, nwl, static_cast<cudaStream_t>(stream)));
}

// Resident extended walker blocks a multiprocessor of the current device
// holds for strips of `wps` words, or -1 on error (see
// ffs_dispersion_walker_blocks_per_sm).
extern "C" int ffs_extended_walker_blocks_per_sm(int pixel_type, int wps) {
  using namespace ffs_kernels;
  if (wps < 1 || wps > kMaxStripWords) return -1;
  const int threads = walker_threads(wps);
  int n = -1;
  auto query = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(ring_bytes(kMaxWalkerThreads)));
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                         ring_bytes(threads));
  };
  cudaError_t err;
  switch (pixel_type) {
    case kU16: err = query(extended_walker<uint16_t>); break;
    case kU32: err = query(extended_walker<uint32_t>); break;
    case kI32: err = query(extended_walker<int32_t>); break;
    default: return -1;
  }
  return err == cudaSuccess ? n : -1;
}
