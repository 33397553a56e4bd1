// The float64 dispersion threshold of uint16 frames -> packed strong words,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's float64 threshold
// (ffs_tpu/ops/dispersion.py, dtype=float64) is XLA code, and the port ran
// it as ~70 eager PyTorch passes over 18M-pixel float64 planes an Eiger 16M
// frame (ops/dispersion.py), ~7.5 ms of device time behind the compaction's
// torch.nonzero.  It was added for the service's default step, per-frame
// float64 (SpotfindProcessor._step), which must stay bit-equal to DIALS:
// this kernel gives, bit for bit, ops.dispersion.dispersion(...,
// dtype=torch.float64) packed by ops.dispersion_packed.pack_pcw, as the
// (B, H, 2*nwl) int32 [pc | w32] rows of dispersion_packed.cu.
//
// Why its sums need no canonical tree.  For u16 pixels every window sum of
// the float64 oracle is an integer below 2^53: the 7x7 mask count m <= 49,
// x = sum(I) <= 49 * 65535 ~ 3.2e6, y = sum(I^2) <= 49 * 65535^2 ~ 2.1e11,
// and the products m*y and x*x <= 1.03e13.  Every such double add, subtract
// and multiply is exact in any order, so
//   a = m*y - x*x - x*(m-1),   b = m*I - x
// equal the oracle's whatever the association; the canonical tree order
// matters only to the float32 kernels.  So the walker keeps running window
// sums: each step adds the row entering a column's 7-row window and
// subtracts the row leaving it (x in float32, exact below 2^24; y in
// doubles), and the horizontal sums of a thread's four outputs slide the
// same way.  Only these steps round, and each is taken in the oracle's
// order with __dmul_rn and correctly rounded square roots:
//   c = (x * nsig_b) * sqrt(2(m-1))   (the root from a 64-entry table
//                                      indexed by m, each entry __dsqrt_rn)
//   d = nsig_s * __dsqrt_rn(x * m)    (x * m < 2^53: exact)
// and the comparisons a > c, b > d, I <= trusted_max, which do not round.
// The build's --fmad=false keeps any multiply and add apart besides.
//
// Its bound on the H100 is set by bytes, as kernel row 1's: the 36 MB u16
// frame and the 18 MB mask read once, 4.7 MB of words written, 0.0176 ms a
// frame.  The design is the row walker of common.cuh (walk_rows, Ring,
// store_word, walker_grid and the pc scan), the float32 walker's scaffold;
// the float64 arithmetic has its own device functions here, so the float32
// kernels compile as before.  The ring's float32 rows hold u16 pixels
// exactly.  The sliding sums cost two squares a column and row in place of
// the seven a full window sum would take, and the float64 predicate runs
// once a pixel; the signal test, with its square root, only where a column
// passed the rest.

#include "common.cuh"

namespace ffs_kernels {
namespace {

constexpr int kR = 3;  // window radius
constexpr int kRing = 2 * kR + 2;  // rows i-7 .. i: the row leaving the window is v[0]
constexpr int kPrefetch = 1;  // rows in flight ahead, as the float32 walker's

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }

// A thread's vertical 7-row sums of its four columns, kept from step to
// step: x of the masked intensities, y of their squares.
struct ColumnSums {
  float x[kCols];
  double y[kCols];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      x[j] = 0.f;
      y[j] = 0.0;
    }
  }

  // after ring.push(row i): add row i, drop row i-7 (zeros before the
  // segment's first rows, as the cleared ring)
  __device__ __forceinline__ void slide(const Ring<kRing>& ring) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float in = ring.v[kRing - 1][j], out = ring.v[0][j];
      x[j] = __fsub_rn(__fadd_rn(x[j], in), out);
      const double din = in, dout = out;
      y[j] = dsub(dadd(y[j], dmul(din, din)), dmul(dout, dout));
    }
  }
};

// Shared rows of one walker block: each thread's four vertical sums at
// slot t + kPad (zero slots on both sides), and sqrt(max(2(m-1), 0)) for
// the 7x7 mask counts m.
struct F64Shared {
  float4 x[kMaxWalkerThreads + 2 * kPad];
  double2 y01[kMaxWalkerThreads + 2 * kPad];  // columns 0, 1
  double2 y23[kMaxWalkerThreads + 2 * kPad];  // columns 2, 3
  uint32_t m[kMaxWalkerThreads + 2 * kPad];   // four byte counts
  double sqrt2m1[64];

  // before the first barrier: the zero slots and the table
  __device__ __forceinline__ void init(int t) {
    if (t < 2 * kPad) {
      const int e = t < kPad ? t : blockDim.x + t;
      x[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      y01[e] = y23[e] = make_double2(0.0, 0.0);
      m[e] = 0;
    }
    for (int k = t; k < 64; k += blockDim.x) {
      sqrt2m1[k] = __dsqrt_rn(fmax(dmul(2.0, static_cast<double>(k - 1)), 0.0));
    }
  }
};

// The first half of a step: the thread's running vertical sums and the
// 7-row mask counts of its columns (the ring's newest seven rows), written
// to its slot.
__device__ __forceinline__ void f64_vertical(const Ring<kRing>& ring, const ColumnSums& cs,
                                             F64Shared& sh, int t) {
  uint32_t cnt = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    cnt |= static_cast<uint32_t>(__popc(ring.mh[j] & 0x7fu)) << (8 * j);
  }
  sh.x[t + kPad] = make_float4(cs.x[0], cs.x[1], cs.x[2], cs.x[3]);
  sh.y01[t + kPad] = make_double2(cs.y[0], cs.y[1]);
  sh.y23[t + kPad] = make_double2(cs.y[2], cs.y[3]);
  sh.m[t + kPad] = cnt;
}

// The second half: the horizontal 7-sums of the four outputs from the
// slots of the thread and its two neighbours (columns 4t-4 .. 4t+7; output
// column 4t+j takes entries j+1 .. j+7, each sum the one before plus the
// entry entering and minus the entry leaving), then the float64 predicate
// of the four columns, whose intensities are `src` and mask bits `mrow`,
// as a nibble.
__device__ __forceinline__ uint32_t f64_horizontal(const F64Shared& sh, int t,
                                                   const float (&src)[kCols], uint32_t mrow,
                                                   double trusted_max, int min_count,
                                                   double nsig_b, double nsig_s) {
  float ax[12];
  double ay[12];
  uint32_t cw[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int e = t + kPad - 1 + s;
    f4_to(sh.x[e], ax + 4 * s);
    const double2 lo = sh.y01[e], hi = sh.y23[e];
    ay[4 * s] = lo.x;
    ay[4 * s + 1] = lo.y;
    ay[4 * s + 2] = hi.x;
    ay[4 * s + 3] = hi.y;
    cw[s] = sh.m[e];
  }
  uint32_t msum = 0;
#pragma unroll
  for (int k = 1; k <= 7; ++k) msum += bytes_at(cw, k);

  float xs = ax[1];
  double ys = ay[1];
#pragma unroll
  for (int k = 2; k <= 7; ++k) {
    xs = __fadd_rn(xs, ax[k]);
    ys = dadd(ys, ay[k]);
  }
  double xd[kCols], md[kCols];
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (j > 0) {
      xs = __fsub_rn(__fadd_rn(xs, ax[j + 7]), ax[j]);
      ys = dsub(dadd(ys, ay[j + 7]), ay[j]);
    }
    const int mi = static_cast<int>((msum >> (8 * j)) & 0xffu);
    const double x = xs, m = static_cast<double>(mi);
    // a = m*y - x*x - x*(m-1);  c = (x*nsig_b) * sqrt(2(m-1))
    const double a = dsub(dsub(dmul(m, ys), dmul(x, x)), dmul(x, dsub(m, 1.0)));
    const double c = dmul(dmul(x, nsig_b), sh.sqrt2m1[mi]);
    const bool ok = ((mrow >> j) & 1u) && static_cast<double>(src[j]) <= trusted_max &&
                    mi >= min_count && mi > 1 && a > c;
    bits |= static_cast<uint32_t>(ok) << j;
    xd[j] = x;
    md[j] = m;
  }
  if (bits != 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      // m*I - x > nsig_s * sqrt(x*m)
      const double b = dsub(dmul(md[j], static_cast<double>(src[j])), xd[j]);
      if (!(b > dmul(nsig_s, __dsqrt_rn(dmul(xd[j], md[j]))))) bits &= ~(1u << j);
    }
  }
  return bits;
}

// One strip x segment of one frame: rows y0 .. y1-1 of the strip's words.
__global__ void __launch_bounds__(kMaxWalkerThreads)
f64_threshold_walker(const uint16_t* __restrict__ img, const uint8_t* __restrict__ mask,
                     int32_t* __restrict__ pcw, int H, int W, int nwl, int wps, int seg_rows,
                     double trusted_max, int min_count, double nsig_b, double nsig_s) {
  __shared__ F64Shared sh[2];  // double-buffered: one barrier a step
  const int t = threadIdx.x;
  const int word0 = blockIdx.x * wps;
  const int x = word0 * 32 - kHaloThreads * kCols + t * kCols;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(H, y0 + seg_rows);
  const int b = blockIdx.z;
  const uint16_t* frame = img + static_cast<size_t>(b) * H * W;
  const int nw = n_words(W);
  sh[0].init(t);
  sh[1].init(t);
  // the step of row i writes the vertical sums of centre row i-3 and
  // finishes centre row i-4 from the previous step's
  Ring<kRing> ring;
  ring.clear();
  ColumnSums cs;
  cs.clear();
  walk_rows<kPrefetch>(frame, mask, x, H, W, y0 - kR, y1 + kR + 1,
                        [&](const RowIn<uint16_t>& r, int i) {
    ring.push(r);
    cs.slide(ring);
    f64_vertical(ring, cs, sh[i & 1], t);
    const int o = i - kR - 1;  // the output row
    if (o >= y0) {
      const uint32_t bits = f64_horizontal(sh[(i - 1) & 1], t, ring.v[3],
                                           ring.mask_nibble(kR + 1), trusted_max, min_count,
                                           nsig_b, nsig_s);
      store_word(bits, t, word0, nw, pcw + (static_cast<size_t>(b) * H + o) * (2 * nwl) + nwl);
    }
    __syncthreads();
  });
}

}  // namespace
}  // namespace ffs_kernels

// img: (B, H, W) uint16; mask (H, W) u8; pcw (B, H, 2*nwl) int32; wps words
// a strip and seg_rows rows a segment (ops/dispersion_packed.walker_tiling).
// Launches the walker and the row scan on `stream`; returns the first
// launch error (0 on success).
extern "C" int ffs_f64_threshold_packed(const void* img, const void* mask, void* pcw, int B,
                                        int H, int W, int nwl, int wps, int seg_rows,
                                        double trusted_max, int min_count, double nsig_b,
                                        double nsig_s, void* stream) {
  using namespace ffs_kernels;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<int32_t*>(pcw);
  dim3 grid, block;
  if (!walker_grid(B, H, W, nwl, wps, seg_rows, grid, block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  f64_threshold_walker<<<grid, block, 0, s>>>(
      static_cast<const uint16_t*>(img), static_cast<const uint8_t*>(mask), out, H, W, nwl, wps,
      seg_rows, trusted_max, min_count, nsig_b, nsig_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_pc_scan(out, B, H, W, nwl, s));
}

// Resident f64 walker blocks a multiprocessor of the current device holds
// for strips of `wps` words, or -1 on error (the wrapper's tiling).
extern "C" int ffs_f64_walker_blocks_per_sm(int wps) {
  using namespace ffs_kernels;
  if (wps < 1 || wps > kMaxStripWords) return -1;
  int n = -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, f64_threshold_walker, walker_threads(wps), 0);
  return err == cudaSuccess ? n : -1;
}
