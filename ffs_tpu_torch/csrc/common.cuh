// Shared pieces of the dispersion kernels (dispersion_packed.cu,
// dispersion_extended_packed.cu): the canonical window-sum trees, exact
// pixel widening, the row walker's loads, register ring and first pass, the
// per-row word-prefix scan and the rowcum expansion of the fused entries.
//
// Bit parity with the plain PyTorch versions (ffs_tpu_torch/ops/dispersion.py)
// rests on three rules kept here:
//   * every float add/multiply goes through the __f*_rn intrinsics, which
//     nvcc never contracts into an FMA (the build also passes --fmad=false);
//   * window sums follow the canonical subsum tree of
//     ops/dispersion._tree_window_axis, vertical first, then horizontal,
//     p(0) the top row or the left column;
//   * 32-bit pixels convert by value (__uint2float_rn / __int2float_rn),
//     never through the other signedness.
// Window sums of the 0/1 mask and background indicators are integers, exact
// in any order, so the walker counts them with __popc and integer adds.
//
// The row walker.  A block owns a strip of `wps` output words (32 columns
// each) and a segment of rows of one frame, and walks down the segment one
// image row at a time.  Each thread owns kCols = 4 adjacent columns; 8
// threads (32 columns) of halo sit on each side of the strip, so a block
// has 16 + 8*wps threads and 8 threads make one output word.  A thread keeps
// the last rows of its columns in a register ring, forms the vertical window
// trees there, writes one row of vertical sums to shared memory and, after
// one barrier, forms the horizontal trees of its four outputs from the
// sums of its own and its neighbours' columns (k + 6 values for k = 4
// outputs of a 7-wide window).  Loads run a few rows ahead of the row
// being computed, 8 bytes of u16 pixels (16 of 32-bit ones) and 4 mask
// bytes a thread and row, so the walker needs no intermediate plane in
// device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Everything has internal linkage: each .cu file that includes this header
// gets its own copy, so the shared library links without duplicate symbols.
namespace ffs_kernels {
namespace {

constexpr int kThreads = 256;  // the scan and expansion kernels
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kCols = 4;             // columns a walker thread owns
constexpr int kHaloThreads = 8;      // 32 halo columns each side of a strip
// Threads of a walker block for strips of `wps` words: 8 a word and the
// halo threads on both sides.
constexpr int walker_threads(int wps) { return 2 * kHaloThreads + 8 * wps; }
constexpr int kMaxStripWords = 30;
constexpr int kMaxWalkerThreads = walker_threads(kMaxStripWords);  // 256
constexpr int kPad = 2;              // shared rows: 2 zero slots each side

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float to_f32(uint16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(uint32_t v) { return __uint2float_rn(v); }
__device__ __forceinline__ float to_f32(int32_t v) { return __int2float_rn(v); }

// Pixel types of the C entry points' `pixel_type` argument.
enum PixelType : int { kU16 = 0, kU32 = 1, kI32 = 2 };

// k-wide window sums in the canonical tree order, p(i) = i-th term:
//   k=7:  (((p0+p1)+(p2+p3))+(p4+p5))+p6
//   k=11: ((((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)))+(p8+p9))+p10
template <typename P>
__device__ __forceinline__ float tree7(P p) {
  return fadd(fadd(fadd(fadd(p(0), p(1)), fadd(p(2), p(3))), fadd(p(4), p(5))), p(6));
}
template <typename P>
__device__ __forceinline__ float tree11(P p) {
  const float s8 = fadd(fadd(fadd(p(0), p(1)), fadd(p(2), p(3))),
                        fadd(fadd(p(4), p(5)), fadd(p(6), p(7))));
  return fadd(fadd(s8, fadd(p(8), p(9))), p(10));
}

// ---------------------------------------------------------------- loads

// Four adjacent pixels as loaded: one 8-byte word of u16, 16 bytes of u32;
// or two halves of it where a row's pitch leaves only half that alignment.
template <typename T> struct PixVec { using type = uint4; using half = uint2; };
template <> struct PixVec<uint16_t> { using type = uint2; using half = uint32_t; };

__device__ __forceinline__ uint2 join(uint32_t lo, uint32_t hi) { return make_uint2(lo, hi); }
__device__ __forceinline__ uint4 join(const uint2& lo, const uint2& hi) {
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
struct RowIn {
  typename PixVec<T>::type px;
  uint32_t mk;  // the four mask bytes
};

__device__ __forceinline__ uint32_t lane_of(const uint2& v, int j) {
  return ((j < 2 ? v.x : v.y) >> (16 * (j & 1))) & 0xffffu;
}
__device__ __forceinline__ uint32_t lane_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_lane(uint2& v, int j, uint32_t x) {
  if (j < 2) v.x |= x << (16 * (j & 1)); else v.y |= x << (16 * (j & 1));
}
__device__ __forceinline__ void set_lane(uint4& v, int j, uint32_t x) {
  if (j == 0) v.x = x; else if (j == 1) v.y = x; else if (j == 2) v.z = x; else v.w = x;
}

// Loads of a thread's columns x..x+3, row after row.  Out-of-frame pixels
// come back masked (mask 0, value 0): neither signal nor background, as the
// zero padding of ops/dispersion.box_sum treats them.  A thread whose four
// columns lie inside the frame takes one vector load each for pixels and
// mask where the row's addresses are aligned, two half-width loads where
// they are aligned to half of that (odd rows of a width that is 2 mod 4,
// as the Jungfrau's 1030), and scalar loads otherwise and at the ragged
// edges.  x is a multiple of 4, so the choice depends on the row alone and
// is uniform across the block's inner threads.
template <typename T>
struct RowLoader {
  using V = typename PixVec<T>::type;
  using Half = typename PixVec<T>::half;
  const T* __restrict__ frame;
  const uint8_t* __restrict__ mask;
  int x, H, W;
  bool inside;

  __device__ __forceinline__ RowLoader(const T* f, const uint8_t* m, int x_, int H_, int W_)
      : frame(f + x_), mask(m + x_), x(x_), H(H_), W(W_), inside(x_ >= 0 && x_ + kCols <= W_) {}

  __device__ __forceinline__ void load(int y, RowIn<T>& r) const {
    r.px = V{};
    r.mk = 0;
    if (y < 0 || y >= H) return;
    const size_t o = static_cast<size_t>(y) * W;
    const T* p = frame + o;
    const uint8_t* m = mask + o;
    const uintptr_t pa = reinterpret_cast<uintptr_t>(p), ma = reinterpret_cast<uintptr_t>(m);
    if (inside && pa % sizeof(V) == 0 && ma % 4 == 0) {
      r.px = __ldg(reinterpret_cast<const V*>(p));
      r.mk = __ldg(reinterpret_cast<const unsigned int*>(m));
    } else if (inside && pa % sizeof(Half) == 0 && ma % 2 == 0) {
      const Half* ph = reinterpret_cast<const Half*>(p);
      const unsigned short* mh = reinterpret_cast<const unsigned short*>(m);
      r.px = join(__ldg(ph), __ldg(ph + 1));
      r.mk = static_cast<uint32_t>(__ldg(mh)) | (static_cast<uint32_t>(__ldg(mh + 1)) << 16);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (x + j >= 0 && x + j < W) {
          set_lane(r.px, j, static_cast<uint32_t>(p[j]));
          r.mk |= static_cast<uint32_t>(m[j]) << (8 * j);
        }
      }
    }
    // any nonzero mask byte is valid: 0x01 in each nonzero byte
    r.mk = __vcmpne4(r.mk, 0u) & 0x01010101u;
  }
};

// ----------------------------------------------------------- the ring

// The last RING rows of a thread's four columns: v[k] is row i - (RING-1) + k
// after the push of row i, masked intensities as float32 (0 where masked);
// mh[j] holds column j's mask bits, bit k = row i - k.
template <int RING>
struct Ring {
  float v[RING][kCols];
  uint32_t mh[kCols];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < RING; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[k][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) mh[j] = 0;
  }

  template <typename T>
  __device__ __forceinline__ void push(const RowIn<T>& r) {
#pragma unroll
    for (int k = 0; k + 1 < RING; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[k][j] = v[k + 1][j];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const uint32_t mb = (r.mk >> (8 * j)) & 1u;
      v[RING - 1][j] = mb ? to_f32(static_cast<T>(lane_of(r.px, j))) : 0.f;
      mh[j] = (mh[j] << 1) | mb;
    }
  }

  // the mask bits of row i - d as a nibble (bit j = column j)
  __device__ __forceinline__ uint32_t mask_nibble(int d) const {
    uint32_t n = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) n |= ((mh[j] >> d) & 1u) << j;
    return n;
  }
};

// Shared rows of one walker block: vertical sums of each thread's four
// columns at slot t + kPad, zero slots on both sides; and the table of
// sqrt(max(2(m-1), 0)) for the 50 integer mask counts m of a 7x7 window,
// each entry the value the predicate's own __fsqrt_rn would give.
struct FirstPassShared {
  float4 x[kMaxWalkerThreads + 2 * kPad];
  float4 y[kMaxWalkerThreads + 2 * kPad];
  uint32_t m[kMaxWalkerThreads + 2 * kPad];  // four byte counts
  float sqrt2m1[64];

  // before the first barrier: the zero slots and the table
  __device__ __forceinline__ void init(int t) {
    if (t < 2 * kPad) {
      const int e = t < kPad ? t : blockDim.x + t;
      x[e] = y[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[e] = 0;
    }
    for (int k = t; k < 64; k += blockDim.x) {
      sqrt2m1[k] = __fsqrt_rn(fmaxf(fmul(2.f, fsub(static_cast<float>(k), 1.f)), 0.f));
    }
  }
};

__device__ __forceinline__ void f4_to(const float4& f, float* a) {
  a[0] = f.x; a[1] = f.y; a[2] = f.z; a[3] = f.w;
}

// Bytes s .. s+3 of the little-endian byte stream w[0], w[1], ... (s a
// compile-time constant once unrolled).  Byte j of the sum of such windows
// is a window sum of packed byte counts: no byte overflows while the sums
// stay below 256 (49 for 7x7, 121 for 11x11).
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* w, int s) {
  const int q = s >> 2, r = s & 3;
  if (r == 0) return w[q];
  return __byte_perm(w[q], w[q + 1], r | ((r + 1) << 4) | ((r + 2) << 8) | ((r + 3) << 12));
}

// The first half of the r = 3 dispersion predicate: the vertical 7-sums of
// I and I^2 (squares formed at use) and the 7-row mask count of a thread's
// four columns over the ring's newest seven rows, written to its shared
// slot.  The walkers are software-pipelined: a step writes these sums for
// its newest row and, before the same barrier, finishes the row whose sums
// the previous step wrote (first_horizontal), so the two halves' latencies
// overlap and a step needs one barrier (the shared rows are double-buffered).
template <int RING>
__device__ __forceinline__ void first_vertical(const Ring<RING>& ring, FirstPassShared& sh,
                                               int t) {
  constexpr int B0 = RING - 7;
  float vx[kCols], vy[kCols];
  uint32_t cnt = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    vx[j] = tree7([&](int k) { return ring.v[B0 + k][j]; });
    vy[j] = tree7([&](int k) {
      const float s = ring.v[B0 + k][j];
      return fmul(s, s);
    });
    cnt |= static_cast<uint32_t>(__popc(ring.mh[j] & 0x7fu)) << (8 * j);
  }
  sh.x[t + kPad] = make_float4(vx[0], vx[1], vx[2], vx[3]);
  sh.y[t + kPad] = make_float4(vy[0], vy[1], vy[2], vy[3]);
  sh.m[t + kPad] = cnt;
}

// The second half: the horizontal 7-sums from the shared slots of the
// thread and its two neighbours (three 16-byte loads a quantity; the 7x7
// counts as byte sums of four columns at once), then the predicate of the
// four columns, whose intensities are `src` and mask bits `mrow`, as a
// nibble.  The signal test, with its square root, runs only where a column
// passed the others.  SIGNAL = false gives the extended first pass.
template <bool SIGNAL>
__device__ __forceinline__ uint32_t first_horizontal(const FirstPassShared& sh, int t,
                                                     const float (&src)[kCols], uint32_t mrow,
                                                     float trusted_max, float min_count,
                                                     float nsig_b, float nsig_s) {
  // columns 4t-4 .. 4t+7 of the three neighbouring slots; output column
  // 4t+j takes entries j+1 .. j+7
  float ax[12], ay[12];
  uint32_t cw[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    f4_to(sh.x[t + kPad - 1 + s], ax + 4 * s);
    f4_to(sh.y[t + kPad - 1 + s], ay + 4 * s);
    cw[s] = sh.m[t + kPad - 1 + s];
  }
  uint32_t msum = 0;
#pragma unroll
  for (int k = 1; k <= 7; ++k) msum += bytes_at(cw, k);
  float xs[kCols], ms[kCols];
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float x = tree7([&](int k) { return ax[j + 1 + k]; });
    const float y = tree7([&](int k) { return ay[j + 1 + k]; });
    const uint32_t mi = (msum >> (8 * j)) & 0xffu;
    const float m = static_cast<float>(mi);
    const float mm1 = fsub(m, 1.f);
    // a = m*y - x*x - x*(m-1);  c = (x*nsig_b) * sqrt(max(2(m-1), 0))
    const float a = fsub(fsub(fmul(m, y), fmul(x, x)), fmul(x, mm1));
    const float cthr = fmul(fmul(x, nsig_b), sh.sqrt2m1[mi]);
    const bool ok = ((mrow >> j) & 1u) && src[j] <= trusted_max && m >= min_count &&
                    m > 1.f && a > cthr;
    bits |= static_cast<uint32_t>(ok) << j;
    xs[j] = x;
    ms[j] = m;
  }
  if constexpr (SIGNAL) {
    if (bits != 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // m*I - x > nsig_s * sqrt(x*m)
        const bool sig = fsub(fmul(ms[j], src[j]), xs[j]) >
                         fmul(nsig_s, __fsqrt_rn(fmul(xs[j], ms[j])));
        if (!sig) bits &= ~(1u << j);
      }
    }
  }
  return bits;
}

// Store a row of predicate nibbles as packed words: the eight threads of an
// output word OR their nibbles together (xor shuffles within the 8-lane
// group), and the group's first thread writes the word.  Halo threads
// (t < 8 or t >= blockDim.x - 8) take part in the shuffles only.
__device__ __forceinline__ void store_word(uint32_t nib, int t, int word0, int n_words,
                                           int32_t* __restrict__ row_words) {
  const int lane = t & 31;
  const int warp_base = t & ~31;
  const int in_warp = min(32, static_cast<int>(blockDim.x) - warp_base);
  const unsigned lanes = in_warp == 32 ? kFull : ((1u << in_warp) - 1u);
  uint32_t w = nib << (kCols * (lane & 7));
  w |= __shfl_xor_sync(lanes, w, 1);
  w |= __shfl_xor_sync(lanes, w, 2);
  w |= __shfl_xor_sync(lanes, w, 4);
  if ((lane & 7) == 0 && t >= kHaloThreads && t < static_cast<int>(blockDim.x) - kHaloThreads) {
    const int word = word0 + (t - kHaloThreads) / 8;
    if (word < n_words) row_words[word] = static_cast<int32_t>(w);
  }
}

// Walk the rows i0 .. i1-1 of a block, calling step(row_in, i) for each with
// the loads PF rows ahead.  `i` is uniform across the block, so steps may
// hold barriers.
template <int PF, typename T, typename Step>
__device__ __forceinline__ void walk_rows(const T* __restrict__ frame,
                                          const uint8_t* __restrict__ mask, int x, int H, int W,
                                          int i0, int i1, Step step) {
  const RowLoader<T> loader(frame, mask, x, H, W);
  RowIn<T> pf[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) loader.load(i0 + k < i1 ? i0 + k : -1, pf[k]);
  for (int ib = i0; ib < i1; ib += PF) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = ib + k;
      if (i >= i1) break;
      const RowIn<T> cur = pf[k];
      if (i + PF < i1) loader.load(i + PF, pf[k]);
      step(cur, i);
    }
  }
}

// ------------------------------------------------------ scan and expand

// Word-prefix scan: one warp per row of the [pc | w32] output.  Words at
// lanes >= n_written were not written by the walker (past the image's last
// word) and are zeroed here; pc carries the row total through them.
__global__ void __launch_bounds__(kThreads)
pc_scan_kernel(int32_t* __restrict__ pcw, int rows, int nwl, int n_written) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp
  int32_t* pc = pcw + static_cast<size_t>(row) * 2 * nwl;
  int32_t* words = pc + nwl;
  int carry = 0;
  for (int base = 0; base < nwl; base += 32) {
    const int j = base + lane;
    int s = 0;
    if (j < nwl) {
      if (j < n_written) {
        s = __popc(static_cast<unsigned>(words[j]));
      } else {
        words[j] = 0;
      }
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += n;
    }
    if (j < nwl) pc[j] = carry + s;
    carry += __shfl_sync(kFull, s, 31);
  }
}

// Rowcum output stage of the fused entries (ffs_dispersion_fused,
// ffs_dispersion_extended_fused): expands finished [pc | w32] rows into the
// dense per-pixel outputs of the TPU's rowcum kernels,
//   strong[32j+t] = (w_j >> t) & 1
//   rowcum[32j+t] = pc[j-1] + popc(w_j & (0xFFFFFFFF >> (31 - t)))
// (the shift runs 0..31, never 32, which would be undefined).  A thread per
// pixel and a warp per word: the warp's 32 lanes read the same word and
// prefix count (one broadcast load each) and write 128 consecutive bytes of
// rowcum and 32 of strong, so every store is coalesced.  `strong` may be
// null (emit_strong=False).
__global__ void __launch_bounds__(kThreads)
rowcum_expand_kernel(const int32_t* __restrict__ pcw, uint8_t* __restrict__ strong,
                     int32_t* __restrict__ rowcum, int W, int nwl) {
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= W) return;
  const size_t row = blockIdx.x;  // b*H + y
  const int j = col >> 5, t = col & 31;
  const int32_t* pc = pcw + row * 2 * nwl;
  const unsigned w = static_cast<unsigned>(pc[nwl + j]);
  const int before = j > 0 ? pc[j - 1] : 0;
  const size_t o = row * W + col;
  rowcum[o] = before + __popc(w & (kFull >> (31 - t)));
  if (strong != nullptr) strong[o] = static_cast<uint8_t>((w >> t) & 1u);
}

inline cudaError_t launch_rowcum_expand(const int32_t* pcw, uint8_t* strong, int32_t* rowcum,
                                        int B, int H, int W, int nwl, cudaStream_t stream) {
  const dim3 grid(B * H, (W + kThreads - 1) / kThreads);
  rowcum_expand_kernel<<<grid, kThreads, 0, stream>>>(pcw, strong, rowcum, W, nwl);
  return cudaGetLastError();
}

__host__ __device__ __forceinline__ int n_words(int W) { return (W + 31) / 32; }

// The walker's grid for strips of `wps` words and segments of `seg_rows`
// rows (ops/dispersion_packed.walker_tiling chooses both); false if the
// arguments cannot be launched.
inline bool walker_grid(int B, int H, int W, int nwl, int wps, int seg_rows, dim3& grid,
                        dim3& block) {
  if (B < 1 || H < 1 || W < 1 || wps < 1 || wps > kMaxStripWords || seg_rows < 1 ||
      n_words(W) > nwl) {
    return false;
  }
  grid = dim3((n_words(W) + wps - 1) / wps, (H + seg_rows - 1) / seg_rows, B);
  block = dim3(walker_threads(wps));
  return true;
}

inline cudaError_t launch_pc_scan(int32_t* pcw, int B, int H, int W, int nwl,
                                  cudaStream_t stream) {
  const int rows = B * H;
  pc_scan_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      pcw, rows, nwl, n_words(W));
  return cudaGetLastError();
}

}  // namespace
}  // namespace ffs_kernels
