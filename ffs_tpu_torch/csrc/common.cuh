// Shared pieces of the dispersion kernels (dispersion_packed.cu,
// dispersion_extended_packed.cu): tile geometry, the canonical window-sum
// trees, exact pixel widening, the first-pass tile kernel, the per-row
// word-prefix scan and the rowcum expansion of the fused entries.
//
// Bit parity with the plain PyTorch versions (ffs_tpu_torch/ops/dispersion.py)
// rests on three rules kept here:
//   * every float add/multiply goes through the __f*_rn intrinsics, which
//     nvcc never contracts into an FMA (the build also passes --fmad=false);
//   * window sums follow the canonical subsum tree of
//     ops/dispersion._tree_window_axis, vertical first, then horizontal;
//   * 32-bit pixels convert by value (__uint2float_rn / __int2float_rn),
//     never through the other signedness.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Everything has internal linkage: each .cu file that includes this header
// gets its own copy, so the shared library links without duplicate symbols.
namespace ffs_kernels {
namespace {

constexpr int kTileW = 128;  // output columns per block: 4 packed words
constexpr int kTileH = 16;   // output rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerTile = kTileW / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Dispersion predicate over one kTileH x kTileW output tile (r = 3).
//
// The block stages the masked f32 intensities and the mask of its tile plus
// a 3-pixel halo (zero outside the frame), forms the vertical 7-sums of I,
// I^2 (and the mask, when no precomputed box count is given) for every halo
// column, then each warp takes (row, 32-column word) tasks: lane t evaluates
// column 32j+t from seven vertical sums and the warp ballots the word.
//   SIGNAL = false gives the extended algorithm's first pass.
//   DENSE  = true writes a u8 plane (extended first pass) instead of words.
template <typename T, bool HAS_MBOX, bool SIGNAL, bool DENSE>
__global__ void __launch_bounds__(kThreads)
dispersion_tile_kernel(const T* __restrict__ img, const uint8_t* __restrict__ mask,
                       const uint16_t* __restrict__ mbox, int32_t* __restrict__ pcw,
                       uint8_t* __restrict__ dense, int H, int W, int nwl,
                       float trusted_max, float min_count, float nsig_b, float nsig_s) {
  constexpr int R = 3;
  constexpr int SW = kTileW + 2 * R;
  constexpr int SH = kTileH + 2 * R;
  __shared__ float s_img[SH][SW];
  __shared__ uint8_t s_msk[SH][SW];
  __shared__ float v_x[kTileH][SW];
  __shared__ float v_y[kTileH][SW];
  __shared__ float v_m[HAS_MBOX ? 1 : kTileH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const T* frame = img + static_cast<size_t>(b) * H * W;

  for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - R + r, gx = x0 - R + c;
    float v = 0.f;
    uint8_t mk = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = static_cast<size_t>(gy) * W + gx;
      mk = mask[o] != 0;
      if (mk) v = to_f32(frame[o]);
    }
    s_img[r][c] = v;
    s_msk[r][c] = mk;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * SW; i += kThreads) {
    const int r = i / SW, c = i % SW;
    v_x[r][c] = tree7([&](int k) { return s_img[r + k][c]; });
    v_y[r][c] = tree7([&](int k) {
      const float s = s_img[r + k][c];
      return fmul(s, s);
    });
    if constexpr (!HAS_MBOX) v_m[r][c] = tree7([&](int k) { return static_cast<float>(s_msk[r + k][c]); });
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTileH * kWordsPerTile; t += kWarps) {
    const int r = t / kWordsPerTile, wd = t % kWordsPerTile;
    const int c = wd * 32 + lane;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H) continue;  // uniform across the warp
    bool ok = false;
    if (gx < W) {
      const float x = tree7([&](int k) { return v_x[r][c + k]; });
      const float y = tree7([&](int k) { return v_y[r][c + k]; });
      float m;
      if constexpr (HAS_MBOX) {
        m = static_cast<float>(mbox[static_cast<size_t>(gy) * W + gx]);
      } else {
        m = tree7([&](int k) { return v_m[r][c + k]; });
      }
      const float src = s_img[r + R][c + R];
      const float mm1 = fsub(m, 1.f);
      // a = m*y - x*x - x*(m-1);  c = (x*nsig_b) * sqrt(max(2(m-1), 0))
      const float a = fsub(fsub(fmul(m, y), fmul(x, x)), fmul(x, mm1));
      const float cthr = fmul(fmul(x, nsig_b), __fsqrt_rn(fmaxf(fmul(2.f, mm1), 0.f)));
      ok = s_msk[r + R][c + R] && src <= trusted_max && m >= min_count && m > 1.f && a > cthr;
      if constexpr (SIGNAL) {
        // m*I - x > nsig_s * sqrt(x*m)
        ok = ok && fsub(fmul(m, src), x) > fmul(nsig_s, __fsqrt_rn(fmul(x, m)));
      }
    }
    if constexpr (DENSE) {
      if (gx < W) dense[(static_cast<size_t>(b) * H + gy) * W + gx] = ok;
    } else {
      const unsigned word = __ballot_sync(kFull, ok);
      if (lane == 0) {
        pcw[(static_cast<size_t>(b) * H + gy) * (2 * nwl) + nwl + x0 / 32 + wd] =
            static_cast<int32_t>(word);
      }
    }
  }
}

// Word-prefix scan: one warp per row of the [pc | w32] output.  Words at
// lanes >= n_written were not written by the tile kernel (past the image's
// last tile) and are zeroed here; pc carries the row total through them.
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

inline dim3 tile_grid(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

inline int words_written(int W) { return ((W + kTileW - 1) / kTileW) * kWordsPerTile; }

inline cudaError_t launch_pc_scan(int32_t* pcw, int B, int H, int W, int nwl,
                                  cudaStream_t stream) {
  const int rows = B * H;
  pc_scan_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      pcw, rows, nwl, words_written(W));
  return cudaGetLastError();
}

// Launch the first-pass/dispersion tile kernel for one (pixel type, mbox,
// signal test, output form) combination.
template <typename T, bool SIGNAL, bool DENSE>
cudaError_t launch_tile(const void* img, const uint8_t* mask, const uint16_t* mbox,
                        int32_t* pcw, uint8_t* dense, int B, int H, int W, int nwl,
                        float trusted_max, int min_count, float nsig_b, float nsig_s,
                        cudaStream_t stream) {
  const dim3 grid = tile_grid(B, H, W);
  const T* frames = static_cast<const T*>(img);
  const float mc = static_cast<float>(min_count);
  if (mbox != nullptr) {
    dispersion_tile_kernel<T, true, SIGNAL, DENSE><<<grid, kThreads, 0, stream>>>(
        frames, mask, mbox, pcw, dense, H, W, nwl, trusted_max, mc, nsig_b, nsig_s);
  } else {
    dispersion_tile_kernel<T, false, SIGNAL, DENSE><<<grid, kThreads, 0, stream>>>(
        frames, mask, mbox, pcw, dense, H, W, nwl, trusted_max, mc, nsig_b, nsig_s);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ffs_kernels
