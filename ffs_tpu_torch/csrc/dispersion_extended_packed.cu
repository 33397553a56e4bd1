// Extended (erosion) dispersion -> packed strong words, for Hopper (sm_90a).
//
// Replaces the TPU kernel ffs_tpu/ops/dispersion_extended_pallas.py:
// _ext_kernel in packed mode (entry dispersion_extended_packed_raw) together
// with the XLA bit pack _pack_pcw.  Same [pc | w32] output as
// dispersion_packed.cu, with nwl taken from pad128(W + 20).
//
// The three stages run as three launches here, each a tile kernel in the
// shape of dispersion_packed.cu, followed by the shared word-prefix scan:
//   1. first pass: the r=3 background test (dispersion predicate without the
//      signal test) -> u8 plane `first`;
//   2. erosion: a first-pass pixel survives iff no valid background pixel
//      (mask && !first) lies within Chebyshev distance 2 -> u8 `survived`;
//   3. second pass: the 11x11 background (mask && !survived) count n and
//      intensity sum x; strong iff mask, I <= trusted_max, n > 0, survived,
//      I > 0 and I >= mean + nsig_s*sqrt(mean), mean = n > 1 ? x/n : 0 (the
//      reference's n > 1 quirk) -> words by warp ballot.
//
// What bounds it on the H100: bytes.  Each stage reads the frame or its u8
// planes once from device memory (halos hit L2); the two u8 intermediate
// planes cost 4 x 18 MB of traffic per Eiger-16M-sized frame that the TPU
// kernel kept in VMEM.  Fusing the stages into one launch with a 10-pixel
// image halo removes that traffic and is left to a later change.
//
// The second entry, ffs_dispersion_extended_fused, replaces the TPU kernel
// _ext_kernel in rowcum mode (entry dispersion_extended_fused): the same
// stages into [pc | w32] scratch rows, then the rowcum expansion of
// common.cuh (see dispersion_packed.cu for why the prefix is taken from the
// words rather than folded into a tile kernel).  Outputs: a dense u8 strong
// plane (optional) and the (B, H, W) int32 inclusive per-row prefix count.

#include "common.cuh"

namespace ffs_kernels {
namespace {

constexpr int kErode = 2;  // erosion Chebyshev distance
constexpr int kR2 = 5;     // second-pass radius

__global__ void __launch_bounds__(kThreads)
erode_kernel(const uint8_t* __restrict__ first, const uint8_t* __restrict__ mask,
             uint8_t* __restrict__ survived, int B, int H, int W) {
  const size_t n = static_cast<size_t>(B) * H * W;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    uint8_t keep = first[i];
    if (keep) {
      const size_t plane = (i / (static_cast<size_t>(H) * W)) * H * W;
      const int y = static_cast<int>((i / W) % H), x = static_cast<int>(i % W);
      for (int dy = -kErode; dy <= kErode && keep; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -kErode; dx <= kErode; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          const size_t o = static_cast<size_t>(yy) * W + xx;
          if (mask[o] && !first[plane + o]) {
            keep = 0;
            break;
          }
        }
      }
    }
    survived[i] = keep;
  }
}

// Second pass over one kTileH x kTileW tile: stage the background
// indicator and background intensities with a 5-pixel halo, vertical
// 11-sums per halo column, then per (row, word) warp task the horizontal
// 11-sums, the predicate and the ballot.  The count grid is integer-valued
// (exact in any order); the intensity grid rounds for u32 data, so it keeps
// the canonical tree order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
second_pass_kernel(const T* __restrict__ img, const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ survived, int32_t* __restrict__ pcw,
                   int H, int W, int nwl, float trusted_max, float nsig_s) {
  constexpr int SW = kTileW + 2 * kR2;
  constexpr int SH = kTileH + 2 * kR2;
  __shared__ float s_bgi[SH][SW];
  __shared__ uint8_t s_bg[SH][SW];
  __shared__ float v_x[kTileH][SW];
  __shared__ float v_n[kTileH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(b) * H * W;
  const T* frame = img + plane;
  const uint8_t* surv = survived + plane;

  for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - kR2 + r, gx = x0 - kR2 + c;
    float v = 0.f;
    uint8_t bg = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = static_cast<size_t>(gy) * W + gx;
      bg = mask[o] != 0 && !surv[o];
      if (bg) v = to_f32(frame[o]);
    }
    s_bgi[r][c] = v;
    s_bg[r][c] = bg;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * SW; i += kThreads) {
    const int r = i / SW, c = i % SW;
    v_x[r][c] = tree11([&](int k) { return s_bgi[r + k][c]; });
    v_n[r][c] = tree11([&](int k) { return static_cast<float>(s_bg[r + k][c]); });
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
      const size_t o = static_cast<size_t>(gy) * W + gx;
      const float x = tree11([&](int k) { return v_x[r][c + k]; });
      const float n = tree11([&](int k) { return v_n[r][c + k]; });
      const float src = to_f32(frame[o]);
      const float mean = n > 1.f ? __fdiv_rn(x, fmaxf(n, 1.f)) : 0.f;
      const bool local_ok = src >= fadd(mean, fmul(nsig_s, __fsqrt_rn(mean)));
      ok = mask[o] != 0 && src <= trusted_max && n > 0.f && surv[o] && src > 0.f && local_ok;
    }
    const unsigned word = __ballot_sync(kFull, ok);
    if (lane == 0) {
      pcw[(static_cast<size_t>(b) * H + gy) * (2 * nwl) + nwl + x0 / 32 + wd] =
          static_cast<int32_t>(word);
    }
  }
}

template <typename T>
cudaError_t launch_extended(const void* img, const uint8_t* mask, const uint16_t* mbox,
                            uint8_t* first, uint8_t* survived, int32_t* pcw, int B, int H,
                            int W, int nwl, float trusted_max, int min_count, float nsig_b,
                            float nsig_s, cudaStream_t stream) {
  cudaError_t err = launch_tile<T, false, true>(img, mask, mbox, nullptr, first, B, H, W,
                                                nwl, trusted_max, min_count, nsig_b,
                                                nsig_s, stream);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  erode_kernel<<<blocks, kThreads, 0, stream>>>(first, mask, survived, B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  second_pass_kernel<T><<<tile_grid(B, H, W), kThreads, 0, stream>>>(
      static_cast<const T*>(img), mask, survived, pcw, H, W, nwl, trusted_max, nsig_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pc_scan(pcw, B, H, W, nwl, stream);
}

}  // namespace
}  // namespace ffs_kernels

// img: (B, H, W) pixels of `pixel_type` (0 uint16, 1 uint32, 2 int32); mask
// (H, W) u8; mbox (H, W) u16 first-pass mask box count or null;
// first/survived (B, H, W) u8 scratch planes; pcw (B, H, 2*nwl) int32.
// Launches on `stream` and returns the first launch error (0 on success).
extern "C" int ffs_dispersion_extended_packed(const void* img, int pixel_type,
                                              const void* mask, const void* mbox,
                                              void* first, void* survived, void* pcw,
                                              int B, int H, int W, int nwl,
                                              float trusted_max, int min_count,
                                              float nsig_b, float nsig_s, void* stream) {
  using namespace ffs_kernels;
  const auto* msk = static_cast<const uint8_t*>(mask);
  const auto* mb = static_cast<const uint16_t*>(mbox);
  auto* f = static_cast<uint8_t*>(first);
  auto* sv = static_cast<uint8_t*>(survived);
  auto* out = static_cast<int32_t*>(pcw);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto pixel) {
    return launch_extended<decltype(pixel)>(img, msk, mb, f, sv, out, B, H, W, nwl,
                                            trusted_max, min_count, nsig_b, nsig_s, s);
  };
  switch (pixel_type) {
    case kU16: return static_cast<int>(launch(uint16_t{}));
    case kU32: return static_cast<int>(launch(uint32_t{}));
    case kI32: return static_cast<int>(launch(int32_t{}));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As ffs_dispersion_extended_packed, with pcw as (B, H, 2*nwl) int32 scratch,
// then the dense outputs: strong (B, H, W) u8 or null, rowcum (B, H, W) int32.
extern "C" int ffs_dispersion_extended_fused(const void* img, int pixel_type, const void* mask,
                                             const void* mbox, void* first, void* survived,
                                             void* pcw, void* strong, void* rowcum, int B,
                                             int H, int W, int nwl, float trusted_max,
                                             int min_count, float nsig_b, float nsig_s,
                                             void* stream) {
  const int rc = ffs_dispersion_extended_packed(img, pixel_type, mask, mbox, first, survived,
                                                pcw, B, H, W, nwl, trusted_max, min_count,
                                                nsig_b, nsig_s, stream);
  if (rc != 0) return rc;
  return static_cast<int>(ffs_kernels::launch_rowcum_expand(
      static_cast<const int32_t*>(pcw), static_cast<uint8_t*>(strong),
      static_cast<int32_t*>(rowcum), B, H, W, nwl, static_cast<cudaStream_t>(stream)));
}
