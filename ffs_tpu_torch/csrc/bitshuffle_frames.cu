// Bitshuffle planes -> row-major frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel ffs_tpu/ops/frame_assemble.py:55 _assemble_kernel
// (entry frames_from_flat_wide :84, pallas_call :124) together with the XLA
// inverse bitshuffle that feeds it, ffs_tpu/ops/bitshuffle_device.py
// untranspose_planes (:96) and untranspose_planes_to_wide (:164).  On the TPU
// the relayout of the flat element stream into (B, H, pad128(W)) frames needs
// its own kernel because the detector width is not lane-aligned there; on the
// GPU a row-major (H, W) frame IS the flat stream, so this one kernel computes
// the whole composition of the batched decode path
// (ffs_tpu/spotfind.py:374-386):
//
//     out[b, e] = element e of the inverse bitshuffle of planes[b],  e < H*W
//
// planes (B, n_blocks, block_elem * S) uint8, the LZ4-decoded block bodies in
// the upstream bitshuffle layout: a block is an (S, 8, block_elem/8)-byte
// array whose byte [s, kk, g] holds bit kk of byte s of elements 8g..8g+7
// (bit t of that byte for element 8g+t).  The final partial block arrives
// re-spread into that full-block layout, zero padded; elements at or past
// H*W are not written.  out (B, H*W) of S-byte elements, S = 1 (u8), 2
// (u16) or 4 (u32).  The output is a permutation of the input's bits: no
// arithmetic, no atomics, so it equals the plain version bit for bit.
//
// The chunk decode (ffs_tpu/ops/bitshuffle_device.py decode_blocks :266 and
// bshuf_lz4_decompress_device :297) runs the same entry with B = 1 and the
// chunk's blocks as one flat frame of n_blocks * block_elem elements, at any
// of the three element sizes; its raw tail of n_elem % 8 elements never
// reaches the card.
//
// What bounds it on the H100: bytes.  The least time is (the planes read
// once + the frames written once) / 3.35 TB/s: for an Eiger 16M u16 frame
// (4418 blocks x 8192 B in, 18,093,576 px x 2 B out) 72.4 MB, 0.0216 ms; u32
// (8835 blocks of 2048 elements) about 144.8 MB, 0.0432 ms.  The design is
// the simple one: one thread per 8-element group, grid (group, frame).  A
// thread loads its 8*S plane bytes (across a warp, consecutive groups read
// consecutive bytes of each plane row), transposes the 8x8 bit matrices in
// registers with the three delta-swap steps of _transpose8, assembles the 8
// elements with byte permutes and writes them as 8 B (u8), 16 B (u16) or
// 32 B (u32), contiguous across the warp.  Byte loads keep it below the memory rate:
// 16-byte loads and more groups per thread are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t delta_swap(uint32_t w, int sh, uint32_t mask) {
  const uint32_t t = (w ^ (w >> sh)) & mask;
  return w ^ t ^ (t << sh);
}

// 8x8 bit-matrix transpose: r[kk] holds bit plane kk of 8 elements in its low
// byte (bit t = element t).  On return byte t of x (t < 4) or of y (t >= 4,
// byte t-4) has bit kk = bit t of r[kk]: one byte of element t.
__device__ __forceinline__ void transpose8(const uint32_t r[8], uint32_t& x, uint32_t& y) {
  x = r[0] | (r[1] << 8) | (r[2] << 16) | (r[3] << 24);
  y = r[4] | (r[5] << 8) | (r[6] << 16) | (r[7] << 24);
  x = delta_swap(x, 7, 0x00AA00AAu);
  y = delta_swap(y, 7, 0x00AA00AAu);
  x = delta_swap(x, 14, 0x0000CCCCu);
  y = delta_swap(y, 14, 0x0000CCCCu);
  const uint32_t t = (x ^ (y << 4)) & 0xF0F0F0F0u;
  x ^= t;
  y ^= t >> 4;
}

// One thread per 8-element group g of frame blockIdx.y.  `m` is the number of
// groups in a block (block_elem / 8), `n_px` the frame's pixel count (a
// multiple of 8, so a group lies wholly inside the frame or wholly past it).
template <int S>
__global__ void __launch_bounds__(kThreads)
    bitshuffle_frames_kernel(const uint8_t* __restrict__ planes, long long frame_bytes, int m,
                             long long n_px, uint8_t* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (8 * g >= n_px) return;
  const long long b = blockIdx.y;
  const long long blk = g / m;
  const long long gi = g - blk * m;
  const uint8_t* src = planes + b * frame_bytes + blk * (8LL * S * m) + gi;

  uint32_t lo[S], hi[S];  // bytes s of elements 0-3 (lo) and 4-7 (hi)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t r[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) r[kk] = __ldg(src + static_cast<long long>(s * 8 + kk) * m);
    transpose8(r, lo[s], hi[s]);
  }

  // little-endian elements: element t's byte s is byte t of lo[s]/hi[s]
  uint8_t* dst = out + (b * n_px + 8 * g) * S;
  if constexpr (S == 1) {
    // the 8 bytes of elements 0-7 are the transposed matrix itself
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo[0], hi[0]);
  } else if constexpr (S == 2) {
    // word j holds elements 2j and 2j+1: [lo0.b, lo1.b, lo0.b', lo1.b']
    const uint4 v = make_uint4(__byte_perm(lo[0], lo[1], 0x5140), __byte_perm(lo[0], lo[1], 0x7362),
                               __byte_perm(hi[0], hi[1], 0x5140), __byte_perm(hi[0], hi[1], 0x7362));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    // one word per element: pair bytes of planes (0,1) and (2,3), then join
    uint32_t e[8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t* q = half ? hi : lo;
      const uint32_t a01 = __byte_perm(q[0], q[1], 0x5140), a23 = __byte_perm(q[2], q[3], 0x5140);
      const uint32_t c01 = __byte_perm(q[0], q[1], 0x7362), c23 = __byte_perm(q[2], q[3], 0x7362);
      e[4 * half + 0] = __byte_perm(a01, a23, 0x5410);
      e[4 * half + 1] = __byte_perm(a01, a23, 0x7632);
      e[4 * half + 2] = __byte_perm(c01, c23, 0x5410);
      e[4 * half + 3] = __byte_perm(c01, c23, 0x7632);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(e[0], e[1], e[2], e[3]);
    d[1] = make_uint4(e[4], e[5], e[6], e[7]);
  }
}

}  // namespace

// planes (B, n_blocks, block_elem * elem_size) uint8 on the device; out
// (B, n_px) elements of elem_size bytes (1, 2 or 4), 16-byte aligned.  The
// Python wrapper checks that the planes hold n_px elements and that
// block_elem and n_px are multiples of 8.  Launches on `stream`; returns the
// launch error (0 on success).
extern "C" int ffs_bitshuffle_frames(const void* planes, int b, int n_blocks, int block_elem,
                                     int elem_size, int n_px, void* out, void* stream) {
  if ((elem_size != 1 && elem_size != 2 && elem_size != 4) || block_elem <= 0 || block_elem % 8 || n_px % 8 ||
      static_cast<long long>(n_blocks) * block_elem < n_px) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n_px == 0) return 0;
  const long long groups = n_px / 8;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads), b);
  const long long frame_bytes = static_cast<long long>(n_blocks) * block_elem * elem_size;
  const int m = block_elem / 8;
  auto* src = static_cast<const uint8_t*>(planes);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1) {
    bitshuffle_frames_kernel<1><<<grid, kThreads, 0, s>>>(src, frame_bytes, m, n_px, dst);
  } else if (elem_size == 2) {
    bitshuffle_frames_kernel<2><<<grid, kThreads, 0, s>>>(src, frame_bytes, m, n_px, dst);
  } else {
    bitshuffle_frames_kernel<4><<<grid, kThreads, 0, s>>>(src, frame_bytes, m, n_px, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
