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
//     windows per block (the TPU's windows per grid program), and a
//     single-block form that reads only the aligned 128-column block holding
//     x0 and rotates it,
//     out[a,q,r,c] = img[q, y0+r, 128*xblk + (c + shift) % 128] with
//     xblk = min(x0/128, Wp/128 - 2), shift = x0 - 128*xblk: the TPU
//     probe's result, which is the window itself only where shift == 0.
//
// The probe is the one entry built the Hopper way, as the TPU probe was
// built around its DMAs: its question is whether loads kept in flight by
// an engine beat loads kept in flight by warps.  The source is a 3-D TMA
// tensor map over (Wp, Hp, P) of 4-byte words (no swizzle, no
// interleave, no L2 promotion: 256-byte promotion over-fetches around the
// double form's 528-byte rows, and read slower on the H100), encoded on the
// host at every launch.  TMA takes any start
// row and plane, but the start of a box's innermost dimension must be
// 16-byte aligned (on the H100 any other x0 % 4 is an illegal
// instruction).  So a double-form window-plane is one box (132, bh, 1) at
// (x0 & ~3, y0, p), read from shared memory x0 % 4 words in (up to three
// columns past Wp are zero-filled by TMA and never read); a single-form
// one is the box (128, bh, 1) at (128*xblk, y0, p), rotated as it is read.
// Either way a lane builds each 16-byte store from two aligned 16-byte
// shared loads, which a warp takes over consecutive addresses (no bank
// conflicts).  A block of four consumer warps and one producer warp serves
// windows k*r .. k*r + r - 1 through a ring of `slots` stages in dynamic
// shared memory, each with a full and an empty mbarrier: the producer's
// lane 0 waits for a stage to be empty, arms its full barrier with
// arrive.expect_tx for exactly the box bytes and issues the TMA load; the
// consumers wait for it to be full, write its tiles to the output with
// 16-byte stores (a window-plane of the output is one contiguous
// bh x 512 B run), and each warp arrives on its empty barrier.  So `slots`
// is the ring's depth: the producer runs up to `slots` stages ahead, and
// while the consumers write one stage, `slots - 1` loads can be in flight.
//
// A stage holds one window's P planes, a (W, bh, P) box (W = 132 double,
// 128 single), or one window-plane, a (W, bh, 1) box: whichever of the two
// that fits `slots` stages in the shared memory a block may opt in to
// (227 KB on the H100) keeps more bytes in flight an SM; where even
// `slots` window-planes do not fit, the wrapper raises.  The planner is
// Python (ops/window_gather.py:probe_plan).  At the gather tool's bh = 24
// and P = 4, a double-form window-plane is 24 x 528 B = 12.4 KB and a
// window 49.5 KB: slots = 2 and 4 take window stages (99 KB, two blocks an
// SM; 198 KB, one), slots = 8 and 16 window-plane stages (99 KB, two
// blocks; 198 KB, one), at r = 8.  Bytes in flight an SM are blocks an SM
// x (slots - 1) x stage bytes, while a block has that many stages to load
// (r x P / stage planes): 99 KB (slots 2), 149 KB (4), 173 KB (8), 186 KB
// (16) at r = 8, against the ~30-40 KB an SM that HBM3's latency (~1.5 us
// at 3.35 TB/s over 132 SMs: 25 GB/s x 1.5 us ~ 38 KB) needs.  The
// per-thread-load loop it replaces had, at 256 blocks of 4 warps, about
// 8 warps an SM and 8 rows of 512 B in flight each: latency-bound.
//
// Faults end the launch, not the process's patience: every mbarrier wait
// is bounded (kWaitLimitNs of the global timer) and traps past it, so a
// wrong transaction count or phase parity is a launch error, not a hang.

#include <cstdint>
#include <cuda.h>
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

// The measurement probe's ring.  PTX of the mbarrier and TMA operations.
constexpr int kConsumerWarps = 4;
constexpr int kProbeThreads = 32 * (kConsumerWarps + 1);
constexpr unsigned long long kWaitLimitNs = 2000000000ull;  // 2 s
// Words a row of a stage: the single form's aligned block; the double
// form's 16-byte aligned start x0 & ~3 and the 131 columns it may need.
template <bool SINGLE>
constexpr int kBoxWidth = SINGLE ? kLanes : kLanes + 4;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void barrier_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool barrier_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the completion of the barrier's phase of parity `parity`;
// traps after kWaitLimitNs, so that a bug is a launch error, not a hang.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  if (barrier_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!barrier_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Words sh..sh+3 of the eight in (v0, v1), sh in 0..3.
__device__ __forceinline__ uint4 words_from(const uint4& v0, const uint4& v1, int sh) {
  switch (sh) {
    case 0: return v0;
    case 1: return make_uint4(v0.y, v0.z, v0.w, v1.x);
    case 2: return make_uint4(v0.z, v0.w, v1.x, v1.y);
    default: return make_uint4(v0.w, v1.x, v1.y, v1.z);
  }
}

// Block k serves windows k*r .. k*r + r - 1, every plane, as units of
// `stage_planes` planes (P: a window a stage, or 1: a window-plane), one
// unit a ring stage of (kBoxWidth<SINGLE>, bh, stage_planes) words.
// Dynamic shared memory: the ring's stages, 128-byte aligned, then `slots`
// full and `slots` empty barriers.
template <bool SINGLE>
__global__ void __launch_bounds__(kProbeThreads)
    gather_probe_kernel(const __grid_constant__ CUtensorMap map,
                        const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
                        int a_count, int planes, int bh, int wb, int r_windows, int slots,
                        int stage_planes, uint32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = shared_addr(smem);
  const uint32_t pad = ((base + 127u) & ~127u) - base;
  const uint32_t tiles = base + pad;
  constexpr int kRowVecs = kBoxWidth<SINGLE> / 4;
  const uint32_t stage_bytes = 4u * stage_planes * bh * kBoxWidth<SINGLE>;
  const uint32_t full = tiles + slots * stage_bytes;  // 8-byte aligned: bh % 8 == 0
  const uint32_t empty = full + 8u * slots;
  const int first = blockIdx.x * r_windows;
  const int per_window = planes / stage_planes;
  const int units = min(r_windows, a_count - first) * per_window;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      barrier_init(full + 8u * s, 1);
      barrier_init(empty + 8u * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    for (int u = 0; u < units; ++u) {
      const int s = u % slots;
      const int k = u / slots;
      const int a = first + u / per_window;  // offsets read before the wait
      const int x = SINGLE ? kLanes * min(x0[a] / kLanes, wb - 2) : x0[a] & ~3;
      const int y = y0[a];
      if (k > 0) barrier_wait(empty + 8u * s, (k - 1) & 1);
      barrier_arrive_expect_tx(full + 8u * s, stage_bytes);
      tma_load_3d(tiles + s * stage_bytes, &map, full + 8u * s, x, y,
                  (u % per_window) * stage_planes);
    }
    return;
  }

  const int vecs = stage_planes * bh * kLanes / 4;  // 16-byte stores a stage
  for (int u = 0; u < units; ++u) {
    const int s = u % slots;
    const int a = first + u / per_window;
    const int p0 = (u % per_window) * stage_planes;
    const int xa = x0[a];  // read before the wait, which orders memory
    barrier_wait(full + 8u * s, (u / slots) & 1);
    const uint4* tile = reinterpret_cast<const uint4*>(smem + pad + s * stage_bytes);
    uint4* dst = reinterpret_cast<uint4*>(
        out + (static_cast<long long>(a) * planes + p0) * bh * kLanes);
    // lane j of an output row writes words 4j..4j+3: tile words
    // (4j + shift + k) % 128 of the 128-word single row, 4j + x0 % 4 + k of
    // the 132-word double row
    const int shift = SINGLE ? xa - kLanes * min(xa / kLanes, wb - 2) : xa & 3;
    const int q = SINGLE ? shift >> 2 : 0;
    const int sh = shift & 3;
    for (int i = threadIdx.x; i < vecs; i += 32 * kConsumerWarps) {
      const int row = (i >> 5) * kRowVecs;
      const uint4 v0 = tile[row + ((lane + q) & 31)];
      const uint4 v1 = tile[row + (SINGLE ? (lane + q + 1) & 31 : lane + 1)];
      dst[i] = words_from(v0, v1, sh);
    }
    __syncwarp();
    if (lane == 0) barrier_arrive(empty + 8u * s);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null where libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

int probe_smem_bytes(int slots, int stage_planes, int bh, bool single) {
  return slots * (stage_planes * bh * (single ? kBoxWidth<true> : kBoxWidth<false>) * 4 + 16) +
         128;
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

// Error codes of the probe's tensor map, beside CUDA's (ffs_cuda_error_string).
constexpr int kNoEncodeEntry = 100000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 100001;   // + the CUresult it returned

// img (P, Hp, Wp) 4-byte elements, 16-byte aligned; y0, x0 (A,) int32 on the
// device; out (A, P, bh, 128).  `single` selects the one-block form, `r` the
// windows per block, `slots` the ring's stages of `stage_planes` planes (P
// or 1), `smem_bytes` the dynamic shared memory a block (at least
// probe_smem_bytes; the planner's figure).  Opts in to that shared memory
// on every launch (the attribute is per device), encodes the tensor map
// and launches on `stream`; returns the first error (0 on success).
extern "C" int ffs_window_gather_probe(const void* img, int planes, int hp, int wp,
                                       const void* y0, const void* x0, int a, int bh,
                                       int single, int r, int slots, int stage_planes,
                                       int smem_bytes, void* out, void* stream) {
  if (a == 0) return 0;
  if (r < 1 || slots < 2 || bh < 8 || bh % 8 || bh > 256 || wp % kLanes ||
      (stage_planes != planes && stage_planes != 1) || stage_planes > 256 ||
      smem_bytes < probe_smem_bytes(slots, stage_planes, bh, single != 0) ||
      reinterpret_cast<uintptr_t>(img) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncodeEntry;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(wp), static_cast<cuuint64_t>(hp),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {4ull * wp, 4ull * wp * hp};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {
      static_cast<cuuint32_t>(single ? kBoxWidth<true> : kBoxWidth<false>),
      static_cast<cuuint32_t>(bh), static_cast<cuuint32_t>(stage_planes)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(img),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  const int blocks = (a + r - 1) / r;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ys = static_cast<const int32_t*>(y0);
  const auto* xs = static_cast<const int32_t*>(x0);
  auto* dst = static_cast<uint32_t*>(out);
  const auto kernel = single ? gather_probe_kernel<true> : gather_probe_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kProbeThreads, smem_bytes, s>>>(map, ys, xs, a, planes, bh, wp / kLanes, r,
                                                   slots, stage_planes, dst);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the probe at `smem_bytes` of dynamic shared
// memory (CUDA's occupancy query, the current device); a negative CUDA
// error code on failure.
extern "C" int ffs_window_gather_probe_blocks_per_sm(int single, int smem_bytes) {
  const auto kernel = single ? gather_probe_kernel<true> : gather_probe_kernel<false>;
  int n = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kProbeThreads, smem_bytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
