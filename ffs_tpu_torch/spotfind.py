"""Per-frame spotfinding on a torch device.

Counterpart of :mod:`ffs_tpu.spotfind` (its per-frame processor): the
dispersion threshold, compaction, 2D connected components, per-spot
statistics and filters for one frame, with the host receiving compact
per-pixel arrays.  Two forms of the step, chosen by the configuration:

* **fused** — everything on the device: the packed kernel and
  ``compact_from_pcw``, or the plain float64/float32 threshold
  (``ops.dispersion``) and dense compaction; then device CC
  (``ops.connected_components``).  The f64 CLI default runs here: the
  float64 ``dispersion`` threshold of a uint16 frame as the float64 walker
  (``ops.dispersion_packed.dispersion_packed_f64``), other f64 inputs
  (``dispersion_extended``, 32-bit pixels) through the plain threshold.
* **tiered** — the packed kernel returns the frame's exact strong-pixel
  count first; compaction then runs at the smallest capacity tier that
  holds it, and the host C++ CC (ops.cc2d_host) labels.  The f32
  kernel path runs here.

Batched collection (:meth:`SpotfindProcessor.dispatch_batch`,
:meth:`~SpotfindProcessor.dispatch_batch_planes`,
:meth:`~SpotfindProcessor.collect_batch`) runs B frames through one kernel
launch, segmented per-frame compaction and, with device CC, one
multi-frame spot table; the planes form decodes the bitshuffle planes on
the device first (ops.bitshuffle_device).

The processor carries an explicit ``torch.device``; nothing here reads
global device state.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .constants import (
    DEFAULT_MAX_PEAK_CENTROID_SEPARATION,
    DEFAULT_MIN_COUNT,
    DEFAULT_MIN_SPOT_SIZE,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
)
from .ops import cc3d

from .ops import connected_components as cc
from .ops import dispersion as dops
from .ops.bitshuffle_device import check_planes, frames_from_planes
from .ops.compact import compact_from_pcw, compact_from_pcw_segmented
from .ops.dispersion_extended_packed import dispersion_extended_packed_raw
from .ops.dispersion_packed import dispersion_packed_f64, dispersion_packed_raw
from .ops.masking import resolution_mask
from .utils import tracing


@dataclass
class SpotfindConfig:
    algorithm: str = "dispersion"  # or "dispersion_extended"
    min_count: int = DEFAULT_MIN_COUNT
    nsig_b: float = DEFAULT_NSIG_B
    nsig_s: float = DEFAULT_NSIG_S
    min_spot_size: int = DEFAULT_MIN_SPOT_SIZE
    min_spot_size_3d: int = DEFAULT_MIN_SPOT_SIZE
    max_peak_centroid_separation: float = DEFAULT_MAX_PEAK_CENTROID_SEPARATION
    dmin: float = -1.0
    dmax: float = -1.0
    max_strong_pixels: int = 65536
    max_spots: int = 16384
    # batched mode (dispatch_batch/collect_batch): per-frame strong-pixel
    # slot capacity of the segmented compaction.  None = min(
    # max_strong_pixels, 16384); frames past it fall back to the per-frame
    # tiered path (up to max_strong_pixels)
    batch_max_px_per_frame: Optional[int] = None
    precision: str = "f64"  # "f64" (bit-parity with DIALS CPU) or "f32"
    # the packed CUDA kernels; None = auto (CUDA device and f32).  On a CPU
    # device True runs their plain PyTorch versions (tests)
    use_kernel: bool | None = None
    # "host" labels on the CPU (C++ union-find), "device" on the torch
    # device, "auto" = host whenever the kernel path is on
    cc_backend: str = "auto"  # "auto" | "host" | "device"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "f64" else torch.float32

    def kernel_enabled(self, device: torch.device) -> bool:
        if self.use_kernel is not None:
            return self.use_kernel
        return device.type == "cuda" and self.precision == "f32"

    def host_cc_enabled(self, device: torch.device) -> bool:
        if self.cc_backend == "host":
            return True
        if self.cc_backend == "device":
            return False
        return self.kernel_enabled(device)


def config_from_dict(d: dict) -> SpotfindConfig:
    """The port's config from ``dataclasses.asdict`` of an
    :class:`ffs_tpu.spotfind.SpotfindConfig`: ``use_pallas`` becomes
    ``use_kernel``, ``pallas_interpret`` (a Mosaic test hook) is dropped, and
    so is ``compact_backend`` at its default, ``"device"``: the port has no
    host compaction, so ``"host"`` raises ValueError."""
    d = dict(d)
    d.pop("pallas_interpret", None)
    if d.get("compact_backend", "device") != "device":
        raise ValueError(
            f"compact_backend={d['compact_backend']!r}: the port compacts on the device only"
        )
    d.pop("compact_backend", None)
    if "use_pallas" in d:
        d["use_kernel"] = d.pop("use_pallas")
    names = {f.name for f in dataclasses.fields(SpotfindConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SpotfindConfig fields: {sorted(unknown)}")
    return SpotfindConfig(**d)


@dataclass
class FrameResult:
    """Host-side result of one frame (everything the service needs)."""

    image_number: int
    n_strong_pixels: int
    n_spots: int  # after 2D min-spot-size filter (the reference's "boxes")
    n_spots_prefilter: int
    n_strong_pixels_filtered: int
    pixels: cc3d.FramePixels  # compact strong pixels for 3D merging
    # 2D centroids (min-size + separation filtered), for stills/indexing
    centers_of_mass: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))


def _host(a) -> np.ndarray:
    """A host NumPy array from a tensor on any device (or an array)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _capacity_error(image_number: int, n: int, capacity: int, what: str) -> RuntimeError:
    # past capacity: hard-fail like the reference's saturation conditions
    # instead of silently truncating the spot list
    return RuntimeError(
        f"frame {image_number}: {n} strong pixels exceed the {what} "
        f"{capacity}; raise SpotfindConfig.max_strong_pixels"
    )


class _Tiered(NamedTuple):
    """What :meth:`SpotfindProcessor.dispatch` returns on the tiered path:
    the frame on the device, its packed words and their exact count, from
    which :meth:`~SpotfindProcessor.collect` compacts at the smallest tier."""

    image: torch.Tensor
    pcw: torch.Tensor
    count: torch.Tensor


class SpotfindProcessor:
    """Per-frame spotfinding step for a fixed detector configuration."""

    def __init__(
        self,
        width: int,
        height: int,
        mask: np.ndarray,
        trusted_max: float,
        config: SpotfindConfig | None = None,
        wavelength: float | None = None,
        detector: Optional[dict] = None,
        *,
        device: torch.device,
    ):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.config = config or SpotfindConfig()
        self.trusted_max = float(trusted_max)
        cfg = self.config

        mask_dev = torch.as_tensor(np.asarray(mask, dtype=np.uint8), device=self.device)
        if (cfg.dmin > 0 or cfg.dmax > 0) and detector is not None:
            # detector dict: distance (m), beam_center_{x,y} (px),
            # pixel_size_{x,y} (m) — reference masking.cuh:14-70 semantics
            mask_dev = resolution_mask(
                mask_dev,
                wavelength=wavelength,
                distance=detector["distance"],
                beam_center_x=detector["beam_center_x"],
                beam_center_y=detector["beam_center_y"],
                pixel_size_x=detector["pixel_size_x"],
                pixel_size_y=detector["pixel_size_y"],
                dmin=cfg.dmin,
                dmax=cfg.dmax,
            )
        self.mask = mask_dev

        self.use_kernel = cfg.kernel_enabled(self.device)
        self.host_cc = cfg.host_cc_enabled(self.device)
        # the JAX package runs its kernel path with x64 off, where the
        # separation filter evaluates in float32; float64 everywhere else
        self._sep_dtype = torch.float32 if self.use_kernel else torch.float64
        # off the kernel path, the float64 dispersion threshold of a uint16
        # frame runs as the float64 walker (the same bits as the plain
        # threshold); its library loads here, not in the first frame's step
        self._f64_walker = (
            not self.use_kernel and cfg.precision == "f64" and cfg.algorithm == "dispersion"
        )
        if self._f64_walker and self.device.type == "cuda":
            from .utils import cuda_build

            cuda_build.lib()

        # compaction capacity tiers of the tiered path: typical frames
        # compact at K=4096 instead of the worst-case maximum
        self._capacity_tiers = sorted(
            {t for t in (4096, 16384, cfg.max_strong_pixels) if t <= cfg.max_strong_pixels}
        )
        self._batch_kf = cfg.batch_max_px_per_frame or min(cfg.max_strong_pixels, 16384)

    # --- device steps --------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        with tracing.span("ffs.upload"):
            host = np.ascontiguousarray(image)
            tracing.count("h2d_bytes", host.nbytes)
            return torch.from_numpy(host).to(self.device)

    def _packed(self, image: torch.Tensor) -> torch.Tensor:
        """The packed kernel step -> combined [pc | w32] rows."""
        cfg = self.config
        fn = (
            dispersion_packed_raw
            if cfg.algorithm == "dispersion"
            else dispersion_extended_packed_raw
        )
        return fn(
            image, self.mask, self.trusted_max, min_count=cfg.min_count,
            nsig_b=cfg.nsig_b, nsig_s=cfg.nsig_s,
        )

    def _count_step(self, image: torch.Tensor):
        """Kernel step of the tiered path: (pcw, exact count)."""
        pcw = self._packed(image)
        nwl = pcw.shape[-1] // 2
        return pcw, pcw[:, nwl - 1].sum()

    def _step(self, image: torch.Tensor):
        """The fused per-frame step (device CC unless host CC is on)."""
        cfg = self.config
        neighbors = None
        pcw = None
        if self.use_kernel:
            pcw = self._packed(image)
        elif self._f64_walker and image.dtype == torch.uint16:
            tracing.count("f64_walker_frames")
            pcw = dispersion_packed_f64(
                image, self.mask, self.trusted_max, min_count=cfg.min_count,
                nsig_b=cfg.nsig_b, nsig_s=cfg.nsig_s,
            )
        if pcw is not None:
            pixels, nbu, nbd = compact_from_pcw(
                image, pcw, max_pixels=cfg.max_strong_pixels, with_neighbors=True
            )
            neighbors = (nbu, nbd)
        else:
            fn = dops.dispersion if cfg.algorithm == "dispersion" else dops.dispersion_extended
            strong = fn(
                image, self.mask, self.trusted_max, min_count=cfg.min_count,
                nsig_b=cfg.nsig_b, nsig_s=cfg.nsig_s, dtype=cfg.dtype,
            )
            pixels = cc.compact_strong_pixels(strong, image, max_pixels=cfg.max_strong_pixels)
        if self.host_cc:
            return (pixels,)
        root_slot = cc.label_compact_pixels(pixels, width=self.width, neighbors=neighbors)
        root_lin = pixels.linear_index[root_slot.to(torch.int64)]
        table = cc.spot_table_from_pixels(
            pixels, root_slot, width=self.width, max_spots=cfg.max_spots, dtype=cfg.dtype
        )
        size_keep, _, _ = cc.filter_spots(table, cfg.min_spot_size, -1.0, dtype=self._sep_dtype)
        both_keep, _, _ = cc.filter_spots(
            table, cfg.min_spot_size, cfg.max_peak_centroid_separation, dtype=self._sep_dtype
        )
        n_boxes = size_keep.sum(dtype=torch.int32)
        n_px_filtered = torch.where(size_keep, table.n_pixels, 0).sum(dtype=torch.int32)
        return pixels, root_lin, table, both_keep, n_boxes, n_px_filtered

    def _tier(self, image_number: int, n: int) -> int:
        tier = next((t for t in self._capacity_tiers if n <= t), None)
        if tier is None:
            raise _capacity_error(image_number, n, self._capacity_tiers[-1], "maximum capacity")
        return tier

    def _batch_step(self, images: torch.Tensor):
        """One (B, H, W) batch: the packed kernel for all B frames, segmented
        compaction and, with device CC, labels, one multi-frame float32 spot
        table and its filters (``ffs_tpu.spotfind._batch_step``)."""
        cfg = self.config
        kf = self._batch_kf
        pcw = self._packed(images)
        hp = pcw.shape[1]  # per-frame rows: the tall pitch is hp + 1
        if self.host_cc:
            pixels, counts = compact_from_pcw_segmented(images, pcw, max_pixels_per_frame=kf)
            return pixels, counts, hp
        pixels, nbu, nbd, counts = compact_from_pcw_segmented(
            images, pcw, max_pixels_per_frame=kf, with_neighbors=True
        )
        # an overflowing frame's neighbour slots may point past the array:
        # clamp them as the JAX gather does (such frames are discarded)
        k = pixels.linear_index.shape[0]
        neighbors = (nbu.clamp(max=k - 1), nbd.clamp(max=k - 1))
        root_slot = cc.label_compact_pixels(pixels, width=self.width, neighbors=neighbors)
        root_lin = pixels.linear_index[root_slot.to(torch.int64)]
        table = cc.spot_table_from_pixels(
            pixels, root_slot, width=self.width, max_spots=cfg.max_spots,
            dtype=torch.float32, frame_rows=hp,
        )
        size_keep, _, _ = cc.filter_spots(table, cfg.min_spot_size, -1.0, dtype=self._sep_dtype)
        both_keep, _, _ = cc.filter_spots(
            table, cfg.min_spot_size, cfg.max_peak_centroid_separation, dtype=self._sep_dtype
        )
        return pixels, counts, hp, root_lin, table, size_keep, both_keep

    # --- public batched interface --------------------------------------------

    def batch_supported(self) -> bool:
        """Batched collection needs the kernel path: the batched step runs
        the float32 kernels and a float32 spot table, so the f64 step stays
        per frame."""
        return self.use_kernel

    def _require_batch(self) -> None:
        if not self.use_kernel:
            raise ValueError(
                "batched collection requires the kernel path "
                "(SpotfindConfig.use_kernel / precision='f32' on a CUDA device)"
            )

    def dispatch_batch(self, images: np.ndarray):
        """Queue a (B, H, W) frame batch; returns what :meth:`collect_batch`
        takes.  The whole batch runs as one kernel launch and one sparse
        pipeline, so the per-frame overhead amortises over B frames."""
        self._require_batch()
        images = self._upload(images)
        with tracing.span("ffs.dispatch"):
            return self._batch_step(images)

    def dispatch_batch_planes(self, planes: np.ndarray, dtype=np.uint16):
        """Queue a batch given as LZ4-decoded bitshuffle planes.

        ``planes``: (B, n_blocks, block_elem * elem_size) uint8, each frame's
        stacked block plane matrix from
        :func:`ffs_tpu_torch.io.compression.bshuf_lz4_planes` (padded final
        partial block, no raw tail: the frame's pixel count must be a
        multiple of 8).  The planes upload as they are and the bit
        untranspose runs on the device (``ops.bitshuffle_device``); results
        are bit-identical to :meth:`dispatch_batch` of the decoded frames.
        """
        self._require_batch()
        dt = np.dtype(dtype)
        check_planes(planes.shape, self.height, self.width, dt.itemsize)
        planes = self._upload(planes)
        with tracing.span("ffs.dispatch"):
            frames = frames_from_planes(
                planes, self.height, self.width,
                torch.uint16 if dt.itemsize == 2 else torch.uint32,
            )
            return self._batch_step(frames)

    def collect_batch(
        self, image_numbers, device_result, images=None, want_com: bool = False
    ) -> list[FrameResult]:
        """Wait for a dispatched batch and split it into per-frame results.

        ``images`` (the host frames, any sequence indexable by batch
        position) enables the per-frame fallback for a frame past the
        batched per-frame capacity; without it such a frame raises.  Each
        frame's pixels sit in their own slot segment and spots never bridge
        frames, so the per-frame slices equal the per-frame path's results.
        """
        with tracing.span("ffs.collect", frame=image_numbers[0], frames=len(image_numbers)):
            return self._collect_batch(image_numbers, device_result, images, want_com)

    def _collect_batch(self, image_numbers, device_result, images, want_com) -> list[FrameResult]:
        cfg = self.config
        kf = self._batch_kf
        if self.host_cc:
            pixels, counts, hp = device_result
        else:
            pixels, counts, hp, root_lin, table, size_keep, both_keep = device_result
            if int(table.n_spots) > cfg.max_spots:
                raise RuntimeError(
                    f"batch produced {int(table.n_spots)} spots, exceeding "
                    f"max_spots={cfg.max_spots}; raise SpotfindConfig."
                    "max_spots or lower the batch size"
                )
            roots = _host(root_lin)
            t = {name: _host(getattr(table, name)) for name in
                 ("valid", "z_min", "n_pixels", "com_x", "com_y", "com_z")}
            size_keep, both_keep = _host(size_keep), _host(both_keep)
        lin, inten, counts = _host(pixels.linear_index), _host(pixels.intensity), _host(counts)
        pitch = (int(hp) + 1) * self.width
        results: list[FrameResult] = []
        for b, num in enumerate(image_numbers):
            n = int(counts[b])
            if n > kf:
                if images is None:
                    raise RuntimeError(
                        f"frame {num}: {n} strong pixels exceed the batched "
                        f"per-frame capacity {kf} and no host frames were "
                        "provided for the per-frame fallback"
                    )
                tracing.count("fallback_batch_overflow")
                results.append(self.process_frame(num, images[b], want_com))
                continue
            sl = slice(b * kf, b * kf + n)
            lin_f = lin[sl] - b * pitch
            if self.host_cc:
                cp = cc.CompactPixels(linear_index=lin_f, intensity=inten[sl], count=n)
                results.append(self._collect_host(num, cp, want_com))
                continue
            mine = t["valid"] & (t["z_min"] == b)
            keep_sz = mine & size_keep
            coms = np.zeros((0, 3))
            if want_com:
                kb = mine & both_keep
                coms = np.stack([t["com_x"][kb], t["com_y"][kb], t["com_z"][kb] - b], axis=1)
            results.append(
                FrameResult(
                    image_number=num,
                    n_strong_pixels=n,
                    n_spots=int(keep_sz.sum()),
                    n_spots_prefilter=int(mine.sum()),
                    n_strong_pixels_filtered=int(t["n_pixels"][keep_sz].sum()),
                    pixels=cc3d.FramePixels(
                        linear_index=lin_f, intensity=inten[sl], root=roots[sl] - b * pitch
                    ),
                    centers_of_mass=coms,
                )
            )
        return results

    # --- public per-frame interface ------------------------------------------

    def dispatch(self, image: np.ndarray):
        """Queue one frame's device work; returns what :meth:`collect` takes."""
        img_dev = self._upload(image)
        with tracing.span("ffs.dispatch"):
            if self.use_kernel and self.host_cc:
                # tiered path: kernel now, compaction sized in collect()
                return _Tiered(img_dev, *self._count_step(img_dev))
            return self._step(img_dev)

    def collect(self, image_number: int, device_result, want_com: bool = False) -> FrameResult:
        """Wait for a dispatched frame and assemble the host result."""
        with tracing.span("ffs.collect", frame=image_number):
            return self._collect(image_number, device_result, want_com)

    def _collect(self, image_number: int, device_result, want_com: bool) -> FrameResult:
        if isinstance(device_result, _Tiered):
            tier = self._tier(image_number, int(device_result.count))
            pixels = compact_from_pcw(device_result.image, device_result.pcw, max_pixels=tier)
            return self._collect_host(image_number, pixels, want_com)
        if self.host_cc:
            (pixels,) = device_result
            return self._collect_host(image_number, pixels, want_com)
        pixels, root_lin, table, both_keep, n_boxes, n_px_filtered = device_result
        n = int(pixels.count)
        if n > pixels.linear_index.shape[0]:
            # the one-shot step is sized at the configured maximum already
            raise _capacity_error(
                image_number, n, pixels.linear_index.shape[0], "configured capacity"
            )
        if int(table.n_spots) > self.config.max_spots:
            # spot ids past max_spots fall in the dropped overflow segment,
            # so the table would be silently wrong
            raise RuntimeError(
                f"frame {image_number}: {int(table.n_spots)} spots exceed "
                f"max_spots={self.config.max_spots}; raise SpotfindConfig.max_spots"
            )
        frame_pixels = cc3d.FramePixels(
            linear_index=_host(pixels.linear_index[:n]),
            intensity=_host(pixels.intensity[:n]),
            root=_host(root_lin[:n]),
        )
        coms = np.zeros((0, 3))
        if want_com:
            keep = _host(both_keep & table.valid)
            coms = np.stack(
                [_host(table.com_x)[keep], _host(table.com_y)[keep], _host(table.com_z)[keep]],
                axis=1,
            )
        return FrameResult(
            image_number=image_number,
            n_strong_pixels=n,
            n_spots=int(n_boxes),
            n_spots_prefilter=int(table.n_spots),
            n_strong_pixels_filtered=int(n_px_filtered),
            pixels=frame_pixels,
            centers_of_mass=coms,
        )

    def _collect_host(self, image_number: int, pixels, want_com: bool) -> FrameResult:
        """Label + tabulate on the host (C++ union-find over ~3k pixels)."""
        from .ops.cc2d_host import cc2d, filter_spots_host

        cfg = self.config
        n = int(pixels.count)
        capacity = len(pixels.linear_index)
        if n > capacity:
            raise _capacity_error(image_number, n, capacity, "configured capacity")
        lin = _host(pixels.linear_index[:n])
        inten = _host(pixels.intensity[:n])
        table = cc2d(lin, inten, self.width)
        size_keep, _, _ = filter_spots_host(table, cfg.min_spot_size, -1.0)
        both_keep, _, _ = filter_spots_host(
            table, cfg.min_spot_size, cfg.max_peak_centroid_separation
        )
        coms = np.zeros((0, 3))
        if want_com:
            coms = np.stack(
                [table.com_x[both_keep], table.com_y[both_keep], table.com_z[both_keep]],
                axis=1,
            )
        return FrameResult(
            image_number=image_number,
            n_strong_pixels=n,
            n_spots=int(size_keep.sum()),
            n_spots_prefilter=table.n_spots,
            n_strong_pixels_filtered=int(table.n_pixels[size_keep].sum()),
            pixels=cc3d.FramePixels(linear_index=lin, intensity=inten, root=table.root_lin),
            centers_of_mass=coms,
        )

    def process_frame(
        self, image_number: int, image: np.ndarray, want_com: bool = False
    ) -> FrameResult:
        tracing.at(image_number)
        return self.collect(image_number, self.dispatch(image), want_com)

    def process_frame_profiled(
        self, image_number: int, image: np.ndarray, want_com: bool = False
    ) -> tuple[FrameResult, dict]:
        """Synchronous per-stage timing of one frame (the reference's
        per-image CUDA-event breakdown, spotfinder.cc:1054-1087).  Each
        stage synchronises the device before the next is timed.  Stages:
        upload, kernel (threshold + packed words), compact, post (CC +
        table + filters) on the tiered path; upload and the fused device
        step otherwise."""
        timings: dict[str, float] = {}

        def tick(name, fn):
            t0 = time.perf_counter()
            out = fn()
            self._sync()
            timings[name] = (time.perf_counter() - t0) * 1e3
            return out

        img_dev = tick("upload", lambda: self._upload(image))
        if self.use_kernel and self.host_cc:
            pcw, count = tick("kernel", lambda: self._count_step(img_dev))
            tier = self._tier(image_number, int(count))
            pixels = tick("compact", lambda: compact_from_pcw(img_dev, pcw, max_pixels=tier))
            result = tick("post", lambda: self._collect_host(image_number, pixels, want_com))
            return result, timings
        device_result = tick(
            "kernel+compact+post (fused device step)", lambda: self._step(img_dev)
        )
        result = tick("collect", lambda: self.collect(image_number, device_result, want_com))
        return result, timings
