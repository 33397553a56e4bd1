"""Per-frame spotfinding on a torch device.

Counterpart of :mod:`ffs_tpu.spotfind` (its per-frame processor): the
dispersion threshold, compaction, 2D connected components, per-spot
statistics and filters for one frame, with the host receiving compact
per-pixel arrays.  Three forms of the step, chosen by the configuration:

* **fused** — everything on the device: the plain float64/float32 threshold
  (``ops.dispersion``) and dense compaction, or the packed kernel and
  ``compact_from_pcw``; then device CC (``ops.connected_components``).
  The f64 CLI default runs here.
* **tiered** — the packed kernel returns the frame's exact strong-pixel
  count first; compaction then runs at the smallest capacity tier that
  holds it, and the host C++ CC (ops.cc2d_host) labels.  The f32
  kernel path runs here.
* **hostcompact** — the device stops at the packed words; the host expands
  the set bits against its own frame copy (ops.compact_host).

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
from typing import Optional

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
from .ops.dispersion_packed import dispersion_packed_raw
from .ops.masking import resolution_mask


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
    # "host" ends the device's job at the packed words: the host expands
    # the set bits against its frame copy.  Needs the kernel path + host CC
    compact_backend: str = "device"  # "device" | "host"

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

    def host_compact_enabled(self, device: torch.device) -> bool:
        return (
            self.compact_backend == "host"
            and self.kernel_enabled(device)
            and self.host_cc_enabled(device)
        )


def config_from_dict(d: dict) -> SpotfindConfig:
    """The port's config from ``dataclasses.asdict`` of an
    :class:`ffs_tpu.spotfind.SpotfindConfig`: ``use_pallas`` becomes
    ``use_kernel`` and ``pallas_interpret`` (a Mosaic test hook) is dropped."""
    d = dict(d)
    d.pop("pallas_interpret", None)
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


class SpotfindProcessor:
    """Per-frame spotfinding step for a fixed detector configuration.

    ``config.compact_backend == "host"`` needs the kernel path (float32 on
    a CUDA device, or ``use_kernel=True``) and host CC: without them the
    constructor raises ValueError.  With the CLI's ``--precision f64`` that
    means the option stops the run rather than being ignored, as the JAX
    CLI's help would have it (ffs_tpu/spotfind.py:151-156 raises the same
    way).
    """

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
        self.host_compact = cfg.host_compact_enabled(self.device)
        if cfg.compact_backend == "host" and not self.use_kernel:
            raise ValueError(
                "compact_backend='host' expands the packed strong words on "
                "the host; it requires the kernel path (f32 precision on a "
                "CUDA device, or use_kernel=True)"
            )
        if cfg.compact_backend == "host" and not self.host_cc:
            raise ValueError(
                "compact_backend='host' produces host arrays; it cannot feed "
                "cc_backend='device' — use cc_backend 'host' or 'auto'"
            )
        # the JAX package runs its kernel path with x64 off, where the
        # separation filter evaluates in float32; float64 everywhere else
        self._sep_dtype = torch.float32 if self.use_kernel else torch.float64

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
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

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
        """Kernel step of the tiered/hostcompact paths: (pcw, exact count)."""
        pcw = self._packed(image)
        nwl = pcw.shape[-1] // 2
        return pcw, pcw[:, nwl - 1].sum()

    def _step(self, image: torch.Tensor):
        """The fused per-frame step (device CC unless host CC is on)."""
        cfg = self.config
        neighbors = None
        if self.use_kernel:
            pixels, nbu, nbd = compact_from_pcw(
                image, self._packed(image), max_pixels=cfg.max_strong_pixels,
                with_neighbors=True,
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
        """Batched collection needs the kernel path (the plain dense path has
        no packed words to segment)."""
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
        return self._batch_step(self._upload(images))

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
        frames = frames_from_planes(
            self._upload(planes), self.height, self.width,
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
        if self.host_compact:
            pcw, count = self._count_step(img_dev)
            return ("hostcompact", image, pcw, count)
        if self.use_kernel and self.host_cc:
            # tiered path: kernel now, compaction sized in collect()
            pcw, count = self._count_step(img_dev)
            return ("tiered", img_dev, pcw, count)
        return self._step(img_dev)

    def collect(self, image_number: int, device_result, want_com: bool = False) -> FrameResult:
        """Wait for a dispatched frame and assemble the host result."""
        tag = device_result[0]
        if isinstance(tag, str) and tag == "hostcompact":
            _, img_host, pcw, count = device_result
            return self._collect_hostcompact(image_number, img_host, pcw, int(count), want_com)
        if isinstance(tag, str) and tag == "tiered":
            _, img_dev, pcw, count = device_result
            tier = self._tier(image_number, int(count))
            pixels = compact_from_pcw(img_dev, pcw, max_pixels=tier)
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

    def _collect_hostcompact(
        self,
        image_number: int,
        img_host: np.ndarray,
        pcw: torch.Tensor,
        n: int,
        want_com: bool,
        timings: dict | None = None,
    ) -> FrameResult:
        """Host-compaction epilogue: copy the packed words to the host,
        expand the set bits against the host frame, label + tabulate there.
        ``timings`` (profiled path) receives 'compact' and 'post' ms."""
        from .ops.compact_host import compact_pcw_host

        if n > self.config.max_strong_pixels:
            raise _capacity_error(
                image_number, n, self.config.max_strong_pixels, "configured capacity"
            )
        t0 = time.perf_counter()
        lin, inten = compact_pcw_host(_host(pcw), img_host, self.width)
        t1 = time.perf_counter()
        result = self._collect_host(
            image_number,
            cc.CompactPixels(linear_index=lin, intensity=inten, count=n),
            want_com,
        )
        if timings is not None:
            timings["compact"] = (t1 - t0) * 1e3  # d2h + host bit scan
            timings["post"] = (time.perf_counter() - t1) * 1e3
        return result

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
        return self.collect(image_number, self.dispatch(image), want_com)

    def process_frame_profiled(
        self, image_number: int, image: np.ndarray, want_com: bool = False
    ) -> tuple[FrameResult, dict]:
        """Synchronous per-stage timing of one frame (the reference's
        per-image CUDA-event breakdown, spotfinder.cc:1054-1087).  Each
        stage synchronises the device before the next is timed.  Stages:
        upload, kernel (threshold + packed words), compact, post (CC +
        table + filters) on the tiered/hostcompact paths; upload and the
        fused device step otherwise."""
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
            n = int(count)
            if self.host_compact:
                result = self._collect_hostcompact(
                    image_number, image, pcw, n, want_com, timings=timings
                )
                return result, timings
            tier = self._tier(image_number, n)
            pixels = tick("compact", lambda: compact_from_pcw(img_dev, pcw, max_pixels=tier))
            result = tick("post", lambda: self._collect_host(image_number, pixels, want_com))
            return result, timings
        device_result = tick(
            "kernel+compact+post (fused device step)", lambda: self._step(img_dev)
        )
        result = tick("collect", lambda: self.collect(image_number, device_result, want_com))
        return result, timings
