"""Kabsch-frame foreground/background classification and accumulation.

Counterpart of :mod:`ffs_tpu.integration.kabsch` (reference:
integrator/kabsch.cu:60-675): for every (reflection, frame) pair, each
shoebox pixel's four voxel corners are mapped to scattered wavevectors and
tested against the Kabsch-space ellipsoid

    eps1^2/delta_b^2 + eps2^2/delta_b^2 + eps3^2/delta_m^2 <= 1

("ellipsoid" evaluates the low/high/centre phi slices; "dials" a single 2D
ellipse ignoring eps3).  Foreground pixels accumulate intensity sums and
centroid moments; background pixels accumulate a bounded 256-bin histogram
plus overflow count.

The blocked step runs on a torch device: reflections in z-ordered chunks of
``max_active``, frames in resident blocks of ``frame_block``; per chunk the
corner-field and mask windows are gathered once and the in-plane term e12
computed once, per (chunk, frame block) the frame windows are gathered
(``ops.window_gather``, the CUDA kernels on a GPU) and classified.  The
accumulators are the JAX package's bit for bit: every sum is an exact
integer or half-integer in float64, so the TPU's split-i32 moment dots
become int64 dots and its bf16 one-hot histogram an integer ``index_add_``
with the same values.  The TPU's lane-packed step layout is not carried
over: it is pinned to the classic step's outputs.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dispersion import widen_pixels
from ..ops.window_gather import window_gather, window_gather_planes
from ..utils.exact import dot3, norm3, quotient
from .background import NUM_BG_BINS


def _weighted_index_dot(vals: torch.Tensor, n: int) -> torch.Tensor:
    """Exact ``sum_j vals[:, j] * j`` as float64 for integer ``vals`` (A, n).

    The JAX package splits this dot into 13-bit halves so that every partial
    sum fits an int32 on the TPU; int64 holds the whole dot exactly (it
    stays below 2^53), so its float64 value is the same."""
    w = torch.arange(n, dtype=torch.int64, device=vals.device)
    return (vals.to(torch.int64) * w).sum(dim=1).to(torch.float64)


@dataclass
class Accumulators:
    """Global per-reflection accumulators (host resident)."""

    fg_sum: np.ndarray
    fg_count: np.ndarray
    sum_ix: np.ndarray  # sum I * (x + 0.5)
    sum_iy: np.ndarray
    sum_iz: np.ndarray
    bg_hist: np.ndarray  # (N, NUM_BG_BINS)
    bg_overflow: np.ndarray
    bg_count: np.ndarray

    @classmethod
    def zeros(cls, n: int) -> "Accumulators":
        return cls(
            fg_sum=np.zeros(n),
            fg_count=np.zeros(n, dtype=np.int64),
            sum_ix=np.zeros(n),
            sum_iy=np.zeros(n),
            sum_iz=np.zeros(n),
            bg_hist=np.zeros((n, NUM_BG_BINS), dtype=np.int64),
            bg_overflow=np.zeros(n, dtype=np.int64),
            bg_count=np.zeros(n, dtype=np.int64),
        )


def format_shoebox_fill_histogram(
    bboxes: np.ndarray, box_w: int, box_h: int, max_active: int
) -> str:
    """Shoebox occupancy diagnostic (reference: integrator/integrator.cc:
    76-153, logged at debug level at startup): reflection-image slices
    bucketed by the fill fraction of the padded (box_h, box_w) window each
    occupies in the device step, weighted by z-depth, with the overall slot
    utilisation.  Returns an empty string when nothing is integrable."""
    buckets = [
        (0.75, 1.01, ">=75%"),
        (0.50, 0.75, "50-75"),
        (0.25, 0.50, "25-50"),
        (0.10, 0.25, "10-25"),
        (0.00, 0.10, " <10%"),
    ]
    counts = [0] * len(buckets)
    slot_px = box_w * box_h
    total_slices = 0
    total_px = 0
    for bbox in np.asarray(bboxes, dtype=np.int64):
        npix = int((bbox[1] - bbox[0] + 1) * (bbox[3] - bbox[2] + 1))
        # z_max is EXCLUSIVE throughout (extent.py ceil/act_f > z)
        depth = int(bbox[5] - bbox[4])
        if npix <= 0 or depth <= 0:
            continue
        fill = min(npix / slot_px, 1.0)
        for b, (lo, hi, _label) in enumerate(buckets):
            if lo <= fill < hi:
                counts[b] += depth
                break
        total_slices += depth
        total_px += npix * depth
    if total_slices == 0:
        return ""
    bar_width = 24
    peak = max(counts)
    out = (
        f"Shoebox fill over {total_slices} reflection-image slices "
        f"({box_w}x{box_h} padded windows, {max_active}/step):"
    )
    for (lo, hi, label), c in zip(buckets, counts):
        fill_n = (c * bar_width + peak - 1) // peak if peak else 0
        bar = "#" * fill_n + "." * (bar_width - fill_n)
        out += f"\n  {label}  {bar}  {100.0 * c / total_slices:5.1f}%  ({c})"
    out += (
        f"\n  avg {total_px / total_slices:.0f} px/slice, "
        f"{100.0 * total_px / (total_slices * slot_px):.0f}% window utilisation"
    )
    return out


class KabschIntegrator:
    """Owns the blocked classification step on one torch device."""

    def __init__(
        self,
        *,
        panel,
        beam,
        gonio,
        scan,
        s1: np.ndarray,  # (N, 3) predicted s1 at reflection centres
        phi: np.ndarray,  # (N,) predicted phi (radians)
        bboxes: np.ndarray,  # (N, 6) x_min,x_max,y_min,y_max,z_min,z_max
        delta_b: float,
        delta_m: float,
        algorithm: str = "ellipsoid",
        # the window only has to COVER the bbox (rows 0..heights.max, so
        # heights.max+1 rows before the 8-multiple round-up); everything
        # past the bbox is masked by in_bbox
        box_pad: int = 1,
        max_active: int = 512,  # reflections per device step (padded chunk)
        frame_block: int = 4,  # resident frames per step
        device: torch.device | None = None,
    ):
        if device is None:
            from ..utils.torchinit import select_device

            device = select_device()
        self.device = torch.device(device)
        self.panel = panel
        self.scan = scan
        self.s1 = np.asarray(s1, dtype=np.float64)
        self.phi = np.asarray(phi, dtype=np.float64)
        # own copy (np.array, not asarray): the x/y clip below must never
        # mutate the caller's array
        self.bboxes = np.array(bboxes, dtype=np.int64)
        self.algorithm = algorithm
        self.max_active = max_active
        self.frame_block = frame_block

        # clip x/y to the detector: off-panel extents would otherwise reach
        # the window gathers as out-of-contract offsets
        w_img, h_img = int(panel.image_size[0]), int(panel.image_size[1])
        self.bboxes[:, 0] = np.clip(self.bboxes[:, 0], 0, w_img - 1)
        self.bboxes[:, 1] = np.clip(self.bboxes[:, 1], 0, w_img - 1)
        self.bboxes[:, 2] = np.clip(self.bboxes[:, 2], 0, h_img - 1)
        self.bboxes[:, 3] = np.clip(self.bboxes[:, 3], 0, h_img - 1)

        widths = self.bboxes[:, 1] - self.bboxes[:, 0]
        heights = self.bboxes[:, 3] - self.bboxes[:, 2]
        # the step's pixel window is a fixed 128 columns starting at x_min,
        # and each pixel's right corner comes from a roll that wraps at
        # column 127: widths past 127 would silently drop columns
        wmax = int(widths.max(initial=0)) + 1
        if wmax > 127:
            raise ValueError(
                f"shoebox width {wmax} exceeds the blocked step's 128-lane "
                "window (pixel lanes span x_min..x_min+127 and the corner "
                "roll wraps at lane 127); shrink delta_b or the bboxes"
            )
        self.box_w = int(((max(int(widths.max(initial=1)), 1) + box_pad) + 7) // 8 * 8)
        self.box_h = int(((max(int(heights.max(initial=1)), 1) + box_pad) + 7) // 8 * 8)
        # exact extents of the occupied window region (rows 0..heights[a],
        # columns 0..widths[a]): the histogram reads only these, everything
        # outside is masked by in_bbox
        self._hist_rows = min(int(heights.max(initial=0)) + 1, self.box_h)
        self._hist_lanes = min(int(widths.max(initial=0)) + 1, 128)

        self._s0 = np.asarray(beam.s0, dtype=np.float64)
        self._m2 = gonio.rotation_axis / np.linalg.norm(gonio.rotation_axis)
        self._wl = float(beam.wavelength)
        self._fast = np.asarray(panel.fast_axis, dtype=np.float64)
        self._slow = np.asarray(panel.slow_axis, dtype=np.float64)
        self._origin = np.asarray(panel.origin, dtype=np.float64)
        self._px = float(panel.pixel_size[0])
        self._py = float(panel.pixel_size[1])
        self._parallax = bool(panel.parallax and panel.mu > 0)
        self._mu = float(panel.mu)
        self._t0 = float(panel.thickness)
        normal = np.cross(panel.fast_axis, panel.slow_axis)
        if np.dot(panel.origin, normal) < 0:
            normal = -normal
        self._normal = normal / np.linalg.norm(normal)
        self._delta_b = float(delta_b)
        self._delta_m = float(delta_m)

        self._field6 = None
        self._mask_canvas = None
        self._panel_w = w_img
        self._panel_h = h_img
        # how many chunk set-ups and block steps ran (each set-up gathers
        # the corner-field and mask windows once, each step the frames)
        self.chunk_setups = 0
        self.block_steps = 0

    # --- detector-wide corner geometry ----------------------------------------

    def corner_field(self) -> torch.Tensor:
        """Detector-wide corner scattered-wavevector field: (3, H+box_h+1,
        W+box_w+1) float64 of s_pixel at every pixel corner the shoebox
        windows can touch, on the device.  Built from scratch on each call;
        the step reads its float32 split (:meth:`corner_field_f32`)."""
        w = self._panel_w + self.box_w + 1
        h = self._panel_h + self.box_h + 1
        cx = torch.arange(w, dtype=torch.float64, device=self.device)[None, :].expand(h, w)
        cy = torch.arange(h, dtype=torch.float64, device=self.device)[:, None].expand(h, w)
        return torch.movedim(self._corner_s_pixel(cx, cy), -1, 0)

    def _corner_s_pixel(self, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
        """Scattered unit wavevector / wavelength at pixel corner (cx, cy)
        (reference: kabsch.cu:174-258, incl. parallax px_to_mm)."""
        dev = cx.device
        fast = torch.as_tensor(self._fast, device=dev)
        slow = torch.as_tensor(self._slow, device=dev)
        origin = torch.as_tensor(self._origin, device=dev)
        x1 = cx * self._px
        x2 = cy * self._py
        if self._parallax:
            lab0 = origin + x1[..., None] * fast + x2[..., None] * slow
            s1_hat = lab0 / norm3(lab0)[..., None]
            cos_t = dot3(s1_hat, self._normal)
            o = (1.0 / self._mu) - (self._t0 / cos_t + 1.0 / self._mu) * torch.exp(
                -self._mu * self._t0 / cos_t
            )
            x1 = x1 - dot3(s1_hat, self._fast) * o
            x2 = x2 - dot3(s1_hat, self._slow) * o
        lab = origin + x1[..., None] * fast + x2[..., None] * slow
        return quotient(lab / norm3(lab)[..., None], self._wl)

    def corner_field_f32(self) -> torch.Tensor:
        """(6, Hc, Wc) float32 hi/lo split of :meth:`corner_field`, padded so
        window column starts satisfy the gather contract; built once."""
        if self._field6 is None:
            f64 = self.corner_field()  # (3, h, w)
            _, h, w = f64.shape
            # padding: x0 + box_w <= w - 128 must hold for the gather
            wp = ((w + self.box_w + 128 + 127) // 128) * 128
            hp = ((h + self.box_h + 8 + 7) // 8) * 8
            fp = torch.nn.functional.pad(f64, (0, wp - w, 0, hp - h))
            del f64
            hi = fp.to(torch.float32)
            lo = (fp - hi.to(torch.float64)).to(torch.float32)
            del fp
            self._field6 = torch.cat([hi, lo], dim=0)
        return self._field6

    # --- frame-invariant detector mask ------------------------------------------

    def set_mask(self, det_mask: np.ndarray) -> None:
        """Upload the (frame-invariant) detector mask canvas once."""
        hp = det_mask.shape[0] + self.box_h
        wp = ((det_mask.shape[1] + 255) // 128) * 128
        pad = np.zeros((hp, wp), np.int32)
        pad[: det_mask.shape[0], : det_mask.shape[1]] = det_mask.astype(np.int32)
        self._mask_canvas = torch.from_numpy(pad).to(self.device)

    def _mask_windows(self, y0: np.ndarray, x0: np.ndarray) -> torch.Tensor | None:
        """Detector-mask windows for a chunk (frame-invariant)."""
        if self._mask_canvas is None:
            return None  # set_mask not called: treat all pixels valid
        return window_gather(self._mask_canvas, y0, x0, bh=self.box_h)

    def pad_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """A (F, H, W) frame stack on the device (uint16, uint32, int32 or
        float64 counts) widened into the int32 gather canvas (F, H+box_h,
        Wp)."""
        f, h, w = frames.shape
        wp = ((w + 255) // 128) * 128
        out = torch.zeros((f, h + self.box_h, wp), dtype=torch.int32, device=frames.device)
        out[:, :h, :w] = widen_pixels(frames).to(torch.int32)
        return out

    # --- blocked device step --------------------------------------------------

    def _chunk_setup(self, chunk: np.ndarray, cs_e1, cs_e2, zeta, *, width=None) -> dict:
        """Device-resident per-chunk constants: the in-plane Kabsch term e12
        from the gathered corner-field windows, the mask windows and the
        parameter arrays, padded to ``width`` rows (``max_active`` by
        default).  Cached by :meth:`integrate` for the chunk's whole
        z-span, so the corner geometry amortises across the block steps."""
        self.chunk_setups += 1
        a = len(chunk)
        pad_n = (self.max_active if width is None else width) - a

        def padi(v, fill=0):
            return np.concatenate([v, np.full((pad_n,) + v.shape[1:], fill, v.dtype)])

        x0 = padi(self.bboxes[chunk, 0])
        y0 = padi(self.bboxes[chunk, 2])
        dev = self.device
        chunk_dev = {
            "x0_host": x0,
            "y0_host": y0,
            "x0": torch.from_numpy(x0).to(dev),
            "y0": torch.from_numpy(y0).to(dev),
            "bbox": torch.from_numpy(padi(self.bboxes[chunk])).to(dev),
            "s1": torch.from_numpy(padi(self.s1[chunk])).to(dev),
            "phi": torch.from_numpy(padi(self.phi[chunk])).to(dev),
            "e1": torch.from_numpy(padi(cs_e1[chunk])).to(dev),
            "e2": torch.from_numpy(padi(cs_e2[chunk])).to(dev),
            "zeta": torch.from_numpy(padi(zeta[chunk])).to(dev),
            "active": torch.from_numpy(padi(np.ones(a, dtype=bool), False)).to(dev),
        }
        # corner-field windows: one window per reflection over the 6 hi/lo
        # planes; rows start at y0 (the corner grid needs bh+1 rows, so
        # bh+8 are gathered), columns at x0 (corners x0..x0+bw < x0+128)
        fieldw = window_gather_planes(self.corner_field_f32(), y0, x0, bh=self.box_h + 8)
        chunk_dev["e12"] = self._e12_from_fieldw(
            fieldw, chunk_dev["s1"], chunk_dev["e1"], chunk_dev["e2"]
        )
        chunk_dev["maskw"] = self._mask_windows(y0, x0)
        return chunk_dev

    def _e12_from_fieldw(self, fieldw, s1_c, e1, e2) -> torch.Tensor:
        """(A, bh+1, 128) float32 in-plane Kabsch term from the hi/lo corner
        field windows.  delta = (hi - s1hi) + (lo - s1lo) is accurate to
        ~2^-24 relative to delta, so the float32 projections carry
        float64-grade classification boundaries.  The projections are
        explicit products summed in k = 0, 1, 2 order (no matmul route)."""
        s1_hi = s1_c.to(torch.float32)
        s1_lo = (s1_c - s1_hi.to(torch.float64)).to(torch.float32)
        delta = (fieldw[:, 0:3] - s1_hi[:, :, None, None]) + (
            fieldw[:, 3:6] - s1_lo[:, :, None, None]
        )  # (A, 3, bh+8, 128) float32
        s1_len = norm3(s1_c)
        e1n = (e1 / s1_len[:, None]).to(torch.float32)
        e2n = (e2 / s1_len[:, None]).to(torch.float32)

        def project(en):
            return (
                delta[:, 0] * en[:, 0, None, None]
                + delta[:, 1] * en[:, 1, None, None]
                + delta[:, 2] * en[:, 2, None, None]
            )

        eps1 = project(e1n)
        eps2 = project(e2n)
        e12 = quotient(eps1 * eps1 + eps2 * eps2, float(np.float32(self._delta_b**2)))
        return e12[:, : self.box_h + 1, :].contiguous()  # corner rows 0..bh

    def _block_step_impl(
        self,
        frames,  # (F, Hp, Wp) int32 padded resident frames
        chunk_dev: dict,  # _chunk_setup
        phi_lows,  # (F,) phi at each frame's start (radians)
        d_osc: float,  # oscillation width (radians)
        z_values,  # (F,) frame numbers
        frame_ok,  # (F,) bool: frame present (tail padding)
        centre_slices: bool,
    ):
        self.block_steps += 1
        windows = window_gather_planes(
            frames, chunk_dev["y0_host"], chunk_dev["x0_host"], bh=self.box_h
        )  # (A, F, bh, 128) int32
        return self._finish_block_step(
            windows, chunk_dev["e12"], chunk_dev["maskw"], chunk_dev["x0"], chunk_dev["y0"],
            chunk_dev["bbox"], chunk_dev["phi"], chunk_dev["zeta"], chunk_dev["active"],
            phi_lows, d_osc, z_values, frame_ok, centre_slices=centre_slices,
        )

    def _finish_block_step(
        self, windows, e12, maskw, x0, y0, bbox, phi_c, zeta, active,
        phi_lows, d_osc, z_values, frame_ok, centre_slices,
    ):
        """Everything after the window gather: classification and the eight
        frame-summed accumulators of one (chunk, frame block) step."""
        dev = windows.device
        A = x0.shape[0]
        bh = self.box_h
        F = windows.shape[1]
        lanes = 128

        px = x0[:, None] + torch.arange(lanes, device=dev)[None, :]  # (A, 128)
        py = y0[:, None] + torch.arange(bh, device=dev)[None, :]  # (A, bh)
        in_bbox = (
            (px[:, None, :] >= bbox[:, 0, None, None])
            & (px[:, None, :] <= bbox[:, 1, None, None])
            & (py[:, :, None] >= bbox[:, 2, None, None])
            & (py[:, :, None] <= bbox[:, 3, None, None])
        )
        if maskw is not None:
            in_bbox = in_bbox & (maskw != 0)
        # frame-invariant valid-pixel count: bg_count and overflow derive
        # from it below
        in_bbox_count = in_bbox.sum(dim=(1, 2), dtype=torch.int64)

        dm2 = self._delta_m**2
        neg_inf = torch.tensor(-np.inf, dtype=torch.float32, device=dev)
        one = torch.tensor(1.0, dtype=torch.float32, device=dev)

        def t_of(phi_eval):
            eps3 = zeta * (phi_eval - phi_c)
            return (1.0 - quotient(eps3 * eps3, dm2)).to(torch.float32)

        # outputs are summed over the block's frames on the device: every
        # quantity is an exact integer or half-integer in float64 (< 2^53),
        # so the order of the sums cannot change a bit
        fg_sum_t = torch.zeros(A, dtype=torch.float64, device=dev)
        fg_count_t = torch.zeros(A, dtype=torch.int64, device=dev)
        dot_x_t = torch.zeros(A, dtype=torch.float64, device=dev)
        dot_y_t = torch.zeros(A, dtype=torch.float64, device=dev)
        sum_iz_t = torch.zeros(A, dtype=torch.float64, device=dev)
        valid_count_t = torch.zeros(A, dtype=torch.int64, device=dev)
        bg_slices = []
        for f in range(F):
            phi_low = phi_lows[f]
            phi_high = phi_lows[f] + d_osc
            if self.algorithm == "dials":
                corner_in = e12 <= 1.0
            else:
                # the three phi-slice tests fold into one compare against
                # the per-reflection max threshold (monotone compare;
                # t_c = 1.0 since eps3(phi_c) = 0)
                t = torch.maximum(t_of(phi_low), t_of(phi_high))
                if centre_slices:
                    centre_ok = (phi_c >= torch.minimum(phi_low, phi_high)) & (
                        phi_c <= torch.maximum(phi_low, phi_high)
                    )
                    t = torch.maximum(t, torch.where(centre_ok, one, neg_inf))
                corner_in = e12 <= t[:, None, None]
            fg4 = corner_in[:, :-1, :] | corner_in[:, 1:, :]
            # corner c and c+1 for pixel column c
            fg = fg4 | torch.roll(fg4, -1, dims=2)
            act_f = (
                active
                & frame_ok[f]
                & (bbox[:, 4] <= z_values[f])
                & (bbox[:, 5] > z_values[f])
            )
            valid_px = in_bbox & act_f[:, None, None]
            fg = fg & valid_px
            bg = (~fg) & valid_px

            ivals = torch.clamp_min(windows[:, f], 0)
            mi = torch.where(fg, ivals, 0).to(torch.int64)
            colsum = mi.sum(dim=1)  # (A, 128)
            rowsum = mi.sum(dim=2)  # (A, bh)
            fg_sum = colsum.sum(dim=1).to(torch.float64)
            fg_sum_t = fg_sum_t + fg_sum
            fg_count_t = fg_count_t + fg.sum(dim=(1, 2), dtype=torch.int64)
            dot_x_t = dot_x_t + _weighted_index_dot(colsum, lanes)
            dot_y_t = dot_y_t + _weighted_index_dot(rowsum, bh)
            sum_iz_t = sum_iz_t + fg_sum * (z_values[f] + 0.5)
            valid_count_t = valid_count_t + torch.where(act_f, in_bbox_count, 0)
            bg_slices.append(bg[:, : self._hist_rows, : self._hist_lanes])

        sum_ix = (x0.to(torch.float64) + 0.5) * fg_sum_t + dot_x_t
        sum_iy = (y0.to(torch.float64) + 0.5) * fg_sum_t + dot_y_t

        # background histogram over the whole frame block, on the exact
        # occupied window extents: bin a*257 + value for in-range background
        # pixels, the spare bin 256 for everything else
        hr, hl = self._hist_rows, self._hist_lanes
        bg_s = torch.stack(bg_slices, dim=1)  # (A, F, hr, hl)
        iv_s = torch.clamp_min(windows[:, :, :hr, :hl], 0)
        in_range = bg_s & (iv_s < NUM_BG_BINS)
        nb = NUM_BG_BINS + 1
        bins = torch.where(in_range, iv_s, NUM_BG_BINS).to(torch.int64)
        bins = bins + (torch.arange(A, device=dev) * nb)[:, None, None, None]
        hist = torch.zeros(A * nb, dtype=torch.int64, device=dev)
        hist.index_add_(0, bins.reshape(-1), torch.ones(bins.numel(), dtype=torch.int64, device=dev))
        hist = hist.reshape(A, nb)[:, :NUM_BG_BINS]
        # derived counts: every valid pixel is fg or bg, and every in-range
        # bg pixel lands in exactly one histogram bin
        bg_count = valid_count_t - fg_count_t
        overflow = bg_count - hist.sum(dim=1)
        return fg_sum_t, fg_count_t, sum_ix, sum_iy, sum_iz_t, hist, overflow, bg_count

    # --- host loop -----------------------------------------------------------

    def integrate(self, reader, image_numbers, acc: Accumulators, depth: int = 3) -> None:
        """Stream frames through the blocked classification step.

        Reflections are chunked in z order; frames stream through
        device-resident blocks of ``frame_block``; each (chunk, frame block)
        pair touching in z runs one step, whose frame windows arrive by one
        gather across the block's frames per reflection and whose corner
        geometry is cached per chunk for its whole z-span.  Up to ``depth``
        steps stay queued on the device before their outputs are collected,
        so host reading and accumulation overlap the device.
        """
        osc_start, osc_width = self.scan.oscillation
        z0 = self.scan.image_range[0]
        cs_e1 = np.cross(self.s1, self._s0)
        cs_e1 /= np.linalg.norm(cs_e1, axis=1, keepdims=True)
        cs_e2 = np.cross(self.s1, cs_e1)
        cs_e2 /= np.linalg.norm(cs_e2, axis=1, keepdims=True)
        zeta = cs_e1 @ self._m2

        # static z-ordered chunks; chunks are never empty, so min/max need
        # no initial value (an initial 0 would pin every chunk's zmin to 0)
        order = np.argsort(self.bboxes[:, 4], kind="stable")
        chunks = [order[i : i + self.max_active] for i in range(0, len(order), self.max_active)]
        chunk_zmin = np.array([self.bboxes[c, 4].min() for c in chunks])
        chunk_zmax = np.array([self.bboxes[c, 5].max() for c in chunks])
        cache: dict[int, dict] = {}

        det_mask = reader.get_mask()
        if det_mask is not None and self._mask_canvas is None:
            self.set_mask(np.asarray(det_mask))

        image_numbers = list(image_numbers)
        F = self.frame_block
        d_osc = float(np.deg2rad(osc_width))
        dev = self.device
        inflight: deque = deque()

        def collect_one():
            chunk, a, out = inflight.popleft()
            arrs = [v.cpu().numpy() for v in out]  # frame-summed on device
            acc.fg_sum[chunk] += arrs[0][:a]
            acc.fg_count[chunk] += arrs[1][:a]
            acc.sum_ix[chunk] += arrs[2][:a]
            acc.sum_iy[chunk] += arrs[3][:a]
            acc.sum_iz[chunk] += arrs[4][:a]
            acc.bg_hist[chunk] += arrs[5][:a]
            acc.bg_overflow[chunk] += arrs[6][:a]
            acc.bg_count[chunk] += arrs[7][:a]

        for b0 in range(0, len(image_numbers), F):
            blk = image_numbers[b0 : b0 + F]
            n_blk = len(blk)
            z_lo, z_hi = min(blk), max(blk)
            touching = [
                ci
                for ci in range(len(chunks))
                if chunk_zmin[ci] <= z_hi and chunk_zmax[ci] > z_lo
            ]
            if not touching:
                continue
            frames_np = np.stack([np.asarray(reader.get_image(n)) for n in blk])
            if frames_np.dtype.itemsize > 2:
                # the step's exact-integer sums (int32 windows, and the
                # JAX package's split-i32 moment dots: val < 2^26) hold for
                # any 16-bit data but not for arbitrary 32-bit values
                vmax = int(frames_np.max())
                limit = min(2**26 - 1, (2**31 - 1) // (self._hist_rows * self._hist_lanes))
                if vmax > limit:
                    raise ValueError(
                        f"frame block {blk[0]}..{blk[-1]} has pixel value"
                        f" {vmax} > {limit}, beyond the integrator's"
                        " exact-i32 accumulation bound for"
                        f" {self._hist_rows}x{self._hist_lanes} shoeboxes;"
                        " mask or clip saturated pixels upstream"
                    )
            frames = self.pad_frames(torch.from_numpy(frames_np).to(dev))
            if n_blk < F:  # a short last block: zero frames, masked by frame_ok
                frames = torch.cat([frames, frames.new_zeros((F - n_blk,) + frames.shape[1:])])
            # z/phi from the actual image numbers (gapped or reordered
            # entries classify against their own angles); pad entries get z
            # past the block (masked by frame_ok, never aliasing a frame)
            blk_pad = np.asarray(list(blk) + [z_hi + 1 + i for i in range(F - n_blk)], np.float64)
            phi_lows = torch.from_numpy(np.deg2rad(osc_start + (blk_pad - (z0 - 1)) * osc_width)).to(dev)
            z_values = torch.from_numpy(blk_pad).to(dev)
            frame_ok = torch.from_numpy(np.arange(F) < n_blk).to(dev)

            for ci in touching:
                if ci not in cache:
                    cache[ci] = self._chunk_setup(chunks[ci], cs_e1, cs_e2, zeta)
                out = self._block_step_impl(
                    frames, cache[ci], phi_lows, d_osc, z_values, frame_ok, centre_slices=True
                )
                inflight.append((chunks[ci], len(chunks[ci]), out))
                while len(inflight) > depth:
                    collect_one()
            # evict chunks whose z-span has passed
            for ci in list(cache):
                if chunk_zmax[ci] <= z_hi + 1:
                    del cache[ci]

        while inflight:
            collect_one()
