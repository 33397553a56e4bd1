"""integrator CLI on PyTorch — summation integration.

Counterpart of :mod:`ffs_tpu.pipeline.integrator` (reference GPU
`integrator`, integrator/integrator.cc:320-1334) with the same flags, log
lines, ``--profile`` stage names and ``integrated.refl`` columns: sigma
estimation unless given; prediction if the table is not predicted (on the
device, :mod:`..prediction.rotation`); Kabsch bounding boxes; the blocked
foreground/background classification on the device (:mod:`..integration.
kabsch`, whose window gathers are CUDA kernels on a GPU); background
reduction over the bounded histograms and finalisation on the host, or, with
``--bg-device``, the bounding boxes, the background and the finalisation on
the device too (:func:`..integration.extent.
compute_kabsch_bounding_boxes_device`, :mod:`..integration.
background_device`, :func:`..integration.finalize.finalize_device`).

:func:`integrate_experiment` is the core: it takes the loaded experiment,
the table's columns and a frame reader and returns the output columns, so
that it runs without the h5py file I/O that :func:`run` wraps around it.

Console script: ``integrator_torch``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

class _StreamingReader:
    """Availability-waiting, prefetching facade over a frame reader.

    Honors the CLI's ``--timeout`` (wait for frames a live collection
    hasn't written yet) and ``--threads`` (a decode pool prefetching
    upcoming frames so host reading and decompression overlap the device
    steps; reference: integrator.cc:820-991)."""

    def __init__(self, reader, image_numbers, timeout=30.0, threads=0):
        from concurrent.futures import ThreadPoolExecutor

        self._r = reader
        self._timeout = float(timeout)
        self._order = list(image_numbers)
        self._pos = {n: i for i, n in enumerate(self._order)}
        self._threads = int(threads)
        self._ex = ThreadPoolExecutor(self._threads) if self._threads > 0 else None
        self._futs: dict = {}

    def get_mask(self):
        return self._r.get_mask()

    def get_number_of_images(self):
        return self._r.get_number_of_images()

    def _fetch(self, n):
        avail = getattr(self._r, "is_image_available", None)
        if avail is not None:
            deadline = time.monotonic() + self._timeout
            while not avail(n):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"timed out after {self._timeout:g} s waiting for image {n}"
                    )
                time.sleep(0.1)
        return self._r.get_image(n)

    def get_image(self, n):
        if self._ex is None:
            return self._fetch(n)
        i = self._pos.get(n)
        ahead = [n] if i is None else self._order[i : i + 1 + self._threads]
        for m in ahead:
            if m not in self._futs:
                self._futs[m] = self._ex.submit(self._fetch, m)
        return self._futs.pop(n).result()

    def close(self):
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
        if hasattr(self._r, "close"):
            self._r.close()


@dataclass
class IntegrationRun:
    """What :func:`integrate_experiment` returns: the output columns of
    ``integrated.refl`` (in the JAX CLI's order), the accumulators, and the
    integrator that filled them."""

    columns: dict
    acc: object
    integrator: object


def integrate_experiment(
    expt,
    table,
    reader,
    *,
    device,
    sigma_b: float | None = None,
    sigma_m: float | None = None,
    min_bbox_depth: int = 6,
    algorithm: str = "ellipsoid",
    background: str = "constant",
    bg_device: bool = False,
    min_zeta: float = 0.05,
    sv=None,
    threads: int = 0,
    timeout: float = 30.0,
    profile: bool = False,
    mark=lambda stage: None,
) -> IntegrationRun:
    """Integrate ``table`` (a mapping of reflection columns) against the
    frames of ``reader`` for the loaded experiment ``expt`` on ``device``.

    Both ``sigma_b`` and ``sigma_m`` (radians) or neither: the sigmas are
    estimated from the table unless both are given.  ``bg_device`` runs
    the bounding boxes, the background (but for ``dials``) and the
    finalisation on ``device`` as well.  ``sv`` holds the
    scan-varying model states for prediction (or None); ``mark(stage)`` is
    called at the end of the stages the CLI's ``--profile`` reports
    (sigma+predict, bbox+setup, kabsch, background).  Prints the CLI's log
    lines."""
    from ..integration import background as bg_mod
    from ..integration import extent as extent_mod
    from ..integration import finalize as fin_mod
    from ..integration import kabsch as kabsch_mod
    from ..integration.background_device import estimate_background_device
    from ..integration.sigma import estimate_sigmas
    from ..models.reflection_table import INTEGRATED_SUM, PREDICTED
    from ..prediction.rotation import predict_rotation

    # sigma estimation (integrator.cc:397-444)
    if sigma_b is None or sigma_m is None:
        sigma_b, sigma_m = estimate_sigmas(table, expt, min_bbox_depth)
    print(f"Using sigma_b={np.degrees(sigma_b):.6f} deg, sigma_m={np.degrees(sigma_m):.6f} deg")

    # reuse predictions if flagged, else predict (integrator.cc:446-527)
    flags = np.asarray(table["flags"], np.uint64) if "flags" in table else None
    if (
        flags is not None
        and "s1" in table
        and "xyzcal.mm" in table
        and "miller_index" in table
        and ((flags & PREDICTED) != 0).any()
    ):
        sel = (flags & PREDICTED) != 0
        s1 = np.asarray(table["s1"], np.float64)[sel]
        phi = np.asarray(table["xyzcal.mm"], np.float64)[sel][:, 2]
        xyzcal_mm = np.asarray(table["xyzcal.mm"], np.float64)[sel]
        hkl = np.asarray(table["miller_index"], np.int64)[sel]
        ids = np.asarray(table["id"])[sel] if "id" in table else np.zeros(sel.sum(), np.int64)
    else:
        print("Monochromatic scan-varying prediction" if sv else "Monochromatic static prediction")
        pred = predict_rotation(expt, sv, device=device)
        s1 = pred.s1
        xyzcal_mm = pred.xyzcal_mm
        phi = pred.xyzcal_mm[:, 2]
        hkl = pred.hkl
        ids = np.zeros(len(s1), np.int64)
    n = len(s1)
    print(f"Integrating {n} reflections")
    mark("sigma+predict")

    # bounding boxes + coordinate systems + min_zeta skip
    bbox_args = (expt.beam.s0, expt.goniometer.rotation_axis, s1, phi, sigma_b, sigma_m,
                 expt.panel, expt.scan)
    if bg_device:
        bboxes = extent_mod.compute_kabsch_bounding_boxes_device(*bbox_args, device=device)
    else:
        bboxes = extent_mod.compute_kabsch_bounding_boxes(*bbox_args)
    cs = extent_mod.coordinate_systems(
        expt.beam.s0,
        expt.goniometer.rotation_axis / np.linalg.norm(expt.goniometer.rotation_axis),
        s1,
    )
    integrate_sel = np.abs(cs.zeta) >= min_zeta
    n_skipped = int((~integrate_sel).sum())
    if n_skipped:
        print(f"min_zeta={min_zeta:g}: skipping {n_skipped} of {n} reflections")

    # clip bboxes to the detector (off-panel pixels cannot contribute)
    w, h = expt.panel.image_size
    bboxes[:, 0] = np.clip(bboxes[:, 0], 0, w - 1)
    bboxes[:, 1] = np.clip(bboxes[:, 1], 0, w - 1)
    bboxes[:, 2] = np.clip(bboxes[:, 2], 0, h - 1)
    bboxes[:, 3] = np.clip(bboxes[:, 3], 0, h - 1)

    delta_b = extent_mod.DEFAULT_N_SIGMA * sigma_b * extent_mod.DEFAULT_SIGMA_B_MULTIPLIER
    delta_m = extent_mod.DEFAULT_N_SIGMA * sigma_m

    # min_zeta-skipped reflections get an empty sentinel bbox (shared by
    # the integrator and the fill-histogram diagnostic below)
    masked_bboxes = np.where(integrate_sel[:, None], bboxes, np.array([[0, -1, 0, -1, 0, -1]]))
    integ = kabsch_mod.KabschIntegrator(
        panel=expt.panel,
        beam=expt.beam,
        gonio=expt.goniometer,
        scan=expt.scan,
        s1=s1,
        phi=phi,
        bboxes=masked_bboxes,
        delta_b=delta_b,
        delta_m=delta_m,
        algorithm=algorithm,
        # 2048-reflection chunks amortise the per-step fixed work
        max_active=min(2048, max(128, (int(integrate_sel.sum()) + 127) // 128 * 128)),
        device=device,
    )
    # shoebox occupancy diagnostic (reference: integrator.cc:76-153,630-634)
    if profile or os.environ.get("LOG_LEVEL", "").lower() in ("debug", "trace"):
        hist = kabsch_mod.format_shoebox_fill_histogram(
            masked_bboxes, integ.box_w, integ.box_h, integ.max_active
        )
        if hist:
            print(hist)
    mark("bbox+setup")

    acc = kabsch_mod.Accumulators.zeros(n)
    z0, z1 = expt.scan.image_range
    n_images = min(z1 - z0 + 1, reader.get_number_of_images())
    image_numbers = range(z0 - 1, z0 - 1 + n_images)
    stream = _StreamingReader(reader, image_numbers, timeout=timeout, threads=threads)
    try:
        integ.integrate(stream, image_numbers, acc)
    finally:
        stream.close()
    mark("kabsch")

    fin_mod.check_overflow(acc.bg_count, acc.bg_overflow)
    bg_model = {"constant": "tukey", "glm": "glm", "dials": "dials"}[background]
    if bg_device and bg_model == "dials":
        # the dials cross-check variant is host-only by design (it exists
        # to check the device and shared reductions independently)
        print("note: --background dials runs on host; ignoring --bg-device for the background stage")
    if bg_device and bg_model != "dials":
        # the whole reflection batch as (N, bins) tensor operations
        # (reference: integrator/background.cu:29-99)
        bg_mean, bg_wsum, bg_valid = estimate_background_device(
            acc.bg_hist, acc.bg_overflow, bg_model, device=device
        )
    else:
        bg_mean, bg_wsum, bg_valid = bg_mod.estimate_background(
            acc.bg_hist, acc.bg_overflow, bg_model
        )
    mark("background")
    finalize = fin_mod.finalize
    if bg_device:
        finalize = functools.partial(fin_mod.finalize_device, device=device)
    result = finalize(
        acc=acc,
        bg_mean=bg_mean,
        bg_wsum=bg_wsum,
        bg_valid=bg_valid,
        bboxes=bboxes,
        s1=s1,
        phi=phi,
        hkl=hkl,
        zeta=cs.zeta,
        scan=expt.scan,
        beam=expt.beam,
        gonio=expt.goniometer,
        crystal=expt.crystal,
        sigma_m=sigma_m,
    )
    n_valid = int(result.valid.sum())
    print(f"Summation integration complete: {n_valid} valid reflections out of {n}")
    if result.n_background_failures:
        print(
            f"Background estimate rejected for {result.n_background_failures} "
            f"of {n} reflections with foreground pixels"
        )
    if n_valid:
        ints = result.intensity[result.valid]
        sig = np.sqrt(np.maximum(result.variance[result.valid], 0))
        print(
            f"Intensity statistics: min={ints.min():.1f}, max={ints.max():.1f}, "
            f"mean={ints.mean():.1f}"
        )
        pos = sig > 0
        if pos.any():
            print(f"Mean I/sigma(I)={np.mean(ints[pos] / sig[pos]):.2f}")

    columns = {
        "intensity.sum.value": result.intensity,
        "intensity.sum.variance": np.where(result.variance < 0, 0.0, result.variance),
        "partiality": result.partiality,
        "miller_index": hkl.astype(np.int32),
        "lp": result.lp,
        "d": result.d,
        "xyzcal.mm": xyzcal_mm,
        "xyzobs.px.value": result.xyzobs_px,
        "s1": s1,
        "id": np.asarray(ids, np.int64),
        "num_pixels.background": acc.bg_count,
        "num_pixels.foreground": acc.fg_count,
        "background.sum.value": result.background_sum,
        "background.mean": result.background_mean,
        "flags": np.where(result.valid, np.uint64(INTEGRATED_SUM), np.uint64(0)).astype(np.uint64),
    }
    return IntegrationRun(columns=columns, acc=acc, integrator=integ)


def run(argv=None) -> int:
    from ..models.experiment import Experiment
    from ..models.reflection_table import ReflectionTable
    from ..prediction.rotation import parse_scan_varying
    from ..utils import torchinit
    from ..utils.cli import add_common_arguments, apply_verbosity, expand_common_args

    torchinit.setup()
    p = argparse.ArgumentParser(prog="integrator")
    add_common_arguments(p)
    # the reference integrator derives from CUDAArgumentParser, which adds
    # the device-selection surface (cuda_arg_parser.cc:30-41)
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--device", type=int, default=0)
    p.add_argument("--reflection", "-r", required=False, metavar="strong.refl")
    p.add_argument("--experiment", "-e", required=False, metavar="experiments.expt")
    p.add_argument("--images", "-i", default=None, metavar="images.nxs")
    p.add_argument("-n", "--threads", type=int, default=0)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--sigma_m", "-sm", type=float, default=None)
    p.add_argument("--sigma_b", "-sb", type=float, default=None)
    p.add_argument(
        "--sigma_estimation.min_bbox_depth",
        "--min_bbox_depth",
        dest="min_bbox_depth",
        type=int,
        default=6,
    )
    p.add_argument("-a", "--algorithm", default="ellipsoid", choices=["ellipsoid", "dials"])
    p.add_argument(
        "--background",
        default="constant",
        choices=["constant", "glm", "dials"],
        help="constant = shared-core Tukey; glm = robust-Poisson GLM; "
        "dials = the independent dials-faithful Tukey cross-check "
        "(reference: baseline/integrator/integrator.cc:112-116)",
    )
    p.add_argument(
        "--bg-device",
        action="store_true",
        help="Run the bounding boxes, the background reduction and the "
        "finalisation on the device as well (reference GPU reduction: "
        "background.cu:29-99)",
    )
    p.add_argument("--min_zeta", type=float, default=0.05)
    p.add_argument("--output", default="integrated.refl")
    p.add_argument("--sample", action="store_true", help="Use generated test data")
    p.add_argument(
        "--profile",
        action="store_true",
        help="Print a per-stage wall-clock breakdown at the end (reference "
        "per-stage CUDA events: integrator.cc:925-991)",
    )
    args = p.parse_args(expand_common_args(argv))
    apply_verbosity(args)

    if args.list_devices:
        for line in torchinit.list_devices():
            print(line)
        return 0
    if not args.reflection or not args.experiment:
        p.error("the following arguments are required: --reflection/-r, --experiment/-e")
    device = torchinit.select_device(args.device)
    print(f"Device: {device} ({torchinit.device_name(device)})")

    stage_t: dict[str, float] = {}
    t_last = time.monotonic()

    def mark(stage: str) -> None:
        nonlocal t_last
        now = time.monotonic()
        stage_t[stage] = stage_t.get(stage, 0.0) + (now - t_last)
        t_last = now

    expt = Experiment.load(args.experiment)
    table = ReflectionTable.read(args.reflection)
    if expt.crystal is None:
        print("Error: experiment has no crystal model")
        return 1
    mark("load")

    # scan-varying model states (A/s0/setting at scan points) from the expt
    # JSON (reference: integrator.cc:474-492)
    with open(args.experiment) as f:
        elist = json.load(f)
    sv = parse_scan_varying(elist, expt.scan.image_range[1] - expt.scan.image_range[0] + 1)

    if args.sample:
        from ..io.sample_data import SampleReader

        reader = SampleReader()
    elif args.images:
        from ..io.nexus import NexusReader

        reader = NexusReader(args.images)
    else:
        print("Error: must provide --images or --sample")
        return 1

    out = integrate_experiment(
        expt, table, reader,
        device=device,
        sigma_b=args.sigma_b,
        sigma_m=args.sigma_m,
        min_bbox_depth=args.min_bbox_depth,
        algorithm=args.algorithm,
        background=args.background,
        bg_device=args.bg_device,
        min_zeta=args.min_zeta,
        sv=sv,
        threads=args.threads,
        timeout=args.timeout,
        profile=args.profile,
        mark=mark,
    )

    refl = ReflectionTable()
    refl.experiment_ids = list(table.experiment_ids)
    refl.identifiers = list(table.identifiers)
    for name, column in out.columns.items():
        refl[name] = column
    refl.write(args.output)
    print(f"Saved integrated reflections to {args.output}")
    mark("finalize+write")
    if args.profile:
        total = sum(stage_t.values())
        print("Stage breakdown:")
        for stage, dt in stage_t.items():
            print(f"    {stage:>14s}: {dt * 1000:8.1f} ms")
        print(f"    {'total':>14s}: {total * 1000:8.1f} ms")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    sys.exit(run())
