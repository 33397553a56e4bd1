"""baseline_indexer CLI on PyTorch — FFT rotation indexing.

Counterpart of :mod:`ffs_tpu.pipeline.indexer` (reference `baseline_indexer`,
baseline/indexer/indexer.cc:50-620) with the same flags, prints, exit codes
and outputs: strong reflections + experiment JSON in; candidate lattice
vectors from a 3D FFT of the rlps (the transform on the device,
:mod:`..indexing.fft3d`); candidate crystals scored by assign, correct,
filter and refine on a small thread pool (refinement on the CPU in float64,
:mod:`..indexing.refine`); macro-cycles of joint refinement at stepped
d_min; ``indexed.expt`` + ``indexed.refl`` out (``candidate_vectors.json``
and ``candidate_crystals.json`` with ``--test``).

:func:`index_experiment` and :func:`indexed_reflections` are the core: they
take the loaded experiment and the strong spots' ``xyzobs.px.value`` and
need no h5py; :func:`run` wraps them with the file I/O.

Console script: ``baseline_indexer_torch``.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np


def _entering_flags(s1, s0, axis):
    vec = np.cross(s0, axis)
    return (s1 @ vec) < 0.0


@dataclass
class IndexOptions:
    """The CLI's indexing flags."""

    max_cell: float
    dmin: float | None = None
    max_refine: int = 50
    macro_cycles: int = 5
    test: bool = False
    fft_npoints: int = 256
    nthreads: int | None = None


@dataclass
class IndexOutcome:
    """What :func:`index_experiment` found: ``expt`` carries the refined
    crystal, beam and panel; ``vectors`` are the FFT's candidate basis
    vectors and ``candidates`` the scored crystals, best first."""

    expt: object
    vectors: list
    candidates: list


def index_experiment(expt, xyzobs_px: np.ndarray, options: IndexOptions, *, device=None):
    """Index one rotation sweep; returns an :class:`IndexOutcome`, or None
    where the CLI stops with exit code 0 (fewer than three candidate
    vectors, or no viable crystal).  Prints what the CLI prints; with
    ``options.test`` writes ``candidate_vectors.json`` and
    ``candidate_crystals.json`` to the working directory.  ``device`` is
    where the FFT runs (default :func:`torchinit.select_device`).  The
    experiment's crystal, beam and panel frame are updated in place."""
    import itertools
    from concurrent.futures import ThreadPoolExecutor

    from ..indexing import combinations as comb_mod
    from ..indexing import fft3d as fft_mod
    from ..indexing import flood_fill as ff_mod
    from ..indexing import peaks as peaks_mod
    from ..indexing.assign import assign_indices_global
    from ..indexing.filter import reflection_filter_preevaluation
    from ..indexing.refine import refine_candidate
    from ..indexing.rlp import xyz_to_rlp
    from ..indexing.score import evaluate_crystal, score_solutions
    from ..models.reflection_table import STRONG
    from ..utils import torchinit

    torchinit.setup()
    if device is None:
        device = torchinit.select_device()
    xyzobs_px = np.asarray(xyzobs_px, dtype=np.float64)
    res = xyz_to_rlp(xyzobs_px, expt.panel, expt.beam, expt.scan, expt.goniometer)
    rlp, s1, xyzobs_mm = res["rlp"], res["s1"], res["xyzobs_mm"]
    print(f"Number of reflections: {len(rlp)}")

    n_points = options.fft_npoints
    d_values = 1.0 / np.linalg.norm(rlp, axis=1)
    d_min_data = float(d_values.min())
    if options.dmin is not None:
        d_min = options.dmin
    else:
        # d_min = 5 max_cell / n_points (Campbell 1998; indexer.cc:185-200)
        d_min = max(5.0 * options.max_cell / n_points, d_min_data)
        print(f"Setting dmin to {d_min:.5f}")
    b_iso = fft_mod.b_iso_from_d_min(d_min)
    print(f"Setting b_iso = {b_iso:.3f}")

    grid, used = fft_mod.fft3d(rlp, d_min, b_iso, n_points, device=device)
    vols, coms = ff_mod.flood_fill(grid, 15.0, n_points)
    vols, coms = ff_mod.flood_fill_filter(vols, coms, 0.15)
    vectors = peaks_mod.peaks_to_rlvs(
        coms, vols, d_min, 3.0, options.max_cell, n_points
    )
    print("Candidate basis vectors:")
    for i, v in enumerate(vectors):
        print(f"{i} {np.linalg.norm(v):.5f}")

    if len(vectors) < 3:
        print("Insufficient number of candidate vectors to make a crystal model.")
        return None

    if options.test:
        pad = len(str(max(len(vectors) - 1, 0)))
        with open("candidate_vectors.json", "w") as f:
            json.dump(
                {str(i).zfill(pad): [float(x) for x in v] for i, v in enumerate(vectors)},
                f,
                indent=4,
            )
        print("Saved candidate vectors to candidate_vectors.json")

    flags = np.full(len(rlp), STRONG, dtype=np.uint64)
    entering = _entering_flags(s1, expt.beam.s0, expt.goniometer.rotation_axis)

    # dmin + oscillation-trim selection (indexer.cc:262-276)
    osc_trim = expt.scan.oscillation[0] + 360.0
    sel = (d_values > d_min) & (np.degrees(xyzobs_mm[:, 2]) <= osc_trim)

    n_images = expt.scan.image_range[1] - expt.scan.image_range[0] + 1
    scan_width = expt.scan.oscillation[0] + expt.scan.oscillation[1] * n_images

    gen = comb_mod.candidate_orientation_matrices(vectors, 1000)
    print(f"Scoring up to {options.max_refine} candidate crystals")
    crystals = list(itertools.islice(gen, options.max_refine))

    def _score(crystal):
        return evaluate_crystal(
            crystal,
            rlp=rlp[sel],
            xyzobs_mm=xyzobs_mm[sel],
            flags=flags[sel],
            s1=s1[sel],
            entering=entering[sel],
            beam=expt.beam,
            panel=expt.panel,
            gonio=expt.goniometer,
            scan_width_degrees=scan_width,
            n_ref_per_degree=20,
        )

    # Candidate scoring runs on a small thread pool (the reference threads
    # this loop too, sized from --nthreads, indexer.cc:215-220,299-304);
    # results keep generator order for deterministic scoring output.
    nthreads = options.nthreads if options.nthreads else min(4, len(crystals))
    if len(crystals) > 1 and nthreads > 1:
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            scores = list(ex.map(_score, crystals))
    else:
        scores = [_score(c) for c in crystals]
    candidates = []
    for score in scores:
        if score is not None:
            candidates.append(score)
            print(f"Scored candidate crystal {len(candidates)}")

    if not candidates:
        print("No viable candidate crystals.")
        return None

    score_solutions(candidates)
    candidates.sort(key=lambda c: c.score)
    print(
        "| Unit cell                                 | volume & score | #indexed % & "
        "score | rmsd_xy & score | overall score |"
    )
    for c in candidates:
        a, b, cc_, al, be, ga = c.crystal.unit_cell
        print(
            f"| {a:>6.2f} {b:>6.2f} {cc_:>6.2f} {al:>6.2f} {be:>6.2f} {ga:>6.2f} "
            f"| {c.crystal.volume:>8.0f}  {c.volume_score:.2f} "
            f"| {c.num_indexed:>7.0f}  {c.fraction_indexed * 100:>3.0f}  {c.indexed_score:.2f} "
            f"| {c.rmsdxy:>6.2f}    {c.rmsd_score:>5.2f} |        {c.score:>6.2f} |"
        )

    if options.test:
        pad = len(str(len(candidates) - 1))
        out = {}
        for i, c in enumerate(candidates):
            a, b, cc_, al, be, ga = c.crystal.unit_cell
            out[str(i).zfill(pad)] = {
                "crystal": c.crystal.to_json(),
                "unit_cell": [a, b, cc_, al, be, ga],
                "num_indexed": c.num_indexed,
                "fraction_indexed": c.fraction_indexed,
                "rmsdxy": c.rmsdxy,
                "score": c.score,
            }
        with open("candidate_crystals.json", "w") as f:
            json.dump(out, f, indent=4)
        print("Saved candidate crystals to candidate_crystals.json")

    best = candidates[0]
    expt.crystal = best.crystal
    expt.beam.wavelength = 1.0 / np.linalg.norm(best.s0)
    expt.beam.direction = -best.s0 / np.linalg.norm(best.s0)
    expt.update_panel_frame(*best.panel_frame)

    # macro cycles of refinement at stepped d_min (indexer.cc:401-447)
    if options.macro_cycles:
        d_step = (d_min - d_min_data) / options.macro_cycles
        print(
            f"Performing {options.macro_cycles} macro cycles with a dmin step of "
            f"{d_step:.3f}"
        )
        for cycle in range(options.macro_cycles):
            d_cycle = d_min - (cycle + 1) * d_step
            print(f"Performing macro cycle {cycle + 1} with d_min={d_cycle:.3f}")
            res = xyz_to_rlp(
                xyzobs_px, expt.panel, expt.beam, expt.scan, expt.goniometer
            )
            rlp_c, s1_c, xyz_c = res["rlp"], res["s1"], res["xyzobs_mm"]
            d_vals = 1.0 / np.linalg.norm(rlp_c, axis=1)
            sel_c = (d_vals > d_cycle) & (np.degrees(xyz_c[:, 2]) <= osc_trim)
            hkl_c, n_idx = assign_indices_global(
                expt.crystal.a_matrix, rlp_c[sel_c], xyz_c[sel_c]
            )
            print(f"Indexed {n_idx}/{int(sel_c.sum())} reflections")
            filt = reflection_filter_preevaluation(
                hkl=hkl_c,
                flags=flags[sel_c],
                s1=s1_c[sel_c],
                xyzobs_mm=xyz_c[sel_c],
                entering=entering[sel_c],
                crystal=expt.crystal,
                beam=expt.beam,
                panel=expt.panel,
                gonio=expt.goniometer,
                scan_width_degrees=scan_width,
                n_ref_per_degree=100,
            )
            if len(filt.indices) < 10:
                continue
            refined, s0_new, frame, _ = refine_candidate(
                expt.crystal,
                expt.beam,
                expt.panel,
                expt.goniometer,
                filt.hkl,
                filt.entering,
                filt.xyzobs_mm,
            )
            expt.crystal = refined
            expt.beam.wavelength = 1.0 / np.linalg.norm(s0_new)
            expt.beam.direction = -s0_new / np.linalg.norm(s0_new)
            expt.update_panel_frame(*frame)
    return IndexOutcome(expt=expt, vectors=vectors, candidates=candidates)


def indexed_reflections(expt, xyzobs_px: np.ndarray, flags=None) -> dict:
    """The ``indexed.refl`` columns under the refined models: assigns
    Miller indices, sets INDEXED in ``flags`` (default all STRONG),
    predicts ``xyzcal.mm``.  Prints the CLI's summary lines."""
    from ..indexing.assign import assign_indices_global
    from ..indexing.predict import predict_scan_static
    from ..indexing.rlp import xyz_to_rlp
    from ..models.reflection_table import INDEXED, STRONG

    xyzobs_px = np.asarray(xyzobs_px, dtype=np.float64)
    res = xyz_to_rlp(xyzobs_px, expt.panel, expt.beam, expt.scan, expt.goniometer)
    hkl, n_indexed = assign_indices_global(
        expt.crystal.a_matrix, res["rlp"], res["xyzobs_mm"]
    )
    pct = 100.0 * n_indexed / len(xyzobs_px)
    print(
        f"Indexed {n_indexed}/{len(xyzobs_px)} reflections using the refined "
        f"models ({pct:.2f}% indexed)"
    )
    a, b, cc_, al, be, ga = expt.crystal.unit_cell
    print(f"Crystal:\n  Unit cell: {a:.4f} {b:.4f} {cc_:.4f} {al:.4f} {be:.4f} {ga:.4f}")
    print("  Space group: P 1")

    new_flags = np.asarray(
        flags if flags is not None else np.full(len(xyzobs_px), STRONG, np.uint64),
        dtype=np.uint64,
    )
    new_flags = np.where(
        ~(hkl == 0).all(axis=1), new_flags | np.uint64(INDEXED), new_flags
    )
    entering = _entering_flags(
        res["s1"], expt.beam.s0, expt.goniometer.rotation_axis
    ).astype(np.uint8)
    pred = predict_scan_static(
        hkl,
        entering.astype(bool),
        res["xyzobs_mm"][:, 2],
        s0=expt.beam.s0,
        fixed_rotation=expt.goniometer.fixed_rotation,
        setting_rotation=expt.goniometer.setting_rotation,
        rotation_axis=expt.goniometer.rotation_axis,
        ub=expt.crystal.a_matrix,
        d_matrix=expt.d_matrix,
    )
    return {
        "xyzobs.mm.value": res["xyzobs_mm"],
        "s1": res["s1"],
        "rlp": res["rlp"],
        "miller_index": hkl,
        "flags": new_flags,
        "entering": entering,
        "xyzcal.mm": pred["xyzcal_mm"],
        "n_indexed": n_indexed,
    }


def run(argv=None) -> int:
    from ..models.experiment import Experiment
    from ..models.reflection_table import ReflectionTable

    p = argparse.ArgumentParser(prog="baseline_indexer")
    p.add_argument("-e", "--expt", required=True, help="Path to the DIALS expt file")
    p.add_argument("-r", "--refl", required=True, help="Path to the reflection h5")
    p.add_argument("--dmin", type=float, default=None)
    p.add_argument("--max-cell", type=float, required=True)
    p.add_argument("--max-refine", type=int, default=50)
    p.add_argument("--macro-cycles", type=int, default=5)
    p.add_argument("--test", action="store_true")
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--fft-npoints", type=int, default=256)
    p.add_argument("--nthreads", type=int, default=None)
    args = p.parse_args(argv)

    expt = Experiment.load(args.expt)
    strong = ReflectionTable.read(args.refl)
    xyzobs_px = np.asarray(strong["xyzobs.px.value"], dtype=np.float64)
    options = IndexOptions(
        max_cell=args.max_cell, dmin=args.dmin, max_refine=args.max_refine,
        macro_cycles=args.macro_cycles, test=args.test,
        fft_npoints=args.fft_npoints, nthreads=args.nthreads,
    )
    outcome = index_experiment(expt, xyzobs_px, options)
    if outcome is None:
        return 0

    expt.save("indexed.expt")
    print("Saved experiment list to indexed.expt")

    if not args.no_output:
        cols = indexed_reflections(
            expt, xyzobs_px, strong["flags"] if "flags" in strong else None
        )
        for key in ("xyzobs.mm.value", "s1", "rlp"):
            strong[key] = cols[key]
        if "panel" not in strong:
            strong["panel"] = np.zeros(len(xyzobs_px), dtype=np.uint64)
        if "xyzobs.px.variance" in strong:
            var_px = np.asarray(strong["xyzobs.px.variance"], dtype=np.float64)
            px, py = expt.panel.pixel_size
            osc_w = np.deg2rad(expt.scan.oscillation[1])
            strong["xyzobs.mm.variance"] = var_px * np.array(
                [px * px, py * py, osc_w * osc_w]
            )
        for key in ("miller_index", "flags", "entering", "xyzcal.mm"):
            strong[key] = cols[key]
        strong.identifiers = [expt.identifier]
        strong.experiment_ids = [0]
        strong.write("indexed.refl")
        print("Saved reflection table to indexed.refl")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    sys.exit(run())
