"""Candidate crystal evaluation and scoring.

Equivalent of the reference score_crystals (reference:
baseline/indexer/score_crystals.cc:59-153): per candidate — assign indices,
non-primitive correction, pre-refinement filtering, LM refinement — then a
combined log2-normalised score over rmsd, fraction indexed and cell volume.
The reference fans candidates over std::threads with a mutex-guarded map
(SURVEY.md P6); here candidates are evaluated through vectorised NumPy/JAX
kernels so a plain loop suffices (vmap batching is the scale-up path).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.crystal import Crystal
from .assign import assign_indices_global
from .filter import reflection_filter_preevaluation
from .non_primitive import correct
from .refine import refine_candidate


@dataclass
class CandidateScore:
    crystal: Crystal
    s0: np.ndarray
    panel_frame: tuple  # refined (fast, slow, origin)
    num_indexed: int
    fraction_indexed: float
    rmsdxy: float
    rmsd_score: float = 0.0
    indexed_score: float = 0.0
    volume_score: float = 0.0
    score: float = 0.0
    extras: dict = field(default_factory=dict)


def evaluate_crystal(
    crystal: Crystal,
    *,
    rlp: np.ndarray,
    xyzobs_mm: np.ndarray,
    flags: np.ndarray,
    s1: np.ndarray,
    entering: np.ndarray,
    beam,
    panel,
    gonio,
    scan_width_degrees: float,
    n_ref_per_degree: int = 20,
) -> CandidateScore | None:
    """Assign -> correct -> filter -> refine -> score one candidate
    (score_crystals.cc:59-113).

    Deliberate divergence: candidates with no corrected reflections or
    fewer than 10 filtered reflections are dropped before refinement.
    The reference refines and scores every candidate; a sub-10-reflection
    candidate can over-fit the 18-parameter LM to a tiny rmsd and win the
    combined score on noise, so the gate trades exact reference parity
    for ranking robustness (the reference's own min_sample_size logic
    implies ~hundreds of reflections for a real solution)."""
    hkl, _ = assign_indices_global(crystal.a_matrix, rlp, xyzobs_mm)
    hkl, crystal, count = correct(hkl, crystal, rlp, xyzobs_mm)
    if count == 0:
        return None

    sel = reflection_filter_preevaluation(
        hkl=hkl,
        flags=flags,
        s1=s1,
        xyzobs_mm=xyzobs_mm,
        entering=entering,
        crystal=crystal,
        beam=beam,
        panel=panel,
        gonio=gonio,
        scan_width_degrees=scan_width_degrees,
        n_ref_per_degree=n_ref_per_degree,
    )
    if len(sel.indices) < 10:
        return None

    refined, s0, frame, rmsds = refine_candidate(
        crystal, beam, panel, gonio, sel.hkl, sel.entering, sel.xyzobs_mm
    )
    xyrmsd = float(np.sqrt(rmsds[0] ** 2 + rmsds[1] ** 2))
    return CandidateScore(
        crystal=refined,
        s0=s0,
        panel_frame=frame,
        num_indexed=count,
        fraction_indexed=count / len(rlp),
        rmsdxy=xyrmsd,
    )


def score_solutions(candidates: list[CandidateScore]) -> None:
    """Combined score = rmsd + fraction-indexed + volume, log2-normalised
    (score_crystals.cc:119-153).  Lower is better; updates in place."""
    if not candidates:
        return
    rmsd = np.log2([max(c.rmsdxy, 1e-12) for c in candidates])
    frac = np.log2([max(c.fraction_indexed, 1e-12) for c in candidates])
    vol = np.log2([max(c.crystal.volume, 1e-12) for c in candidates])
    rmsd -= rmsd.min()
    frac = frac.max() - frac
    vol -= vol.min()
    for c, r, f, v in zip(candidates, rmsd, frac, vol):
        c.rmsd_score = float(r)
        c.indexed_score = float(f)
        c.volume_score = float(v)
        c.score = float(r + f + v)
