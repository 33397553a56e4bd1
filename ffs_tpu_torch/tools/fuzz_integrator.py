"""Differential fuzz of the blocked Kabsch integrator against the float64
oracle, on random experiments.

    python -m ffs_tpu_torch.tools.fuzz_integrator [N_SEEDS [START_SEED]]

Counterpart of the repo's ``tools/fuzz_integrator.py`` (defaults 20 seeds
from 0).  Each seed draws the JAX tool's random experiment, in its draw
order: one of three panels, with parallax on a third of the seeds; pixel
size, distance and beam centre; a random cell of 35-70 A at a random
orientation; wavelength and oscillation width; up to 40 predictions well
inside the panel and the scan (``predict_rotation(dmin=4.0,
use_device=False)``, the per-image float64 search); sigma_b, sigma_m and
n_sigma; Poisson frames with Gaussian spots at the predictions and a few
very large counts; a mask band or scattered holes; ``max_active`` 64 or
128.  The algorithm alternates by seed (ellipsoid, dials).

The port's :class:`~ffs_tpu_torch.integration.kabsch.KabschIntegrator` (the
blocked step with the CUDA window gathers on the card, their plain versions
on the CPU) runs against
:func:`~ffs_tpu_torch.integration.reference_kabsch.integrate_reference`,
which re-derives every corner's wavevector in float64 per pixel.  All eight
accumulators must be equal bit for bit, and the foreground must not be
empty.  The JAX tool also alternates a lane-packed step layout by seed; the
port has one step, so that choice appears only in the seed's tag
(``pack=``), as a record of what the JAX run of the seed did.

Runs on the CUDA device, or the CPU under ``FFS_TORCH_DEVICE=cpu``.  A
crash counts as a failure; exits 1 if any seed fails.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

PANEL_SIZES = [(240, 260), (200, 208), (288, 224)]
N_FRAMES = 12
ACCUMULATORS = ("fg_count", "bg_count", "bg_overflow", "bg_hist", "fg_sum", "sum_ix",
                "sum_iy", "sum_iz")


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class _Reader:
    """Poisson background + dense Gaussian spots at the predictions."""

    def __init__(self, expt, xyzcal_px, rng, bg_lam, intensity):
        w, h = expt.panel.image_size
        z0, z1 = expt.scan.image_range
        n_img = z1 - z0 + 1
        self.frames = rng.poisson(bg_lam, size=(n_img, h, w)).astype(np.float64)
        yy, xx = np.mgrid[0:h, 0:w]
        for px, py, pz in xyzcal_px:
            for z in range(n_img):
                fz = np.exp(-((z + 0.5 - (pz + 0.5)) ** 2) / (2 * 0.5**2))
                if fz < 1e-3:
                    continue
                g = np.exp(-(((xx - px) ** 2 + (yy - py) ** 2) / (2 * 1.2**2)))
                self.frames[z] += intensity * fz * g
        # a few very large counts: the background histogram's overflow
        n_hot = int(rng.integers(0, 6))
        if n_hot:
            self.frames[
                rng.integers(0, n_img, n_hot),
                rng.integers(0, h, n_hot),
                rng.integers(0, w, n_hot),
            ] = float(rng.integers(300, 70000))
        self.frames = np.round(self.frames)
        self._mask = np.ones((h, w), dtype=np.uint8)

    def get_image(self, img_no):
        return self.frames[img_no]

    def get_mask(self):
        return self._mask

    def get_number_of_images(self):
        return len(self.frames)


@dataclass
class Draw:
    """One seed's experiment, as the integrator and the oracle take it."""

    expt: object
    s1: np.ndarray
    phi: np.ndarray
    bboxes: np.ndarray
    reader: _Reader
    delta_b: float
    delta_m: float
    algorithm: str
    max_active: int
    tag: str


def draw(seed: int, device: torch.device) -> Draw | None:
    """The JAX tool's experiment for ``seed`` in the port's models; None
    where fewer than 5 predictions are usable (the JAX tool skips those)."""
    from ..integration import extent as extent_mod
    from ..models.crystal import Crystal
    from ..models.experiment import Experiment
    from ..models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel
    from ..prediction.rotation import predict_rotation

    rng = np.random.default_rng(seed)
    w_px, h_px = PANEL_SIZES[seed % len(PANEL_SIZES)]
    pixel = float(rng.choice([0.15, 0.2, 0.3]))
    parallax = seed % 3 == 0
    panel_kw = dict(
        distance_mm=float(rng.uniform(90.0, 180.0)),
        beam_center_px=(
            w_px / 2 + float(rng.uniform(-15, 15)),
            h_px / 2 + float(rng.uniform(-15, 15)),
        ),
        pixel_size_mm=(pixel, pixel),
        image_size=(w_px, h_px),
    )
    if parallax:
        panel_kw.update(mu=float(rng.uniform(0.2, 0.5)), thickness=0.45, parallax=True)

    cell = rng.uniform(35.0, 70.0, size=3)
    R = _random_rotation(rng)
    vecs = np.diag(cell) @ R.T
    expt = Experiment(
        beam=MonochromaticBeam(wavelength=float(rng.uniform(0.8, 1.4))),
        panel=simple_panel(**panel_kw),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, N_FRAMES), oscillation=(0.0, float(rng.choice([0.5, 1.0])))),
        crystal=Crystal(vecs[0], vecs[1], vecs[2]),
    )

    pred = predict_rotation(expt, dmin=4.0, use_device=False, device=device)
    x, y, z = pred.xyzcal_px.T
    keep = (x > 20) & (x < w_px - 20) & (y > 20) & (y < h_px - 20) & (z > 1.5) & (z < 10.5)
    idx = np.nonzero(keep)[0]
    if len(idx) < 5:
        return None
    idx = idx[rng.permutation(len(idx))[:40]]
    s1 = pred.s1[idx]
    phi = pred.xyzcal_mm[idx][:, 2]

    sigma_b = np.deg2rad(rng.uniform(0.04, 0.10))
    sigma_m = np.deg2rad(rng.uniform(0.25, 0.50))
    n_sig = float(rng.uniform(2.5, 3.5))
    bboxes = extent_mod.compute_kabsch_bounding_boxes(
        expt.beam.s0, expt.goniometer.rotation_axis, s1, phi,
        sigma_b, sigma_m, expt.panel, expt.scan,
    )
    bboxes[:, 0] = np.clip(bboxes[:, 0], 0, w_px - 1)
    bboxes[:, 1] = np.clip(bboxes[:, 1], 0, w_px - 1)
    bboxes[:, 2] = np.clip(bboxes[:, 2], 0, h_px - 1)
    bboxes[:, 3] = np.clip(bboxes[:, 3], 0, h_px - 1)

    reader = _Reader(
        expt, pred.xyzcal_px[idx], rng,
        bg_lam=float(rng.choice([1.0, 4.0, 9.0])),
        intensity=float(rng.uniform(100.0, 600.0)),
    )
    mask_kind = int(rng.integers(0, 3))
    if mask_kind == 1:  # band across the shoebox region
        r0 = int(rng.integers(h_px // 4, 3 * h_px // 4))
        reader._mask[r0 : r0 + int(rng.integers(2, 8)), :] = 0
    elif mask_kind == 2:  # scattered holes
        reader._mask[rng.random((h_px, w_px)) < 0.01] = 0

    algorithm = "ellipsoid" if seed % 2 == 0 else "dials"
    lane_pack = (seed // 2) % 2 == 0  # the JAX run's step layout, for the tag
    max_active = int(rng.choice([64, 128]))
    tag = (f"{w_px}x{h_px} px={pixel} plx={int(parallax)} alg={algorithm} "
           f"pack={int(lane_pack)} mask={mask_kind} n={len(idx)} max_active={max_active}")
    return Draw(expt=expt, s1=s1, phi=phi, bboxes=bboxes, reader=reader,
                delta_b=n_sig * sigma_b * 2, delta_m=n_sig * sigma_m, algorithm=algorithm,
                max_active=max_active, tag=tag)


def integrate(d: Draw, device: torch.device):
    """The port's blocked step over the draw's 12 frames -> Accumulators."""
    from ..integration import kabsch as kb

    expt = d.expt
    integ = kb.KabschIntegrator(
        panel=expt.panel, beam=expt.beam, gonio=expt.goniometer, scan=expt.scan,
        s1=d.s1, phi=d.phi, bboxes=d.bboxes, delta_b=d.delta_b, delta_m=d.delta_m,
        algorithm=d.algorithm, max_active=d.max_active, device=device,
    )
    acc = kb.Accumulators.zeros(len(d.s1))
    integ.integrate(d.reader, list(range(N_FRAMES)), acc)
    return acc


def oracle(d: Draw) -> dict:
    """The float64 oracle's accumulators for the draw."""
    from ..integration.reference_kabsch import integrate_reference

    expt = d.expt
    osc_start, osc_width = expt.scan.oscillation
    z0 = expt.scan.image_range[0]
    image_numbers = np.arange(N_FRAMES)
    return integrate_reference(
        frames=d.reader.frames,
        det_mask=d.reader.get_mask(),
        bboxes=d.bboxes,
        s1=d.s1,
        phi=d.phi,
        s0=expt.beam.s0,
        rotation_axis=expt.goniometer.rotation_axis,
        panel=expt.panel,
        wavelength=expt.beam.wavelength,
        phi_lows=np.deg2rad(osc_start + (image_numbers - (z0 - 1)) * osc_width),
        d_osc=float(np.deg2rad(osc_width)),
        z_values=image_numbers.astype(np.float64),
        delta_b=d.delta_b,
        delta_m=d.delta_m,
        algorithm=d.algorithm,
        centre_slices=True,
    )


def run_seed(seed: int, device: torch.device, verbose: bool = False) -> bool:
    """One seed: True where all eight accumulators equal the oracle's bit
    for bit and the foreground is not empty (or the seed has too few usable
    predictions, as the JAX tool counts it)."""
    d = draw(seed, device)
    if d is None:
        if verbose:
            print(f"  seed {seed}: fewer than 5 usable predictions, skip", flush=True)
        return True
    acc = integrate(d, device)
    want = oracle(d)
    errs = []
    if acc.fg_count.sum() == 0 or want["fg_count"].sum() == 0:
        errs.append("no foreground classified at all")
    for name in ACCUMULATORS:
        got, ref = np.asarray(getattr(acc, name)), np.asarray(want[name])
        if not np.array_equal(got, ref):
            errs.append(f"{name}: {int((got != ref).sum())} mismatching entries")
    if errs:
        print(f"MISMATCH seed={seed} [{d.tag}]: " + "; ".join(errs), flush=True)
        return False
    if verbose:
        print(f"  seed {seed} ok [{d.tag}] fg_px={int(acc.fg_count.sum())}", flush=True)
    return True


def run_seeds(seeds, device: torch.device, verbose: bool = True) -> int:
    """Runs ``seeds``; returns the number that failed (a crash is a failure)."""
    failures = 0
    for seed in seeds:
        try:
            failures += not run_seed(seed, device, verbose=verbose)
        except Exception as e:  # a crash is a finding too
            print(f"CRASH seed={seed}: {type(e).__name__}: {e}", flush=True)
            failures += 1
    return failures


def main(argv=None) -> int:
    from ..utils import torchinit

    argv = sys.argv[1:] if argv is None else argv
    digits = [int(a) for a in argv if a.isdigit()]
    n_seeds = digits[0] if digits else 20
    start = digits[1] if len(digits) > 1 else 0
    torchinit.setup()
    device = torchinit.select_device()
    t0 = time.time()
    failures = run_seeds(range(start, start + n_seeds), device)
    print(f"integrator fuzz done: {n_seeds} seeds from {start}, {failures} failures, "
          f"{time.time() - t0:.1f} s on {torchinit.device_name(device)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
