"""Kabsch integrator throughput on the card: the blocked step, then the
collection rate with every other stage folded in.

    python -m ffs_tpu_torch.tools.bench_integrator

Counterpart of the repo's ``tools/bench_integrator.py`` (``python -m
ffs_tpu_torch.bench`` runs it in-process as its integrator stage).  Two
metric lines, each against the bar of 928,000 reflection-image slices/s (464
predictions an image, ~4 images deep, 500 images/s):

- ``kabsch_integrate_refl_per_s``: ``KabschIntegrator._block_step_impl`` at
  the JAX tool's set-up (A = 2048 reflections with 21 x 21 boxes over F = 4
  frames of 2164 x 2068, Poisson(4), seed 3), ``REPS`` steps on the frames
  plus 4 and plus 5 in turn, all eight outputs consumed into one float64
  scalar read at the end.  Unlike the JAX tool it sets an all-valid
  detector mask, as ``integrate()`` sets the reader's: the step's outputs
  are the same and the mask windows' gather (TPU kernel row 4) runs.
- ``kabsch_integrate_effective_slices_per_s``: the block time of a
  3600-image collection (464 predictions an image) plus prediction (the
  JAX tool's measure: ``PREDICT_REPS`` chained blocks of the blocked
  two-pass search on one resident packed input of a short scan, each rep's
  input scaled by 1 + i 1e-15 and every output consumed into one scalar
  read at the end, scaled to the collection; the packed input holds the
  scan's own matrices where the JAX tool's holds identities, so the block
  screens and re-evaluates real candidates; ``predict_rotation``'s API time
  on the same scan stands beside it as ``predict_api``), the device boxes
  (``compute_kabsch_bounding_boxes_device``), the device Tukey background
  (``estimate_background_device``) and the device finalisation
  (``finalize_device``), each on inputs resident on the card
  and timed through its call, results back on the host; scaled by
  ``FFS_BENCH_INT_EFF_SCALE``.  The fold's parts are printed on a line of
  their own.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import bench
from ..integration.kabsch import KabschIntegrator
from ..models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

BAR = 928000.0
F = 4  # frames a block
H, W = 2164, 2068  # an Eiger 4M-sized frame
N_IMAGES, PRED_PER_IMAGE, Z_EXTENT = 3600, 464, 4  # the collection of the effective rate
CELL = np.diag([57.78, 57.78, 150.0])  # thaumatin


def geometry():
    """(panel, beam) of the JAX tool: an Eiger 4M-sized panel at 200 mm,
    0.976 A."""
    return (simple_panel(0.2 * 1000, (W / 2, H / 2), (0.075, 0.075), (W, H)),
            MonochromaticBeam(wavelength=0.976))


def setup(a: int, rng) -> SimpleNamespace:
    """The JAX tool's reflections, in its draw order from ``rng``: ``a``
    random positions 50 px or more inside the panel, s1 through the panel,
    phi in [0, 1) degrees, 21 x 21 boxes over the block's F frames."""
    panel, beam = geometry()
    x = rng.uniform(50, W - 50, a)
    y = rng.uniform(50, H - 50, a)
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    phi = np.deg2rad(rng.uniform(0, 1, a))
    half = 10
    bboxes = np.stack(
        [
            np.clip(x - half, 0, W - 1), np.clip(x + half, 0, W - 1),
            np.clip(y - half, 0, H - 1), np.clip(y + half, 0, H - 1),
            np.zeros(a), np.full(a, F),
        ],
        axis=1,
    ).astype(np.int64)
    return SimpleNamespace(panel=panel, beam=beam, gonio=Goniometer(),
                           scan=Scan(image_range=(1, 100), oscillation=(0.0, 0.1)),
                           s1=s1, phi=phi, bboxes=bboxes)


def block_frames(rng) -> np.ndarray:
    """The block's F Poisson(4) u16 frames, drawn after :func:`setup`."""
    return rng.poisson(4.0, size=(F, H, W)).astype(np.uint16)


def block_rate(run: bench.Run, s: SimpleNamespace, rng) -> float:
    """Reflection-image slices/s of the blocked step; draws the frames from
    ``rng`` after the set-up, as the JAX tool does."""
    a = len(s.s1)
    reps = run.reps("FFS_BENCH_INT_REPS")
    integ = KabschIntegrator(
        panel=s.panel, beam=s.beam, gonio=s.gonio, scan=s.scan, s1=s.s1, phi=s.phi,
        bboxes=s.bboxes, delta_b=np.deg2rad(0.3), delta_m=np.deg2rad(1.0), max_active=a,
        device=run.device,
    )
    integ.set_mask(np.ones((H, W), np.uint8))
    cs_e1 = np.cross(s.s1, s.beam.s0)
    cs_e1 /= np.linalg.norm(cs_e1, axis=1, keepdims=True)
    cs_e2 = np.cross(s.s1, cs_e1)
    cs_e2 /= np.linalg.norm(cs_e2, axis=1, keepdims=True)
    axis = s.gonio.rotation_axis
    zeta = cs_e1 @ (axis / np.linalg.norm(axis))
    chunk = integ._chunk_setup(np.arange(a), cs_e1, cs_e2, zeta)
    frames = integ.pad_frames(torch.from_numpy(block_frames(rng)).to(run.device))
    dev = run.device
    phi_lows = torch.from_numpy(np.deg2rad(np.arange(F) * 0.1)).to(dev)
    z_values = torch.arange(F, dtype=torch.float64, device=dev)
    frame_ok = torch.ones(F, dtype=torch.bool, device=dev)
    d_osc = float(np.deg2rad(0.1))

    def consume(fr):
        out = integ._block_step_impl(fr, chunk, phi_lows, d_osc, z_values, frame_ok,
                                     centre_slices=True)
        # all eight outputs: integrate() reads every one
        return sum(o.sum(dtype=torch.float64) for o in out)

    def chained(inputs, n):
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for i in range(n):
            acc = acc + consume(inputs[i & 1])
        return float(acc)

    # the JAX tool's values: a warm run on the frames + 2 (then + 3), the
    # timed one on + 4 (then + 5)
    f2, f3, f4, f5 = (frames + k for k in (2, 3, 4, 5))
    chained((f2, f3), 2)
    t0 = time.perf_counter()
    chained((f4, f5), reps)
    rps = a * F * reps / (time.perf_counter() - t0)
    run.profile("kabsch_integrate_refl_per_s", lambda: [consume(f4), consume(f5)])
    return rps


def _mean_seconds(run: bench.Run, fn, inputs: tuple, reps: int = 4) -> float:
    """Seconds a call of ``fn`` over ``reps`` calls on ``inputs`` in turn,
    after one warm call of each, the card synchronised at both ends (the
    boxes and the finalisation return host arrays, the background device
    tensors)."""
    for x in inputs:
        fn(x)
    run.sync()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[i & 1])
    run.sync()
    return (time.perf_counter() - t0) / reps


PREDICT_REPS = 8  # chained prediction blocks, as the JAX tool's R


def prediction_experiment(span: int):
    """The fold's prediction set-up: the bench's panel and beam, the
    thaumatin cell, ``span`` images of 0.1 degrees."""
    from ..models.crystal import Crystal
    from ..models.experiment import Experiment

    panel, beam = geometry()
    return Experiment(beam=beam, panel=panel, goniometer=Goniometer(),
                      scan=Scan(image_range=(1, span), oscillation=(0.0, 0.1)),
                      crystal=Crystal(CELL[0], CELL[1], CELL[2]))


def prediction_block(expt, device: torch.device):
    """(block, info) for the blocked prediction search's first block of
    ``expt``'s scan, its packed states and hkl tables resident on
    ``device``: ``block(scale)`` runs the block on the states times
    ``scale`` at the capacities the search settles on for it (its retry
    rule, applied here first); ``info`` holds those capacities, the
    block's images, the grid's rows and the candidate counts."""
    from ..prediction import rotation as rot

    osc0, d_osc = expt.scan.oscillation
    n_images = expt.scan.image_range[1] - expt.scan.image_range[0] + 1
    dmin, hkl = rot._scan_grid(expt, None)
    packed, img_block = rot._packed_states(expt, rot.ScanVaryingData(), n_images, osc0, d_osc, 32)
    tables, _ = rot._hkl_tables(hkl, 1 << 17, device)
    p = torch.from_numpy(packed[:img_block]).to(device)
    cap = img_block * 256
    chunk_cap = rot._default_chunk_cap(cap)
    while True:
        counts = rot._prediction_block(p, tables, cap, chunk_cap, dmin, d_osc)[-1, :2].tolist()
        if not rot._overflowed(counts, cap, chunk_cap):
            break
        cap, chunk_cap = rot._grown(counts, cap, chunk_cap)

    def block(scale: float):
        return rot._prediction_block(p * scale, tables, cap, chunk_cap, dmin, d_osc)

    info = {"images": img_block, "n_hkl": len(hkl), "n_pad": tables[0].numel() // 3,
            "cap": cap, "chunk_cap": chunk_cap, "counts": counts}
    return block, info


def predict_block_seconds(run: bench.Run, expt) -> float:
    """Seconds a block of the blocked prediction search
    (:func:`prediction_block`), over PREDICT_REPS chained blocks, rep i on
    the states times 1 + 2e-12 + i 1e-15, after two warm blocks."""
    block, _ = prediction_block(expt, run.device)

    def chained(scale: float, n: int) -> float:
        acc = torch.zeros((), dtype=torch.float64, device=run.device)
        for i in range(n):
            acc = acc + block(scale + i * 1e-15).nansum()
        return float(acc)

    chained(1.0 + 1e-12, 2)
    t0 = time.perf_counter()
    chained(1.0 + 2e-12, PREDICT_REPS)
    return (time.perf_counter() - t0) / PREDICT_REPS


def effective_rate(run: bench.Run, block_rps: float, s: SimpleNamespace, rng) -> float:
    """Collection slices/s with prediction, boxes, background and
    finalisation folded into the block time (the JAX tool's
    ``_effective_rate``, at its sizes times FFS_BENCH_INT_EFF_SCALE)."""
    from ..integration.background import NUM_BG_BINS
    from ..integration.background_device import estimate_background_device
    from ..integration.extent import compute_kabsch_bounding_boxes_device
    from ..integration.finalize import finalize_device
    from ..models.crystal import Crystal
    from ..prediction.rotation import predict_rotation

    n_refl = N_IMAGES * PRED_PER_IMAGE
    n_slices = n_refl * Z_EXTENT
    scale = run.reps("FFS_BENCH_INT_EFF_SCALE")
    dev = run.device
    beam, panel, gonio = s.beam, s.panel, s.gonio
    crystal = Crystal(CELL[0], CELL[1], CELL[2])
    scan = Scan(image_range=(1, N_IMAGES), oscillation=(0.0, 0.1))

    # prediction: the API on a short scan, then chained blocks, each scaled
    # to the collection
    span = max(4, int(32 * scale))
    expt = prediction_experiment(span)
    predict_rotation(expt, device=dev)  # warm, and the hkl tables on the card
    t0 = time.perf_counter()
    pred = predict_rotation(expt, device=dev)
    t_pred_api = (time.perf_counter() - t0) * (N_IMAGES / span)
    t_pred = predict_block_seconds(run, expt) * (N_IMAGES / span)

    # bounding boxes on the card from resident s1 and phi
    nbb = max(4096, int(262144 * scale))
    tiles = max(1, nbb // max(len(pred.s1), 1) + 1)
    s1bb = np.tile(np.asarray(pred.s1), (tiles, 1))[:nbb]
    phibb = np.tile(np.asarray(pred.xyzcal_mm[:, 2]), tiles)[:nbb]
    phi_d = torch.from_numpy(phibb).to(dev)
    s1_in = tuple(torch.from_numpy(s1bb * f).to(dev) for f in (1.0, 1.0 + 1e-12))
    t_bbox = _mean_seconds(run, lambda s1: compute_kabsch_bounding_boxes_device(
        beam.s0, gonio.rotation_axis, s1, phi_d, np.deg2rad(0.03), np.deg2rad(0.1), panel, scan,
        device=dev), s1_in) * (n_refl / nbb)

    # the (NB, 256) Tukey background on the card
    nb = max(1024, int(32768 * scale))
    cvals = np.clip(rng.poisson(4.0, size=(nb, 380)), 0, NUM_BG_BINS - 1)
    flat = (np.arange(nb)[:, None] * NUM_BG_BINS + cvals).ravel()
    hist = np.bincount(flat, minlength=nb * NUM_BG_BINS).reshape(nb, NUM_BG_BINS).astype(np.int64)
    hist_in = tuple(torch.from_numpy(hist + k).to(dev) for k in (0, 1))
    ovf = torch.zeros(nb, dtype=torch.int64, device=dev)

    t_bg = _mean_seconds(run, lambda h: estimate_background_device(h, ovf, "tukey"),
                         hist_in) * (n_refl / nb)

    # finalisation on the card, the JAX tool's accumulators in its draw order
    nf = max(4096, int(n_refl * scale))
    fg_sum = rng.poisson(500.0, nf).astype(float)
    fg_count = rng.integers(20, 60, nf)
    bg_count = rng.integers(300, 400, nf)
    sum_ix = fg_sum * rng.uniform(100, 2000, nf)
    sum_iy = fg_sum * rng.uniform(100, 2000, nf)
    sum_iz = fg_sum * rng.uniform(0, N_IMAGES, nf)
    s1f = rng.normal(size=(nf, 3))
    s1f /= np.linalg.norm(s1f, axis=1, keepdims=True) * beam.wavelength
    fbb = np.zeros((nf, 6), dtype=np.int64)
    fbb[:, 1] = fbb[:, 3] = 20
    fbb[:, 4] = rng.integers(0, N_IMAGES - Z_EXTENT, nf)
    fbb[:, 5] = fbb[:, 4] + Z_EXTENT
    phi = np.deg2rad(rng.uniform(0, 360, nf))
    hkl = rng.integers(-40, 41, size=(nf, 3))
    zeta = rng.uniform(0.1, 1.0, nf)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    acc = [SimpleNamespace(fg_sum=t(fg_sum + k), fg_count=t(fg_count), bg_count=t(bg_count),
                           sum_ix=t(sum_ix), sum_iy=t(sum_iy), sum_iz=t(sum_iz)) for k in (0, 1)]
    rows = dict(bg_mean=t(np.full(nf, 4.0)), bg_wsum=t(np.full(nf, 300.0)),
                bg_valid=t(np.ones(nf, dtype=bool)), bboxes=t(fbb), s1=t(s1f), phi=t(phi),
                hkl=t(hkl), zeta=t(zeta))

    t_fin = _mean_seconds(run, lambda a: finalize_device(
        acc=a, **rows, scan=scan, beam=beam, gonio=gonio, crystal=crystal,
        sigma_m=np.deg2rad(0.1), device=dev), tuple(acc)) * (n_refl / nf)

    t_block = n_slices / block_rps
    total = t_block + t_pred + t_bbox + t_bg + t_fin
    run.line({"fold_s": {"block": t_block, "predict": t_pred, "bbox": t_bbox,
                         "background": t_bg, "finalize": t_fin, "total": total,
                         "acquisition": N_IMAGES / 500.0, "predict_api": t_pred_api}})
    return n_slices / total


def run_stage(run: bench.Run) -> None:
    """Both metric lines, each after its launch line."""
    since = run.counts()
    rng = np.random.default_rng(3)
    s = setup(run.size("int_refl"), rng)
    rps = block_rate(run, s, rng)
    run.emit("kabsch_integrate_refl_per_s", rps,
             "reflection-image slices/s/chip (21x21 shoeboxes)", BAR, since=since)
    since = run.counts()
    eff = effective_rate(run, rps, s, rng)
    run.emit("kabsch_integrate_effective_slices_per_s", eff,
             "collection slices/s/chip incl. predict+bbox+background+finalize", BAR, since=since)


def main() -> int:
    run = bench.open_run()
    run.header()
    bench.guarded(run, "integrator", run_stage)
    return run.exit_code()


if __name__ == "__main__":
    sys.exit(main())
