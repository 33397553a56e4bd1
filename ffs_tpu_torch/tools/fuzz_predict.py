"""Differential fuzz of the prediction: the blocked two-pass search against
the per-image float64 search, both on the device.

    python -m ffs_tpu_torch.tools.fuzz_predict [N_SEEDS [START_SEED]]

Counterpart of the repo's ``tools/fuzz_predict.py`` (defaults 20 seeds from
0; each seed a whole prediction over 4-10 images).  The blocked search
(:func:`ffs_tpu_torch.prediction.rotation.predict_rotation`'s default)
accepts pass-1 candidates in float32 inside a band; a band violation on the
card would drop predicted reflections silently.  Each seed draws the JAX
tool's random experiment, in its draw order: a cell of 25-120 A with a
random right-handed orientation and a mild shear, a square panel of
512-2200 px of 0.05-0.2 mm at 80-350 mm, a wavelength of 0.7-2.0 A and a
scan of 4-10 images of 0.05-0.5 degrees.  It predicts with both searches
and demands:

* the same reflections (hkl and entering, matched by sorting both on
  entering, hkl and frame), exactly;
* xyzcal.px within 1e-6 (both are float64 once a ray is accepted).

Runs on the CUDA device, or the CPU under ``FFS_TORCH_DEVICE=cpu``.  Exits
1 if any seed fails.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

PX_TOL = 1e-6


def experiment(seed: int):
    """The JAX tool's random experiment for ``seed``, in the port's models."""
    from ..models.crystal import Crystal
    from ..models.experiment import Experiment
    from ..models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    rng = np.random.default_rng(seed)
    # random cell: lengths 25-120 A, right-handed random orientation
    lengths = rng.uniform(25.0, 120.0, 3)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    vecs = np.diag(lengths) @ q.T
    # mild shear for non-orthogonal cells
    shear = np.eye(3) + rng.uniform(-0.15, 0.15, (3, 3)) * (1 - np.eye(3))
    vecs = vecs @ shear.T
    npx = int(rng.integers(512, 2200))
    dist = float(rng.uniform(80.0, 350.0))
    px = float(rng.uniform(0.05, 0.2))
    wl = float(rng.uniform(0.7, 2.0))
    n_img = int(rng.integers(4, 11))
    osc = float(rng.uniform(0.05, 0.5))
    return Experiment(
        beam=MonochromaticBeam(wavelength=wl),
        panel=simple_panel(dist, (npx / 2, npx / 2), (px, px), (npx, npx)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, n_img), oscillation=(0.0, osc)),
        crystal=Crystal(vecs[0], vecs[1], vecs[2]),
    )


def match_order(p) -> np.ndarray:
    """The rows of a prediction sorted on (entering, h, k, l, frame): the
    key under which two searches' memberships are compared."""
    return np.lexsort((p.xyzcal_px[:, 2], p.hkl[:, 2], p.hkl[:, 1], p.hkl[:, 0], p.entering))


def compare(blocked, per_image) -> dict:
    """{'n_dev', 'n_host', 'px_diff'} and, where they differ, 'fail': the
    count, the membership, entering, or px beyond PX_TOL."""
    res = {"n_dev": len(blocked.hkl), "n_host": len(per_image.hkl)}
    if res["n_dev"] != res["n_host"]:
        return {**res, "fail": "count"}
    if not res["n_dev"]:
        return {**res, "px_diff": 0.0}
    kd, kh = match_order(blocked), match_order(per_image)
    if not (blocked.hkl[kd] == per_image.hkl[kh]).all():
        return {**res, "fail": "membership"}
    if not (blocked.entering[kd] == per_image.entering[kh]).all():
        return {**res, "fail": "entering"}
    res["px_diff"] = float(np.abs(blocked.xyzcal_px[kd] - per_image.xyzcal_px[kh]).max())
    if res["px_diff"] > PX_TOL:
        res["fail"] = "px"
    return res


def run_seed(seed: int, device: torch.device | None = None) -> dict:
    from ..prediction.rotation import predict_rotation

    expt = experiment(seed)
    blocked = predict_rotation(expt, device=device)
    per_image = predict_rotation(expt, use_device=False, device=device)
    return {"seed": seed, **compare(blocked, per_image)}


def main(argv=None) -> int:
    from ..utils import torchinit

    argv = sys.argv[1:] if argv is None else argv
    n_seeds = int(argv[0]) if len(argv) > 0 else 20
    start = int(argv[1]) if len(argv) > 1 else 0
    torchinit.setup()
    device = torchinit.select_device()
    fails = 0
    t0 = time.time()
    for seed in range(start, start + n_seeds):
        r = run_seed(seed, device)
        status = r.get("fail", "ok")
        print(f"seed {seed}: n={r['n_dev']}/{r['n_host']} "
              f"px_diff={r.get('px_diff', float('nan')):.2e} {status}", flush=True)
        fails += status != "ok"
    print(f"{n_seeds} seeds, {fails} failures, {time.time() - t0:.0f} s on "
          f"{torchinit.device_name(device)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
