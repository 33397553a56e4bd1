"""baseline_predictor CLI on PyTorch — rotation spot prediction.

Counterpart of :mod:`ffs_tpu.pipeline.predictor` (reference
`baseline_predictor`, baseline/predictor/predict_cli.cc) with the same
flags, messages, exit codes and ``predicted.refl`` columns: indexed or
refined expt JSON in, ``predicted.refl`` out with miller_index, panel,
entering, s1, xyzcal.px, xyzcal.mm, flags (predicted) and id.  The ray
search runs on the device (:func:`..prediction.rotation.predict_rotation`):
the CUDA device, or the CPU under ``FFS_TORCH_DEVICE=cpu``.

Console script: ``baseline_predictor_torch``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run(argv=None) -> int:
    from ..models.experiment import Experiment
    from ..models.geometry import Scan
    from ..models.reflection_table import ReflectionTable
    from ..prediction.rotation import ScanVaryingData, parse_scan_varying, predict_rotation
    from ..utils import torchinit

    torchinit.setup()
    p = argparse.ArgumentParser(prog="baseline_predictor")
    p.add_argument("-e", "--expt", required=True, help="path to DIALS expt file")
    p.add_argument("--dmin", type=float, default=-1.0)
    p.add_argument("-b", "--buffer_size", type=int, default=0)
    p.add_argument("-s", "--force_static", action="store_true")
    p.add_argument("-n", "--nthreads", type=int, default=None)
    p.add_argument("--output", default="predicted.refl")
    args = p.parse_args(argv)
    if args.buffer_size < 0:
        print("Error: buffer_size must be >= 0")
        return 1

    with open(args.expt) as f:
        elist = json.load(f)
    expt = Experiment.from_json_obj(elist)
    if expt.crystal is None:
        print("Error: experiment has no crystal model")
        return 1

    n_images = expt.scan.image_range[1] - expt.scan.image_range[0] + 1
    sv = ScanVaryingData() if args.force_static else parse_scan_varying(elist, n_images)

    if args.buffer_size > 0:
        if sv:
            print("Error: Can't call predict function with scan varying data and an image buffer.")
            return 1
        r0, r1 = expt.scan.image_range
        osc0, osc_w = expt.scan.oscillation
        expt.scan = Scan(
            (r0 - args.buffer_size, r1 + args.buffer_size),
            (osc0 - args.buffer_size * osc_w, osc_w),
        )

    dmin = args.dmin if args.dmin > 0 else None
    pred = predict_rotation(expt, sv, dmin, device=torchinit.select_device())
    print(f"Predicted {len(pred.hkl)} reflections")

    table = ReflectionTable()
    table["miller_index"] = pred.hkl.astype(np.int32)
    table["panel"] = pred.panel
    table["entering"] = pred.entering.astype(np.uint8)
    table["s1"] = pred.s1
    table["xyzcal.px"] = pred.xyzcal_px
    table["xyzcal.mm"] = pred.xyzcal_mm
    table["flags"] = pred.flags
    table["id"] = np.zeros(len(pred.hkl), dtype=np.int64)
    if expt.identifier:
        table.identifiers = [expt.identifier]
    table.write(args.output)
    print(f"Saved predicted reflections to {args.output}")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    sys.exit(run())
