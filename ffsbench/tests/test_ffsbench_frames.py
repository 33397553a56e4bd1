"""The frame maker against its traffic parameters."""

from __future__ import annotations

import json
import pathlib

import torch

from ffsbench import frames

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def test_wilson_intensities_are_exponential_with_the_traffic_mean():
    sp = {"intensity": {"kind": "wilson_acentric", "mean": 3000.0}}
    level = frames.spot_intensities(sp, 200_000, frames.generator(7, CPU), CPU)
    assert abs(float(level.mean()) / 3000.0 - 1) < 0.01
    # the exponential law's median is ln 2 of its mean
    assert abs(float(level.median()) / 3000.0 - 0.6931) < 0.01


def test_profiles_have_unit_sum_and_widths_in_range():
    sp = {"half_width": 2, "sigma_px": [0.5, 1.2]}
    prof = frames.spot_profiles(sp, 1000, frames.generator(3, CPU), CPU)
    assert prof.shape == (1000, 5, 5)
    torch.testing.assert_close(prof.sum(dim=(1, 2)), torch.ones(1000))
    centre = prof[:, 2, 2]
    assert bool((prof.amax(dim=(1, 2)) == centre).all())
    # sigma 0.5 keeps ~62% in the centre pixel; sigma 1.2 ~11%
    assert 0.10 < float(centre.min()) and float(centre.max()) < 0.63


def test_same_seed_same_frames_and_spots_reach_bragg_peak_counts():
    cfg = json.loads((ROOT / "ffsbench/configs/eiger16m-rotation-f64.json").read_text())
    cfg["detector"].update(height=400, width=300, mask={"kind": "modules", "module": [190, 140],
                                                        "gap": [20, 20], "grid": [2, 2]})
    tr = json.loads((ROOT / "ffsbench/traffic/rotation300.catchup.json").read_text())
    tr["distinct_frames"] = 4
    a = frames.make_frames(cfg, tr, 2**31 + 5, CPU)
    b = frames.make_frames(cfg, tr, 2**31 + 5, CPU)
    assert a.dtype == torch.uint16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert frames.checksums(a) == frames.checksums(b)
    values = a.view(torch.int16).to(torch.int64) & 0xFFFF
    assert int(values.max()) > 1000  # the brightest reflections of 1200 reach Bragg-peak counts
    # spot sets hold for two frames: frames 0 and 1 share their bright pixels
    assert float(((values[0] > 100) & (values[1] > 100)).sum()) > 50
