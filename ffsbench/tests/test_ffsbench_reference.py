"""The plain reference against hand-made frames and hand-worked answers."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch
from scipy import ndimage

from ffsbench import reference as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]

SF = {"min_spot_size": 3, "max_peak_centroid_separation": 2.0, "min_spot_size_3d": 3}


def test_flat_frame_has_no_strong_pixels():
    img = torch.full((40, 50), 7, dtype=torch.int32).to(torch.int16).view(torch.uint16)
    mask = torch.ones(40, 50, dtype=torch.uint8)
    for algo in ref.ALGORITHMS.values():
        assert not algo(img, mask, 65530.0, torch.float64).any()


def test_one_bright_spot_on_a_noisy_background():
    rng = np.random.default_rng(4)
    frame = rng.poisson(2.0, size=(60, 70)).astype(np.int64)
    frame[30:33, 40:43] += np.array([[50, 120, 50], [120, 600, 120], [50, 120, 50]])
    img = torch.from_numpy(frame.astype(np.int16)).view(torch.uint16)
    mask = torch.ones(60, 70, dtype=torch.uint8)
    for name, algo in ref.ALGORITHMS.items():
        strong = algo(img, mask, 65530.0, torch.float64).numpy()
        assert strong[31, 41], name
        ys, xs = np.nonzero(strong)
        assert ys.min() >= 29 and ys.max() <= 33 and xs.min() >= 39 and xs.max() <= 43, name


def test_masked_and_overloaded_pixels_are_never_strong():
    frame = np.full((30, 30), 2, np.int64)
    frame[15, 15] = 900
    frame[5, 5] = 900
    img = torch.from_numpy(frame.astype(np.int16)).view(torch.uint16)
    mask = torch.ones(30, 30, dtype=torch.uint8)
    mask[5, 5] = 0
    strong = ref.dispersion(img, mask, 65530.0, torch.float64)
    assert strong[15, 15] and not strong[5, 5]
    assert not ref.dispersion(img, mask, 800.0, torch.float64)[15, 15]


def test_window_sums_equal_a_direct_sum():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 100, size=(23, 31))
    got = ref.box_sum(torch.from_numpy(a).to(torch.float64), 3).numpy()
    p = np.pad(a, 3)
    want = np.array([[p[y : y + 7, x : x + 7].sum() for x in range(31)] for y in range(23)])
    np.testing.assert_array_equal(got, want)


def test_labels_match_scipy_four_connectivity_in_raster_order():
    rng = np.random.default_rng(6)
    for _ in range(5):
        strong = rng.random((37, 41)) < 0.3
        lin = np.flatnonzero(strong)
        got = ref.label_pixels(lin, 41)
        want, _ = ndimage.label(strong)  # the default structure is 4-connected
        np.testing.assert_array_equal(got + 1, want.reshape(-1)[lin])


def test_spot_statistics_by_hand():
    # one spot: (x, y, value) = (2, 1, 10), (3, 1, 30), (3, 2, 30): peak tie -> first pixel
    width = 8
    lin = np.array([1 * width + 2, 1 * width + 3, 2 * width + 3])
    value = np.array([10, 30, 30])
    label = ref.label_pixels(lin, width)
    n_px, com, peak = ref.spot_stats(label, lin % width, lin // width, np.zeros(3, np.int64),
                                     value, np.float64)
    assert n_px.tolist() == [3]
    assert com[0][0] == (2 * 10 + 3 * 30 + 3 * 30) / 70 + 0.5
    assert com[1][0] == (1 * 10 + 1 * 30 + 2 * 30) / 70 + 0.5
    assert (peak[0][0], peak[1][0]) == (3, 1)


def test_frame_spots_filters_by_size_and_separation():
    frame = np.zeros((20, 20), np.int64)
    strong = np.zeros((20, 20), bool)
    strong[2, 2:5] = True  # 3 px: kept
    strong[10, 10:12] = True  # 2 px: too small
    strong[15, 3] = True
    frame[strong] = 5
    out = ref.frame_spots(torch.from_numpy(strong),
                          torch.from_numpy(frame.astype(np.int16)).view(torch.uint16), SF,
                          np.float64)
    assert len(out.lin) == 6 and out.n_spots == 1
    np.testing.assert_array_equal(out.centers, [[3.0 + 0.5, 2.5, 0.5]])


def _config():
    return {"detector": {"height": 20, "width": 20, "pixel_size_mm": 0.075},
            "geometry": {"distance_mm": 200.0, "beam_center_px": [10.0, 10.0],
                         "wavelength_A": 1.0, "omega_start_deg": 0.0,
                         "omega_increment_deg": 0.1},
            "spotfinder": SF}


def _frame(pixels):
    width = 20
    lin = np.array(sorted(y * width + x for x, y, _ in pixels))
    value = np.array([v for _, _, v in sorted(pixels, key=lambda p: p[1] * width + p[0])])
    return ref.FrameSpots(lin, value, 0, np.zeros((0, 3)))


def test_rotation_table_joins_a_spot_across_frames():
    a = _frame([(5, 5, 10), (6, 5, 20), (5, 6, 10), (15, 15, 9)])
    b = _frame([(5, 5, 30), (6, 6, 10), (15, 16, 9)])
    c = _frame([(1, 1, 7)])
    table = ref.rotation_table([a, b, c], _config())
    # spot 1: frame 0's three pixels and frame 1's (5, 5), joined through (5, 5); frame 1's
    # (6, 6) touches it only diagonally, and the (15, 15) / (15, 16) pair shares no pixel:
    # both stay apart, below 3 px, as does frame 2's single pixel
    assert table["spot_extent_z"].tolist() == [2]
    com = table["xyzobs.px.value"][0]
    w = np.array([10, 20, 10, 30])
    xs, ys, zs = np.array([5, 6, 5, 5]), np.array([5, 5, 6, 5]), np.array([0, 0, 0, 1])
    np.testing.assert_allclose(com, [(w * xs).sum() / 70 + 0.5, (w * ys).sum() / 70 + 0.5,
                                     (w * zs).sum() / 70 + 0.5], rtol=0, atol=1e-12)
    assert table["sigma_b_variance"][0] > 0 and table["sigma_m_variance"][0] > 0


STEP_BELOW = {"f64": "f32", "f32": "bf16"}


@pytest.mark.parametrize("name", ["eiger16m-rotation-f64", "jungfrau1m-ssx-f32"])
def test_each_control_lowers_one_stage_by_one_step(name):
    config = json.loads((ROOT / "ffsbench" / "configs" / f"{name}.json").read_text())
    ctl, precision = config["control"], config["spotfinder"]["precision"]
    lowered = [ctl["threshold"] == STEP_BELOW[precision], ctl["tables"] == "float32"]
    assert sorted(lowered) == [False, True]  # one stage, one step below
    assert ctl["threshold"] in (precision, STEP_BELOW[precision])
    assert ctl["tables"] in ("float64", "float32")
    if ctl["program_flags"]:
        flags = ctl["program_flags"]
        assert flags[flags.index("--precision") + 1] == STEP_BELOW[precision]
    rng = np.random.default_rng(8)
    frame = rng.poisson(2.0, size=(64, 64)).astype(np.int64)
    frame[20:23, 30:33] += 300
    img = torch.from_numpy(frame.astype(np.int16)).view(torch.uint16)
    mask = torch.ones(64, 64, dtype=torch.uint8)
    algo = ref.ALGORITHMS[config["spotfinder"]["algorithm"]]
    assert algo(img, mask, 65530.0, ref.DTYPES[ctl["threshold"]])[21, 31]


@pytest.mark.gpu
def test_thresholds_agree_between_the_card_and_the_cpu(card):
    rng = np.random.default_rng(9)
    frame = rng.poisson(2.0, size=(300, 280)).astype(np.int64)
    frame[100:103, 40:43] += 500
    img = torch.from_numpy(frame.astype(np.int16)).view(torch.uint16)
    mask = torch.ones(300, 280, dtype=torch.uint8)
    for algo in ref.ALGORITHMS.values():
        for dtype in (torch.float64, torch.float32):
            cpu = algo(img, mask, 65530.0, dtype)
            gpu = algo(img.to(card), mask.to(card), 65530.0, dtype).cpu()
            assert torch.equal(cpu, gpu)
