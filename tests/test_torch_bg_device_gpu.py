"""The ``--bg-device`` functions on the card against the port's host
functions: the device background (both models, with their row blocks),
the device bounding boxes (bit for bit, with and without parallax,
degenerate-zeta and NaN rows) and the device finalisation, at a few
thousand rows; and inputs on a second card compute there.

Marked ``gpu``: skips where ``torch.cuda.is_available()`` is False
(decided inside the fixtures).  On a GPU machine run

    python -m pytest tests/test_torch_bg_device_gpu.py -m gpu --noconftest -q

The functions that make the inputs serve the CPU parity tests too
(tests/test_torch_bg_device.py); they use the port's models only.
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.integration import background as bg_host
from ffs_tpu_torch.integration import background_device as tbg
from ffs_tpu_torch.integration import extent as textent
from ffs_tpu_torch.integration import finalize as tfin
from ffs_tpu_torch.integration.kabsch import Accumulators
from ffs_tpu_torch.models.crystal import Crystal
from ffs_tpu_torch.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

NUM_BINS = bg_host.NUM_BG_BINS
FIN_FLOATS = ("intensity", "variance", "background_mean", "background_sum", "xyzobs_px",
              "partiality", "lp", "d")


def edge_histograms(n_poisson: int = 48, seed: int = 3):
    """(bins, overflow, labels): Poisson backgrounds of a range of means,
    then the edge rows: more than 25% overflow, fewer than 10 pixels, empty,
    all pixels at 0 (the GLM walks beta down for 76 iterations), and a
    bimodal row on which the GLM oscillates until GLM_MAX_ITER."""
    rng = np.random.default_rng(seed)
    rows, over, labels = [], [], []

    def add(label, row, ov=0):
        rows.append(row)
        over.append(ov)
        labels.append(label)

    for lam, npx in zip(rng.uniform(0.3, 80.0, n_poisson), rng.integers(10, 600, n_poisson)):
        v = rng.poisson(lam, npx)
        add("poisson", np.bincount(v[v < NUM_BINS], minlength=NUM_BINS), int((v >= NUM_BINS).sum()))
    row = np.bincount(rng.poisson(200.0, 100).clip(0, NUM_BINS - 1), minlength=NUM_BINS)
    add("overflow>25%", row, 60)
    add("overflow<25%", row, int(row.sum()) // 3)
    few = np.zeros(NUM_BINS, np.int64)
    few[[2, 3, 5]] = [3, 4, 2]
    add("9 pixels", few)
    add("empty", np.zeros(NUM_BINS, np.int64))
    zeros = np.zeros(NUM_BINS, np.int64)
    zeros[0] = 50
    add("all zero", zeros)
    bimodal = np.zeros(NUM_BINS, np.int64)
    bimodal[[2, 40]] = [2001, 2000]
    add("max iter", bimodal)
    bimodal2 = np.zeros(NUM_BINS, np.int64)
    bimodal2[[0, 2, 255]] = [300, 1, 300]
    add("max iter", bimodal2)
    return np.stack(rows).astype(np.int64), np.asarray(over, np.int64), labels


def bbox_inputs(parallax: bool, n: int = 512, seed: int = 31):
    """tests/test_integration.py's device-bbox geometry at n rows, with
    rows in the plane of the beam and the axis (zeta exactly 0), rays along
    the beam (NaN frames) and rays parallel to the panel."""
    rng = np.random.default_rng(seed)
    beam = MonochromaticBeam(wavelength=0.976)
    scan = Scan(image_range=(1, 100), oscillation=(0.0, 0.1))
    panel = simple_panel(200.0, (1034, 1082), (0.075, 0.075), (2068, 2164), mu=0.3974,
                         thickness=0.45, parallax=parallax)
    x = rng.uniform(50, 2000, n)
    y = rng.uniform(50, 2100, n)
    xmm, ymm = panel.px_to_mm(x, y)
    lab = panel.get_lab_coord(xmm, ymm)
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    s1[:8, 1] = 0.0  # zeta == 0 exactly: the degenerate override
    s1[8:12] = np.asarray(beam.s0)  # s1 x s0 == 0: NaN frames
    s1[12:14] = [[1.0 / beam.wavelength, 0.0, 0.0], [0.0, 1.0 / beam.wavelength, 0.0]]
    phi = np.deg2rad(rng.uniform(0, 10, n))
    return (np.asarray(beam.s0), np.array([1.0, 0.0, 0.0]), s1, phi, np.deg2rad(0.03),
            np.deg2rad(0.1), panel, scan)


def finalize_inputs(n: int = 512, seed: int = 23):
    """tests/test_integration.py's device-finalize inputs at n rows."""
    rng = np.random.default_rng(seed)
    acc = Accumulators.zeros(n)
    acc.fg_sum[:] = rng.poisson(500.0, n).astype(float)
    acc.fg_sum[:32] = 0.0  # unmeasured rows exercise the fallbacks
    acc.fg_count[:] = rng.integers(0, 60, n)
    acc.fg_count[:32] = 0
    acc.bg_count[:] = rng.integers(0, 400, n)
    acc.sum_ix[:] = acc.fg_sum * rng.uniform(100, 2000, n)
    acc.sum_iy[:] = acc.fg_sum * rng.uniform(100, 2000, n)
    acc.sum_iz[:] = acc.fg_sum * rng.uniform(0, 100, n)
    s1 = rng.normal(size=(n, 3))
    s1 /= np.linalg.norm(s1, axis=1, keepdims=True) * 0.976
    bb = np.zeros((n, 6), dtype=np.int64)
    bb[:, 1] = bb[:, 3] = 20
    bb[:, 4] = rng.integers(0, 96, n)
    bb[:, 5] = bb[:, 4] + 4
    return dict(
        acc=acc, bg_mean=rng.uniform(3.5, 4.5, n), bg_wsum=rng.uniform(250, 350, n),
        bg_valid=rng.random(n) > 0.05, bboxes=bb, s1=s1,
        phi=np.deg2rad(rng.uniform(0, 10, n)), hkl=rng.integers(-40, 41, size=(n, 3)),
        zeta=rng.uniform(0.05, 1.0, n), scan=Scan(image_range=(1, 100), oscillation=(0.0, 0.1)),
        beam=MonochromaticBeam(wavelength=0.976), gonio=Goniometer(),
        crystal=Crystal(*np.diag([57.78, 57.78, 150.0])), sigma_m=np.deg2rad(0.1),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["tukey", "glm"])
def test_device_background_on_the_card(cuda, monkeypatch, model):
    bins, over, _ = edge_histograms(n_poisson=4000)
    got = tbg.estimate_background_device(bins, over, model, device=cuda)
    assert all(v.device == cuda for v in got)
    want = bg_host.estimate_background(bins, over, model)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2])
    # row blocks on the card: the same masks; the values within the same
    # tolerance, not bit for bit, since CUDA's row reductions (the sum over
    # the bins, the pdf's running sum) split a row by the tensor's shape
    monkeypatch.setattr(tbg, "ROW_BLOCK", 257)
    blocked = tbg.estimate_background_device(bins, over, model, device=cuda)
    assert torch.equal(blocked[2], got[2])
    for x, y in zip(blocked[:2], got[:2]):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("parallax", [False, True])
def test_device_bboxes_on_the_card_equal_the_host(cuda, parallax):
    args = bbox_inputs(parallax, n=4096)
    got = textent.compute_kabsch_bounding_boxes_device(*args, device=cuda)
    want = textent.compute_kabsch_bounding_boxes(*args)
    np.testing.assert_array_equal(got, want)
    assert (got[8:12] == np.iinfo(np.int64).min).all()


@pytest.mark.gpu
def test_finalize_device_on_the_card(cuda):
    kw = finalize_inputs(n=4096)
    want = tfin.finalize(**kw)
    got = tfin.finalize_device(**kw, device=cuda)
    assert got.n_background_failures == want.n_background_failures
    np.testing.assert_array_equal(got.valid, want.valid)
    for f in FIN_FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=1e-14,
                                   err_msg=f)


@pytest.mark.gpu
def test_inputs_on_a_second_card_compute_there(second_card):
    """Tensors on cuda:1 keep the background and the finalisation there:
    the results lie on cuda:1 and nothing is allocated on cuda:0."""
    bins, over, _ = edge_histograms()
    before = torch.cuda.memory_allocated(0)
    torch.cuda.reset_peak_memory_stats(0)
    bg = tbg.estimate_background_device(torch.as_tensor(bins, device=second_card),
                                        torch.as_tensor(over, device=second_card), "glm")
    assert all(v.device == second_card for v in bg)
    kw = finalize_inputs(n=len(bins))
    kw["bg_mean"], kw["bg_wsum"], kw["bg_valid"] = bg
    kw["s1"] = torch.as_tensor(kw["s1"], device=second_card)
    tfin.finalize_device(**kw)
    args = list(bbox_inputs(False, n=256))
    args[2] = torch.as_tensor(args[2], device=second_card)
    textent.compute_kabsch_bounding_boxes_device(*args)
    torch.cuda.synchronize(second_card)
    assert torch.cuda.max_memory_allocated(0) == before
