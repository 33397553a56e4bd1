"""The port's ``--bg-device`` functions against the JAX package's device
functions, on the CPU: the device background (both models) on edge-row
histograms, the row blocks of both models, the device bounding boxes (bit for bit,
with and without parallax, degenerate-zeta and NaN rows) and the device
finalisation.  Values within 1e-12 relative, masks and counts exactly.
The inputs (port models, which the JAX functions take as they take their
own) come from the GPU file, which runs the same cases on the card.
"""

import numpy as np
import pytest
import torch

from ffs_tpu.integration import background as bg_host
from ffs_tpu.integration import background_jax as bg_jax
from ffs_tpu.integration import extent as jextent
from ffs_tpu.integration import finalize as jfin
from ffs_tpu_torch.integration import background_device as tbg
from ffs_tpu_torch.integration import extent as textent
from ffs_tpu_torch.integration import finalize as tfin

from .test_torch_bg_device_gpu import FIN_FLOATS, bbox_inputs, edge_histograms, finalize_inputs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def histograms():
    return edge_histograms()


def _assert_close(got, want, name):
    # the JAX package's own tolerance for its device background against
    # NumPy (tests/test_integrator_cli.py::test_bg_device_dispatch_matches_host):
    # the all-zero row walks beta down to about -76, and where it stops
    # moves with an ulp of exp/lgamma, at a mean of ~1e-33
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("model", ["tukey", "constant", "dials", "glm"])
def test_device_background_matches_jax(histograms, model):
    bins, over, labels = histograms
    want = [np.asarray(v) for v in bg_jax.estimate_background_device(bins, over, model)]
    got = [v.numpy() for v in tbg.estimate_background_device(bins, over, model, device=CPU)]
    host = bg_host.estimate_background(bins, over, "tukey" if model == "dials" else model)
    for a, b, h, name in zip(got, want, host, ("mean", "weighted_sum")):
        _assert_close(a, b, name)
        _assert_close(a, h, name + " (host)")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], host[2])
    assert got[2].dtype == bool
    valid = dict(zip(labels, got[2]))
    assert not valid["empty"] and not valid["overflow>25%"]
    assert got[2][[i for i, lab in enumerate(labels) if lab == "poisson"]].mean() > 0.9
    if model == "glm":
        # rows the GLM never converges on: alive (>= 10 pixels, no tail),
        # so invalid only because the loop stopped at GLM_MAX_ITER
        idx = [i for i, lab in enumerate(labels) if lab == "max iter"]
        assert not got[2][idx].any()
        assert (bins[idx].sum(axis=1) >= bg_host.GLM_MIN_PIXELS).all() and not over[idx].any()
        assert not valid["9 pixels"] and valid["all zero"]


def test_device_background_rejects_an_unknown_model(histograms):
    bins, over, _ = histograms
    with pytest.raises(ValueError, match="unknown background model"):
        tbg.estimate_background_device(bins, over, "median", device=CPU)


@pytest.mark.parametrize("block", [1, 5, 17])
@pytest.mark.parametrize("model", ["tukey", "glm"])
def test_row_blocks_give_the_unblocked_results(histograms, monkeypatch, model, block):
    """Blocks of ROW_BLOCK rows give the one-pass results exactly.  For the
    GLM, blocks stop when their own rows are done (a row alone stops at its
    own convergence, the max-iter rows' block at GLM_MAX_ITER): means,
    weighted sums and masks equal the one-pass loop's all the same."""
    bins, over, _ = histograms
    b, o = torch.as_tensor(bins), torch.as_tensor(over)
    rows_fn = {"tukey": tbg._tukey_rows, "glm": tbg._glm_rows}[model]
    whole = rows_fn(b, o, torch.float64)
    monkeypatch.setattr(tbg, "ROW_BLOCK", block)
    blocked = tbg.estimate_background_device(b, o, model)
    # for the GLM it holds because a converged beta outside (-300, 300) is
    # invalid, which covers every beta whose exp is 0, inf or NaN: the only
    # ways a converged row's alive flag can still change in a longer loop
    for x, y in zip(blocked, whole):
        assert torch.equal(x, y)


@pytest.mark.parametrize("parallax", [False, True])
def test_device_bboxes_equal_jax_bit_for_bit(parallax):
    args = bbox_inputs(parallax)
    want = jextent.compute_kabsch_bounding_boxes_device(*args)
    host = textent.compute_kabsch_bounding_boxes(*args)
    got = textent.compute_kabsch_bounding_boxes_device(*args, device=CPU)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    z0, z1 = args[-1].image_range
    assert (got[:8, 4] == z0).all() and (got[:8, 5] == z1).all()
    assert (got[8:12] == np.iinfo(np.int64).min).all()
    assert (np.abs(got[14:, :4]) < 10_000).all()


def test_finalize_device_matches_jax():
    kw = finalize_inputs()
    want = jfin.finalize_device(**kw)
    host = tfin.finalize(**kw)
    got = tfin.finalize_device(**kw, device=CPU)
    for ref in (want, host):
        assert got.n_background_failures == ref.n_background_failures > 0
        np.testing.assert_array_equal(got.valid, ref.valid)
        for f in FIN_FLOATS:
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == np.float64 and a.shape == b.shape, f
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=f)


def test_finalize_device_takes_the_device_background():
    """The integrator hands the device background's tensors straight on."""
    kw = finalize_inputs(n=64)
    want = tfin.finalize(**kw)
    for k in ("bg_mean", "bg_wsum", "bg_valid"):
        kw[k] = torch.as_tensor(kw[k])
    got = tfin.finalize_device(**kw)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.intensity, want.intensity, rtol=1e-12, atol=1e-14)
