"""ffs_tpu_torch.integration.kabsch against ffs_tpu's KabschIntegrator.

The same synthetic collection (the ``integration_experiment`` of
tests/test_integration.py: a 240x260 panel, 12 images, Poisson background,
Gaussian spots at the predictions, a masked block) goes through the JAX
integrator (default lane-packed step, Pallas gathers in interpret mode) and
the port on the CPU (the gathers' plain versions).  The eight accumulators
must be equal bit for bit; the in-plane term e12 within 6 float32 ulp of
JAX's and close to its float64 value (test_chunk_geometry_matches_jax).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.integration import extent as extent_mod
from ffs_tpu.integration import kabsch as jkb
from ffs_tpu.prediction.rotation import predict_rotation
from ffs_tpu_torch.integration import kabsch as tkb
from ffs_tpu_torch.models.experiment import experiment_from_state

from .test_integration import _SyntheticReader, integration_experiment  # noqa: F401

CPU = torch.device("cpu")
FIELDS = (
    "fg_sum", "fg_count", "sum_ix", "sum_iy", "sum_iz", "bg_hist", "bg_overflow", "bg_count",
)


def torch_experiment(expt):
    parts = ("beam", "panel", "goniometer", "scan", "crystal")
    return experiment_from_state(
        {k: dataclasses.asdict(getattr(expt, k)) for k in parts if getattr(expt, k) is not None}
    )


@pytest.fixture(scope="module")
def collection():
    from ffs_tpu.models.crystal import Crystal
    from ffs_tpu.models.experiment import Experiment
    from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    expt = Experiment(
        beam=MonochromaticBeam(wavelength=1.0),
        panel=simple_panel(120.0, (120.0, 130.0), (0.3, 0.3), (240, 260)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, 12), oscillation=(0.0, 1.0)),
        crystal=Crystal([40.0, 0, 0], [0, 50.0, 0], [0, 0, 60.0]),
    )
    pred = predict_rotation(expt, dmin=4.0, use_device=False)
    x, y, z = pred.xyzcal_px.T
    keep = (x > 20) & (x < 220) & (y > 20) & (y < 240) & (z > 1.5) & (z < 10.5)
    s1, phi = pred.s1[keep], pred.xyzcal_mm[keep][:, 2]
    P = types.SimpleNamespace(
        hkl=pred.hkl[keep], s1=s1, xyzcal_px=pred.xyzcal_px[keep], xyzcal_mm=pred.xyzcal_mm[keep]
    )
    reader = _SyntheticReader(expt, P, seed=3)
    reader._mask[100:120, 80:160] = 0  # a masked block over some shoeboxes
    sigma_b, sigma_m = np.deg2rad(0.08), np.deg2rad(0.4)
    bboxes = extent_mod.compute_kabsch_bounding_boxes(
        expt.beam.s0, expt.goniometer.rotation_axis, s1, phi, sigma_b, sigma_m,
        expt.panel, expt.scan,
    )
    w, h = expt.panel.image_size
    for j, lim in ((0, w - 1), (1, w - 1), (2, h - 1), (3, h - 1)):
        bboxes[:, j] = np.clip(bboxes[:, j], 0, lim)
    return types.SimpleNamespace(
        expt=expt, texpt=torch_experiment(expt), s1=s1, phi=phi, bboxes=bboxes,
        reader=reader, delta_b=3 * sigma_b * 2, delta_m=3 * sigma_m,
    )


def _integrators(c, algorithm, max_active, **jax_kw):
    common = dict(s1=c.s1, phi=c.phi, bboxes=c.bboxes, delta_b=c.delta_b, delta_m=c.delta_m,
                  algorithm=algorithm, max_active=max_active)
    e, t = c.expt, c.texpt
    j = jkb.KabschIntegrator(panel=e.panel, beam=e.beam, gonio=e.goniometer, scan=e.scan,
                             **common, **jax_kw)
    p = tkb.KabschIntegrator(panel=t.panel, beam=t.beam, gonio=t.goniometer, scan=t.scan,
                             **common, device=CPU)
    return j, p


@pytest.mark.parametrize("algorithm", ["ellipsoid", "dials"])
def test_integrate_matches_jax(collection, algorithm):
    c = collection
    j, p = _integrators(c, algorithm, max_active=64)
    assert j._lane_group == 4  # the JAX side runs its default packed step
    assert (p.box_w, p.box_h, p._hist_rows, p._hist_lanes) == (
        j.box_w, j.box_h, j._hist_rows, j._hist_lanes
    )
    acc_j, acc_t = jkb.Accumulators.zeros(len(c.s1)), tkb.Accumulators.zeros(len(c.s1))
    images = list(range(0, 12))
    j.integrate(c.reader, images, acc_j)
    p.integrate(c.reader, images, acc_t)
    assert acc_t.fg_count.sum() > 0 and acc_t.bg_overflow.sum() >= 0
    for name in FIELDS:
        a, b = getattr(acc_t, name), getattr(acc_j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the mask block removed pixels from at least one shoebox
    full = (c.bboxes[:, 1] - c.bboxes[:, 0] + 1) * (c.bboxes[:, 3] - c.bboxes[:, 2] + 1)
    assert ((acc_t.fg_count + acc_t.bg_count) < full * (c.bboxes[:, 5] - c.bboxes[:, 4])).any()


def test_chunk_geometry_matches_jax(collection):
    """The chunk's corner field, in-plane term e12 and mask windows against
    the JAX package's classic (unpacked) chunk setup."""
    c = collection
    j, p = _integrators(c, "ellipsoid", max_active=64, lane_pack=False)
    j.set_mask(c.reader.get_mask())
    p.set_mask(c.reader.get_mask())
    cs = extent_mod.coordinate_systems(c.expt.beam.s0, c.expt.goniometer.rotation_axis, c.s1)
    chunk = np.arange(min(len(c.s1), 49))  # a short chunk: padded rows too
    # the float64 corner field agrees to an ulp or two (XLA's CPU norm fuses
    # its squares into FMAs, the port rounds each product), and its hi/lo
    # float32 split carries ~48 bits of |s| = 1/wavelength = 1
    field_j = np.array(j.corner_field_f32())
    field_t = p.corner_field_f32().numpy().astype(np.float64)
    np.testing.assert_allclose(
        field_t[:3] + field_t[3:], field_j[:3].astype(np.float64) + field_j[3:], rtol=0,
        atol=2.0**-46,
    )
    # e12 from the same field: near the shoebox centre delta = field - s1
    # cancels, so an ulp of the field would move e12 by many ulp there
    p._field6 = torch.from_numpy(field_j)
    dj = j._chunk_setup(chunk, cs.e1, cs.e2, cs.zeta)
    dt = p._chunk_setup(chunk, cs.e1, cs.e2, cs.zeta)
    np.testing.assert_array_equal(dt["maskw"].numpy(), np.asarray(dj["maskw"]))
    ej, et = np.asarray(dj["e12"]), dt["e12"].numpy()
    assert ej.dtype == et.dtype == np.float32 and ej.shape == et.shape
    # wherever e12 is not itself a cancellation residue (> 1e-3): the port
    # within 6 float32 ulp of the JAX step (the largest distance on this
    # collection: XLA's CPU code runs the three-term dots as FMA chains,
    # the port rounds each product), and both within 1e-6
    # relative of e12 in float64 from the same field
    a = len(chunk)
    y0, x0 = p.bboxes[chunk, 2], p.bboxes[chunk, 0]
    fw = tkb.window_gather_planes(torch.from_numpy(field_j), y0, x0, bh=p.box_h + 8).numpy()
    delta = fw[:, :3].astype(np.float64) + fw[:, 3:] - c.s1[chunk][:, :, None, None]
    s1_len = np.linalg.norm(c.s1[chunk], axis=1)[:, None, None]
    eps = [np.einsum("akhw,ak->ahw", delta, e[chunk]) / s1_len for e in (cs.e1, cs.e2)]
    want = ((eps[0] ** 2 + eps[1] ** 2) / np.float32(p._delta_b**2))[:, : p.box_h + 1]
    live = want > 1e-3
    et_live, ej_live = et[:a][live], ej[:a][live]
    assert (et_live > 0).all() and (ej_live > 0).all()  # positive: the bits order like the values
    ulp = np.abs(et_live.view(np.int32).astype(np.int64) - ej_live.view(np.int32).astype(np.int64))
    assert ulp.max() <= 6
    np.testing.assert_allclose(et_live, want[live], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ej_live, want[live], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(et[a:], ej[a:])  # padded rows


def test_fill_histogram_matches_jax(collection):
    c = collection
    j, p = _integrators(c, "ellipsoid", max_active=64)
    bboxes = np.concatenate([c.bboxes, [[0, -1, 0, -1, 0, -1]]])
    want = jkb.format_shoebox_fill_histogram(bboxes, j.box_w, j.box_h, j.max_active)
    assert want and tkb.format_shoebox_fill_histogram(bboxes, p.box_w, p.box_h, p.max_active) == want


def test_32bit_guard_matches_jax():
    """Both raise on 32-bit pixel values past the exact-i32 accumulation
    bound, and both integrate in-bound 32-bit data to the same sums."""
    from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    iw, ih, nf = 128, 64, 4
    panel = simple_panel(150.0, (iw / 2, ih / 2), (0.075, 0.075), (iw, ih))
    beam = MonochromaticBeam(wavelength=0.976)
    scan = Scan(image_range=(1, nf), oscillation=(0.0, 0.1))
    x, y = np.array([40.0, 80.0]), np.array([30.0, 40.0])
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    kw = dict(
        s1=s1, phi=np.deg2rad(np.array([0.05, 0.15])),
        bboxes=np.stack([x - 4, x + 4, y - 4, y + 4, [0, 0], [2, 2]], axis=1).astype(np.int64),
        delta_b=np.deg2rad(0.3), delta_m=np.deg2rad(1.0), max_active=2,
    )
    texpt = torch_experiment(
        types.SimpleNamespace(beam=beam, panel=panel, goniometer=Goniometer(), scan=scan,
                              crystal=None)
    )

    class _HotReader:
        def __init__(self, hot):
            self.hot = hot

        def get_image(self, n):
            img = np.zeros((ih, iw), np.uint32)
            img[30:34, 38:42] = self.hot
            return img

        def get_mask(self):
            return None

    j = jkb.KabschIntegrator(panel=panel, beam=beam, gonio=Goniometer(), scan=scan, **kw)
    p = tkb.KabschIntegrator(panel=texpt.panel, beam=texpt.beam, gonio=texpt.goniometer,
                             scan=texpt.scan, device=CPU, **kw)
    for integ, acc_cls in ((j, jkb.Accumulators), (p, tkb.Accumulators)):
        with pytest.raises(ValueError, match="exact-i32"):
            integ.integrate(_HotReader(2**27), range(0, nf), acc_cls.zeros(2))
    acc_j, acc_t = jkb.Accumulators.zeros(2), tkb.Accumulators.zeros(2)
    j.integrate(_HotReader(60000), range(0, nf), acc_j)
    p.integrate(_HotReader(60000), range(0, nf), acc_t)
    assert acc_t.fg_sum.sum() > 0
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(acc_t, name), getattr(acc_j, name), err_msg=name)


def test_weighted_index_dot_exact_at_bounds():
    """The port's int64 moment dot equals the JAX package's split-i32 dot
    over its whole domain (vals < 2**26, n <= 512)."""
    rng = np.random.default_rng(7)
    for n in (21, 128, 512):
        vals = rng.integers(0, 1 << 26, size=(17, n), dtype=np.int64)
        vals[0] = (1 << 26) - 1
        want = np.asarray(jkb._weighted_index_dot(jnp.asarray(vals, jnp.int32), n))
        got = tkb._weighted_index_dot(torch.from_numpy(vals.astype(np.int32)), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_integrator_needs_a_device_or_the_cpu_flag(monkeypatch, collection):
    """Without a CUDA device and without FFS_TORCH_DEVICE=cpu the port's
    integrator raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FFS_TORCH_DEVICE", raising=False)
    t = collection.texpt
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cpu"):
        tkb.KabschIntegrator(
            panel=t.panel, beam=t.beam, gonio=t.goniometer, scan=t.scan, s1=collection.s1,
            phi=collection.phi, bboxes=collection.bboxes, delta_b=0.01, delta_m=0.01,
        )
