"""ffs_tpu_torch.prediction.rotation against ffs_tpu's.

The per-image float64 search (``use_device=False`` on both sides): the same
hkl set in the same order, with s1 and the calculated positions within
1e-12 relative.  The blocked two-pass search (the default on both sides):
the same rows in the same order (block, hkl chunk, image, hkl), hkl,
entering, panel and flags equal, s1 within 1e-12 and xyzcal within 1e-9
absolute, the JAX package's own device-against-host tolerances
(tests/test_prediction.py::test_device_block_prediction_matches_host);
across blocks, chunks, scan-varying models and forced capacity overflows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ffs_tpu.models.crystal import Crystal
from ffs_tpu.models.experiment import Experiment
from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel
from ffs_tpu.prediction import rotation as jrot
from ffs_tpu_torch.models.experiment import experiment_from_state
from ffs_tpu_torch.prediction import rotation as trot

CPU = torch.device("cpu")


def _experiments(n_images=12, **crystal_kw):
    expt = Experiment(
        beam=MonochromaticBeam(wavelength=1.0),
        panel=simple_panel(120.0, (120.0, 130.0), (0.3, 0.3), (240, 260)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, n_images), oscillation=(0.0, 1.0)),
        crystal=Crystal([40.0, 0, 0], [0, 50.0, 0], [0, 0, 60.0], **crystal_kw),
    )
    parts = ("beam", "panel", "goniometer", "scan", "crystal")
    texpt = experiment_from_state({k: dataclasses.asdict(getattr(expt, k)) for k in parts})
    return expt, texpt


def _assert_same(got, want):
    assert len(want.hkl) > 10
    np.testing.assert_array_equal(got.hkl, want.hkl)
    for name in ("panel", "entering", "flags"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("s1", "xyzcal_px", "xyzcal_mm"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-12,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("dmin", [4.0, None])
def test_predict_rotation_matches_jax(dmin):
    expt, texpt = _experiments()
    want = jrot.predict_rotation(expt, dmin=dmin, use_device=False)
    # a small hkl chunk: the chunked search must give the same rows in order
    got = trot.predict_rotation(texpt, dmin=dmin, use_device=False, device=CPU, chunk=1000)
    _assert_same(got, want)


def _scan_points(expt, n):
    """An expt JSON's scan points for ``n`` images: A and s0 perturbed at
    each point."""
    rng = np.random.default_rng(11)
    a = expt.crystal.a_matrix
    a_sp = np.stack([a @ (np.eye(3) + 1e-3 * rng.normal(size=(3, 3))) for _ in range(n + 1)])
    s0_sp = np.stack([expt.beam.s0 + 1e-4 * rng.normal(size=3) for _ in range(n + 1)])
    return {
        "crystal": [{"A_at_scan_points": a_sp.reshape(n + 1, 9).tolist()}],
        "beam": [{"s0_at_scan_points": s0_sp.tolist()}],
    }


def test_scan_varying_prediction_matches_jax():
    """Per-image setting matrices and beams from the expt JSON's scan
    points, and a space group with systematic absences."""
    expt, texpt = _experiments(space_group=" P 2ac 2ab")
    n = 12
    elist = _scan_points(expt, n)
    sv_j = jrot.parse_scan_varying(elist, n)
    sv_t = trot.parse_scan_varying(elist, n)
    assert sv_t and np.array_equal(sv_t.a_at_scan_points, sv_j.a_at_scan_points)
    want = jrot.predict_rotation(expt, sv_j, dmin=4.0, use_device=False)
    got = trot.predict_rotation(texpt, sv_t, dmin=4.0, use_device=False, device=CPU)
    _assert_same(got, want)


# the JAX package's device-against-host tolerances (absolute)
BLOCKED_ATOL = {"s1": 1e-12, "xyzcal_px": 1e-9, "xyzcal_mm": 1e-9}


def _assert_same_rows(got, want):
    """The same rows in the same order: hkl, panel, entering and flags
    equal, floats within BLOCKED_ATOL."""
    assert len(want.hkl) > 10
    for name in ("hkl", "panel", "entering", "flags"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, atol in BLOCKED_ATOL.items():
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("scan_varying", [False, True])
def test_blocked_prediction_matches_jax_default(scan_varying):
    """40 images: two blocks of the default 32 (the second partial), 18
    hkl chunks of 1000 rows; static, or scan-varying in P 2ac 2ab."""
    n = 40
    if scan_varying:
        expt, texpt = _experiments(n_images=n, space_group=" P 2ac 2ab")
        elist = _scan_points(expt, n)
        sv_j, sv_t = jrot.parse_scan_varying(elist, n), trot.parse_scan_varying(elist, n)
    else:
        expt, texpt = _experiments(n_images=n)
        sv_j = sv_t = None
    want = jrot.predict_rotation(expt, sv_j, dmin=4.0, chunk=1000)
    got = trot.predict_rotation(texpt, sv_t, dmin=4.0, chunk=1000, device=CPU)
    _assert_same_rows(got, want)
    # the blocked search finds the per-image search's rays, in its own order
    per_image = trot.predict_rotation(texpt, sv_t, dmin=4.0, use_device=False, device=CPU)
    assert sorted(map(tuple, got.hkl)) == sorted(map(tuple, per_image.hkl))


def _device_args(expt, texpt, dmin):
    """The arguments of both packages' ``_predict_rotation_device`` after
    the experiment: (sv, hkl, dmin, d_osc, osc0, z0, n_images), the port's
    grid equal to the JAX package's."""
    from ffs_tpu.models.symmetry import group_ops_from_symbol as jops

    _, hkl = trot._scan_grid(texpt, dmin)
    np.testing.assert_array_equal(
        hkl, jrot.hkl_grid(expt.crystal.a_matrix, dmin, jops(expt.crystal.space_group)))
    osc0, d_osc = expt.scan.oscillation
    z0 = expt.scan.image_range[0] - 1
    n = expt.scan.image_range[1] - z0
    return hkl, dmin, d_osc, osc0, z0, n


@pytest.mark.parametrize("dmin,kw,overflow", [
    # both capacities overflow (cap 64 = chunk_cap), over two blocks
    (4.0, dict(cap_per_image=2, hkl_chunk=1000), "both"),
    # one chunk of the whole grid and one block: chunk_cap (4096) alone
    (3.0, dict(img_block=40, cap_per_image=256, hkl_chunk=1 << 17), "chunk"),
])
def test_forced_overflow_matches_the_unforced_run(monkeypatch, dmin, kw, overflow):
    expt, texpt = _experiments(n_images=40)
    hkl, *args = _device_args(expt, texpt, dmin)
    calls = []
    block = trot._prediction_block

    def spy(packed, tables, cap, chunk_cap, *rest):
        out = block(packed, tables, cap, chunk_cap, *rest)
        calls.append((cap, chunk_cap, *out[-1, :2].tolist()))
        return out

    monkeypatch.setattr(trot, "_prediction_block", spy)
    got = trot._predict_rotation_device(texpt, trot.ScanVaryingData(), hkl, *args, **kw,
                                        device=CPU)
    if overflow == "both":
        assert any(n > cap and most > ccap for cap, ccap, n, most in calls), calls
    else:
        assert any(n <= cap and most > ccap for cap, ccap, n, most in calls), calls
    unforced = dict(kw, cap_per_image=4096)
    want = trot._predict_rotation_device(texpt, trot.ScanVaryingData(), hkl, *args, **unforced,
                                         device=CPU)
    for name in ("hkl", "s1", "xyzcal_px", "xyzcal_mm", "panel", "entering", "flags"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    jax_forced = jrot._predict_rotation_device(expt, jrot.ScanVaryingData(), hkl, *args, **kw)
    _assert_same_rows(got, jax_forced)


def test_compaction_is_ascending_with_invalid_slots_at_total():
    mask = torch.tensor([0, 1, 1, 0, 0, 1, 0, 1], dtype=torch.bool)
    idx, valid = trot._compact_i32(mask, 6)
    assert idx.dtype == torch.int32
    assert idx.tolist() == [1, 2, 5, 7, 8, 8]
    assert valid.tolist() == [True] * 4 + [False] * 2
    idx, valid = trot._compact_i32(mask, 2)
    assert idx.tolist() == [1, 2] and valid.all()


def test_reeke_limits_parity_through_the_blocked_search():
    """The port's copy of the Reeke loop-limit generator equals the JAX
    package's, and the blocked search keeps the same reflections of an
    image from the hkl grid as from the Reeke candidates: nothing outside
    the grid diffracts (tests/test_prediction.py::test_reeke_limits_parity,
    through the port's pass 1 and pass 2)."""
    from ffs_tpu.prediction.reeke import reeke_indices as jreeke
    from ffs_tpu_torch.prediction.reeke import reeke_indices

    expt = Experiment(
        beam=MonochromaticBeam(wavelength=1.2),
        panel=simple_panel(100.0, (250.0, 260.0), (0.2, 0.2), (500, 520)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, 20), oscillation=(0.0, 0.5)),
        crystal=Crystal([30.0, 0, 0], [0, 40.0, 0], [0, 0, 50.0]),
    )
    parts = ("beam", "panel", "goniometer", "scan", "crystal")
    texpt = experiment_from_state({k: dataclasses.asdict(getattr(expt, k)) for k in parts})
    dmin = 4.0
    osc0, d_osc = expt.scan.oscillation
    sv = trot.ScanVaryingData()
    a1, a2, _, _, _ = trot._image_states(texpt, sv, 20, osc0, d_osc)
    packed, _ = trot._packed_states(texpt, sv, 20, osc0, d_osc, 1)
    s0 = texpt.beam.s0
    grid = trot.hkl_grid(texpt.crystal.a_matrix, dmin)

    def surviving(hkl, i):
        tables, _ = trot._hkl_tables(hkl, 1 << 17, CPU)
        n = len(hkl)  # capacities no image can overflow
        out = trot._prediction_block(torch.from_numpy(packed[i : i + 1]), tables, n, n, dmin,
                                     d_osc).numpy()
        rows = out[:-1][out[:-1, 7] > 0]
        return {tuple(v) for v in hkl[rows[:, 5].astype(np.int64)]}

    n_checked = 0
    for i in (0, 7, 19):
        reeke = reeke_indices(a1[i], a2[i], s0, s0, dmin)
        np.testing.assert_array_equal(reeke, jreeke(a1[i], a2[i], s0, s0, dmin))
        assert 0 < len(reeke) < len(grid) / 5
        got_grid = surviving(grid, i)
        assert got_grid == surviving(reeke, i)
        n_checked += len(got_grid)
    assert n_checked > 20  # the comparison was not vacuous


@pytest.mark.parametrize("seed", [1, 7])
def test_fuzz_predict_seed_agrees(seed, monkeypatch):
    """The port's fuzz (blocked against per-image search) on two of the
    JAX tool's seeds, with the JAX tool's counts."""
    import pathlib

    from ffs_tpu_torch.tools import fuzz_predict

    r = fuzz_predict.run_seed(seed, CPU)
    assert "fail" not in r, r
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import fuzz_predict as jfuzz

    assert r["n_host"] == jfuzz.run_seed(seed)["n_host"] > 0


def test_hkl_grid_matches_jax():
    expt, _ = _experiments()
    from ffs_tpu.models.symmetry import group_ops_from_symbol as jops
    from ffs_tpu_torch.models.symmetry import group_ops_from_symbol as tops

    a = expt.crystal.a_matrix
    for symbol in ("P 1", " P 2ac 2ab", " C 2c 2"):
        np.testing.assert_array_equal(
            trot.hkl_grid(a, 3.0, tops(symbol)), jrot.hkl_grid(a, 3.0, jops(symbol))
        )
def test_sqrt_rn_rounds_as_numpy():
    """The corrected square root equals NumPy's (IEEE) on random values
    and on the neighbours of exact squares, where PyTorch's CPU sqrt can
    be an ulp off."""
    from ffs_tpu_torch.utils.exact import sqrt_rn

    rng = np.random.default_rng(5)
    y = rng.uniform(1.0, 2.0, 100_000)
    x = np.concatenate([rng.uniform(0.0, 1e-3, 100_000), y * y, np.nextafter(y * y, 0.0),
                        np.nextafter(y * y, 4.0), [0.0, 1e-300, 4.0]])
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def test_fma_sum3_rounds_as_xla():
    """fma_sum3 over the rows of a batched 3x3 product equals the JAX
    package's compiled ``einsum`` bit for bit on the CPU."""
    import jax
    import jax.numpy as jnp

    from ffs_tpu_torch.utils.exact import fma_sum3

    rng = np.random.default_rng(6)
    h = rng.integers(-40, 41, (20_000, 3)).astype(np.float64)
    a = rng.normal(size=(20_000, 3, 3)) * 0.02
    want = np.asarray(jax.jit(lambda h, a: jnp.einsum("ck,cjk->cj", h, a))(h, a))
    got = fma_sum3(torch.from_numpy(h)[:, None, :], torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
