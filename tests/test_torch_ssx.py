"""The port's SSX indexer (ffs_tpu_torch.indexing.ssx) against ffs_tpu's on
the CPU.  ffs_tpu's device path runs on JAX's CPU backend here; the port's
on a CPU torch device (the same code that runs on the card).

Tolerances, per test:

(a) scores against a float64 NumPy oracle: each score is a sum of S terms
    w*cos(phi) with phi = 2 pi len (rlp . dir).  In float32 the projection
    carries ~3 roundings and the scaled argument two more, so phi is off by
    at most ~8 eps32 |phi|; cos and the product add ~2 eps32 a term and the
    sum ~S eps32 a term.  Bound: S * (8 eps32 |phi|max + (2 + S) eps32).
(b) the 40-step refinement from the same v0: 1e-4 relative to the vector
    lengths, between the port and ffs_tpu's ``_get_refine_jit``.
(c) index_batch against ffs_tpu's device path: the same Miller indices and
    indexed counts, cells within 1e-4 and rmsds within 1e-3 relative.
(d) the adversarial envelope: the same success per case and seed.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ffs_tpu_torch.indexing import ssx as tssx
from ffs_tpu_torch.tools import ssx_adversarial as tadv

from .test_ssx import _still_experiment, _synthetic_still_spots

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import ssx_adversarial as jadv  # noqa: E402

CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _images():
    """test_ssx.py's still, then three adversarial-suite stills with ten
    noise spots each (the bench's configuration)."""
    crystal, panel, wavelength, s0, rng = _still_experiment()
    obs, _ = _synthetic_still_spots(crystal, panel, wavelength, s0, rng)
    images = [obs]
    for seed in (1, 2, 3):
        crystal, panel, wavelength, s0, rng = tadv.make_experiment(seed)
        spots = tadv.lattice_spots(crystal, panel, s0, rng)
        images.append(np.concatenate([spots, tadv.noise_spots(rng, 10)]))
    return images, panel, wavelength


def _rlps(images, panel, wavelength):
    from ffs_tpu_torch.indexing.rlp import ssx_xyz_to_rlp

    return [ssx_xyz_to_rlp(x, panel, wavelength) for x in images]


def _indexer(module, panel, wavelength, **kw):
    ix = module.SSXIndexer(min_spots=10, **kw)
    ix.panel, ix.cell, ix.wavelength = panel, tadv.CELL, wavelength
    return ix


def test_scores_match_float64_oracle():
    images, panel, wavelength = _images()
    rlps = _rlps(images[:2], panel, wavelength)
    rlp_pad, w, _ = tssx._pad_rlp_batch(rlps)
    dirs = tssx.fibonacci_half_sphere(4096)
    lengths = np.asarray(tadv.CELL[:3], dtype=np.float32)
    got = tssx.ssx_scores(torch.from_numpy(rlp_pad), torch.from_numpy(w),
                          torch.from_numpy(lengths),
                          torch.from_numpy(dirs.astype(np.float32))).numpy()
    assert got.shape == (2, 3, 4096) and got.dtype == np.float32
    for b, r in enumerate(rlps):
        proj = r @ dirs.T  # float64 oracle
        S = len(r)
        for li, length in enumerate(lengths.astype(np.float64)):
            phi = 2 * np.pi * length * proj
            want = np.cos(phi).sum(axis=0)
            tol = S * (8 * EPS32 * np.abs(phi).max() + (2 + S) * EPS32)
            assert np.abs(got[b, li] - want).max() <= tol


def test_topk_is_the_best_scores_in_order():
    images, panel, wavelength = _images()
    rlp_pad, w, _ = tssx._pad_rlp_batch(_rlps(images, panel, wavelength))
    args = (torch.from_numpy(rlp_pad), torch.from_numpy(w),
            torch.tensor(tadv.CELL[:3], dtype=torch.float32),
            tssx.device_dirs(8192, CPU))
    scores = tssx.ssx_scores(*args)
    idx = tssx.ssx_topk(*args, k=512)
    assert idx.shape == (4, 3, 512)
    picked = torch.gather(scores, 2, idx)
    assert (picked[..., :-1] >= picked[..., 1:]).all()
    assert (picked[..., -1:] >= scores.topk(513, dim=2).values[..., -1:]).all()


def test_picks_match_jax_topk():
    """The greedy picks made from the port's top-k equal those from
    ffs_tpu's device top-k (parity is decided on picks, not score bits)."""
    import jax.numpy as jnp

    from ffs_tpu.indexing import ssx as jssx

    images, panel, wavelength = _images()
    rlp_pad, w, _ = tssx._pad_rlp_batch(_rlps(images, panel, wavelength))
    lengths = np.asarray(tadv.CELL[:3], dtype=np.float32)
    n = 32768
    j_idx = np.asarray(jssx._get_topk_jit(chunk=2048)(
        jnp.asarray(rlp_pad), jnp.asarray(w), jnp.asarray(lengths),
        jssx._device_dirs(n), k=512))
    t_idx = tssx.ssx_topk(torch.from_numpy(rlp_pad), torch.from_numpy(w),
                          torch.from_numpy(lengths), tssx.device_dirs(n, CPU)).numpy()
    dirs = tssx.fibonacci_half_sphere(n)
    for b in range(len(images)):
        for li in range(3):
            assert (tssx._greedy_diverse_pick(dirs, t_idx[b, li], 32)
                    == jssx._greedy_diverse_pick(dirs, j_idx[b, li], 32))


def test_refine_matches_jax():
    import jax.numpy as jnp

    from ffs_tpu.indexing import ssx as jssx

    images, panel, wavelength = _images()
    rlp_pad, w, n_real = tssx._pad_rlp_batch(_rlps(images, panel, wavelength))
    rng = np.random.default_rng(11)
    lengths = np.asarray(tadv.CELL[:3], dtype=np.float32)
    dirs = tssx.fibonacci_half_sphere(32768)
    v0 = np.zeros((len(images), 3, 32, 3), dtype=np.float32)
    for li in range(3):
        v0[:, li, :28] = dirs[rng.integers(0, len(dirs), (len(images), 28))] * lengths[li]
    want = np.asarray(jssx._get_refine_jit()(jnp.asarray(rlp_pad), jnp.asarray(w),
                                             jnp.asarray(n_real), jnp.asarray(v0)))
    got = tssx.ssx_refine(torch.from_numpy(rlp_pad), torch.from_numpy(w),
                          torch.from_numpy(n_real), torch.from_numpy(v0)).numpy()
    assert (got[:, :, 28:] == 0).all()  # padded picks stay zero
    scale = np.linalg.norm(want, axis=-1, keepdims=True)[:, :, :28]
    assert (np.abs(got - want)[:, :, :28] / scale).max() <= 1e-4


def test_index_batch_matches_jax_device_path():
    from ffs_tpu.indexing import ssx as jssx

    images, panel, wavelength = _images()
    want = _indexer(jssx, panel, wavelength, use_device=True).index_batch(images)
    got = _indexer(tssx, panel, wavelength).index_batch(images)
    for (rj, nj), (rt, nt) in zip(want, got):
        assert (rj is None) == (rt is None)
        assert nt == nj
        if rj is None:
            continue
        np.testing.assert_array_equal(rt.miller_indices, rj.miller_indices)
        assert len(rt.delpsi) == len(rj.delpsi)
        np.testing.assert_allclose(rt.cell_parameters, rj.cell_parameters, rtol=1e-4)
        np.testing.assert_allclose(rt.rmsds, rj.rmsds, rtol=1e-3)
    assert sum(r is not None for r, _ in got) == len(images)


def test_index_is_index_batch_of_one():
    images, panel, wavelength = _images()
    ix = _indexer(tssx, panel, wavelength)
    batch = ix.index_batch(images)
    for img, (rb, nb) in zip(images, batch):
        ri, ni = ix.index(img)
        assert ni == nb
        np.testing.assert_array_equal(ri.miller_indices, rb.miller_indices)
        np.testing.assert_allclose(ri.cell_parameters, rb.cell_parameters, rtol=1e-6)


def test_host_search_is_the_float64_reference():
    """use_device=False runs the float64 NumPy search and agrees with the
    device search on the same stills."""
    images, panel, wavelength = _images()
    ix = _indexer(tssx, panel, wavelength, use_device=False)
    assert ix.device is None
    host = ix.index_batch(images)
    dev = _indexer(tssx, panel, wavelength).index_batch(images)
    for (rh, nh), (rd, nd) in zip(host, dev):
        assert nh == nd
        np.testing.assert_allclose(rd.cell_parameters, rh.cell_parameters, rtol=1e-4)


@pytest.mark.parametrize("case", jadv.CASES)
def test_adversarial_envelope_matches_jax(case):
    for seed in (5, 6):
        want = jadv.run_case(case, seed)
        got = tadv.run_case(case, seed)
        assert got.success == want.success, (case, seed, got, want)
        assert got.success  # the floors of tests/test_ssx_adversarial.py


@pytest.mark.parametrize("stage", ["ssx_topk", "ssx_refine"])
def test_device_failure_reaches_the_caller(stage, monkeypatch, capsys):
    """A failure in either device step raises out of index(); nothing is
    printed and no host search runs in its place."""
    images, panel, wavelength = _images()

    def broken(*a, **k):
        raise RuntimeError(f"{stage} failed on the device")

    host_calls = []
    monkeypatch.setattr(tssx, stage, broken)
    monkeypatch.setattr(tssx, "_host_topk", lambda *a: host_calls.append(a))
    monkeypatch.setattr(tssx, "_host_refine", lambda *a: host_calls.append(a))
    with pytest.raises(RuntimeError, match="failed on the device"):
        _indexer(tssx, panel, wavelength).index(images[0])
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""
    assert not host_calls


def test_device_choice(monkeypatch):
    assert _indexer(tssx, None, 1.0).device == CPU
    monkeypatch.delenv("FFS_TORCH_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cpu"):
            tssx.SSXIndexer()
    assert tssx.SSXIndexer(use_device=False).device is None
    assert tssx.SSXIndexer(device="cpu").device == CPU


def test_direction_table_cached_per_size_and_device():
    a = tssx.device_dirs(1024, CPU)
    assert tssx.device_dirs(1024, torch.device("cpu")) is a
    assert tssx.device_dirs(2048, CPU).shape == (2048, 3)
    np.testing.assert_array_equal(a.numpy(),
                                  tssx.fibonacci_half_sphere(1024).astype(np.float32))
