"""The lane-packed, plane-last and probe window gathers of ffs_tpu_torch
against ffs_tpu (Pallas in interpret mode on the CPU), bit for bit; their
contract checks; and the gather-measurement tool at a small size.

JAX's probe kernel has no interpret mode, so the port's probe is held, as
the JAX tool holds its own, to JAX's plane-first gather (double form), and
to the defined result of its single-block form, written out here in NumPy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import window_gather as jwg
from ffs_tpu_torch.ops import window_gather as twg


def _offsets(rng, a, hp, wp, bh):
    y0 = rng.integers(0, hp - bh + 1, a)
    x0 = rng.integers(0, wp - 128, a)
    # the contract's edges: the last legal column start, the bottom-most row,
    # the origin, and an aligned start
    x0[:4] = [wp - 129, 0, wp - 129, 128]
    y0[:4] = [hp - bh, 0, 0, hp - bh]
    return y0, x0


def _image(rng, dtype, shape):
    img = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    return img if dtype == np.int32 else img.view(np.float32)  # every bit pattern, NaNs too


def _jax_pf(img, y0, x0, bh):
    return np.asarray(jwg.window_gather_planes(
        jnp.asarray(img), jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32), bh=bh,
        interpret=True))


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_packed_matches_jax(dtype):
    rng = np.random.default_rng(11)
    p, hp, wp, bh = 4, 48, 384, 16
    img = _image(rng, dtype, (p, hp, wp))
    y0, x0 = _offsets(rng, 12, hp, wp, bh)  # a multiple of 4, not of the TPU's 8
    want = np.asarray(jwg.window_gather_planes_packed(
        jnp.asarray(img), jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32), bh=bh,
        interpret=True))
    got = twg.window_gather_planes_packed(torch.from_numpy(img), y0, x0, bh=bh).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (3, p, bh, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # lanes 32g..32g+31 of row i: columns 0..31 of window 4i+g
    pf = _jax_pf(img, y0, x0, bh)
    np.testing.assert_array_equal(_bits(got[1, 2, :, 64:96]), _bits(pf[6, 2, :, :32]))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plane_last_matches_jax(dtype):
    rng = np.random.default_rng(12)
    p, hp, wp, bh = 3, 40, 384, 16
    img = _image(rng, dtype, (p, hp, wp))
    pl = np.ascontiguousarray(img.reshape(p, hp, wp // 128, 128).transpose(1, 2, 0, 3))
    y0, x0 = _offsets(rng, 11, hp, wp, bh)
    want = np.asarray(jwg.window_gather_planes_pl(
        jnp.asarray(pl), jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32), bh=bh,
        interpret=True))
    got = twg.window_gather_planes_pl(torch.from_numpy(pl), y0, x0, bh=bh).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (11, p, bh, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(_jax_pf(img, y0, x0, bh)))


@pytest.mark.parametrize("r,slots", [(8, 2), (4, 8), (16, 4), (3, 2)])
def test_probe_double_matches_jax_plane_first(r, slots):
    rng = np.random.default_rng(13)
    p, hp, wp, bh = 4, 40, 512, 24
    img = _image(rng, np.int32, (p, hp, wp))
    y0, x0 = _offsets(rng, 21, hp, wp, bh)
    got = twg.window_gather_probe(torch.from_numpy(img), y0, x0, bh=bh, r=r, slots=slots)
    np.testing.assert_array_equal(got.numpy(), _jax_pf(img, y0, x0, bh))


def test_probe_single_is_the_rotated_block():
    rng = np.random.default_rng(14)
    p, hp, wp, bh = 2, 32, 384, 8
    img = _image(rng, np.int32, (p, hp, wp))
    y0, x0 = _offsets(rng, 9, hp, wp, bh)
    got = twg.window_gather_probe(torch.from_numpy(img), y0, x0, bh=bh, single_only=True).numpy()
    want = np.empty((9, p, bh, 128), np.int32)
    for a in range(9):
        xblk = min(x0[a] >> 7, wp // 128 - 2)
        shift = x0[a] - 128 * xblk
        cols = 128 * xblk + (np.arange(128) + shift) % 128
        want[a] = img[:, y0[a] : y0[a] + bh][:, :, cols]
    np.testing.assert_array_equal(got, want)
    # an aligned start reads the window itself
    np.testing.assert_array_equal(got[3], _jax_pf(img, y0, x0, bh)[3])


def test_variants_check_the_contract():
    img = torch.zeros((2, 32, 256), dtype=torch.int32)
    pl = torch.zeros((32, 2, 2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        twg.window_gather_planes_packed(img, np.zeros(6, int), np.zeros(6, int), bh=8)
    for fn, src in ((twg.window_gather_planes_packed, img), (twg.window_gather_planes_pl, pl),
                    (twg.window_gather_probe, img)):
        with pytest.raises(ValueError, match="x0"):
            fn(src, np.zeros(4, int), np.full(4, 128), bh=8)  # x0 == Wp-128
        with pytest.raises(ValueError, match="y0"):
            fn(src, np.full(4, 25), np.zeros(4, int), bh=8)
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(src, np.zeros(4, int), np.zeros(4, int), bh=12)
        with pytest.raises(TypeError):
            fn(src.to(torch.int16), np.zeros(4, int), np.zeros(4, int), bh=8)
    with pytest.raises(ValueError, match="plane-last"):
        twg.window_gather_planes_pl(img, [0], [0], bh=8)
    with pytest.raises(ValueError, match=">= 256"):
        twg.window_gather_planes_pl(pl[:, :1], [0], [0], bh=8)
    with pytest.raises(ValueError, match="slots"):
        twg.window_gather_probe(img, [0], [0], bh=8, slots=1)
    with pytest.raises(ValueError, match="r=0"):
        twg.window_gather_probe(img, [0], [0], bh=8, r=0)


def test_variants_pick_by_device():
    img = torch.zeros((2, 16, 256), dtype=torch.int32)
    pl = torch.zeros((16, 2, 2, 128), dtype=torch.int32)
    cases = ((twg.window_gather_planes_packed, img), (twg.window_gather_planes_pl, pl),
             (twg.window_gather_probe, img))
    for fn, src in cases:
        before = fn.launches
        fn(src, np.zeros(4, int), np.zeros(4, int), bh=8)
        assert fn.launches == before  # the CPU takes the plain version
        with pytest.raises(ValueError, match="no kernel"):
            fn(src.to("meta"), np.zeros(4, int), np.zeros(4, int), bh=8)


def test_measure_window_gather_at_a_small_size(monkeypatch, capsys):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    from ffs_tpu_torch.tools import measure_window_gather as mwg

    dev = torch.device("cpu")
    frames, y0, x0 = mwg.make_inputs(dev, a=24, f=3, bh=16, h=60, w=300, seed=7)
    assert frames.shape == (3, 80, 512) and frames.dtype == torch.int32
    ref = mwg.check(frames, y0, x0, 16)
    np.testing.assert_array_equal(ref.numpy(), _jax_pf(frames.numpy(), y0, x0, 16))
    rows = mwg.run_rows(frames, y0, x0, 16, reps=1)
    out = capsys.readouterr().out
    assert "probe(double) == pf" in out and "host CPU" in out
    assert {"pf", "pl+transpose", "pl_pre", "probe_single", "probe_s16_r4", "pf_packed"} <= set(rows)
