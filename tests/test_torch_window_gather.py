"""ffs_tpu_torch.ops.window_gather against ffs_tpu's Pallas gathers (run in
interpret mode on the CPU), bit for bit, and the port's contract checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import window_gather as jwg
from ffs_tpu_torch.ops import window_gather as twg


def _offsets(rng, a, hp, wp, bh):
    y0 = rng.integers(0, hp - bh + 1, a)
    x0 = rng.integers(0, wp - 128, a)
    # the edges of the contract: the last legal column start (Wp-129), the
    # bottom-most row start, the origin
    x0[:3] = [wp - 129, 0, wp - 129]
    y0[:3] = [hp - bh, 0, 0]
    return y0, x0


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_window_gather_planes_matches_jax(dtype):
    rng = np.random.default_rng(5)
    p, hp, wp, bh = 3, 40, 384, 16
    img = (rng.integers(-(2**31), 2**31 - 1, (p, hp, wp))).astype(np.int32)
    if dtype == np.float32:
        img = rng.normal(size=(p, hp, wp)).astype(np.float32)
        img[0, 0, :7] = [np.inf, -np.inf, np.nan, -0.0, 1e-45, 3.4e38, -1e-40]
    y0, x0 = _offsets(rng, 21, hp, wp, bh)
    want = np.asarray(
        jwg.window_gather_planes(
            jnp.asarray(img), jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32),
            bh=bh, interpret=True,
        )
    )
    got = twg.window_gather_planes(torch.from_numpy(img), y0, x0, bh=bh).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (21, p, bh, 128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_window_gather_matches_jax(dtype):
    rng = np.random.default_rng(6)
    hp, wp, bh = 48, 256, 24
    img = rng.integers(0, 2, (hp, wp)).astype(dtype)
    img[::3] = rng.normal(size=(hp // 3, wp)).astype(dtype) * 1000
    y0, x0 = _offsets(rng, 13, hp, wp, bh)
    want = np.asarray(
        jwg.window_gather(
            jnp.asarray(img), jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32),
            bh=bh, interpret=True,
        )
    )
    got = twg.window_gather(torch.from_numpy(img), y0, x0, bh=bh).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (13, bh, 128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize(
    "shape,y0,x0,bh,err",
    [
        ((2, 32, 256), [0], [128], 8, "x0"),  # x0 == Wp-128 breaks the strict bound
        ((2, 32, 256), [0], [-1], 8, "x0"),
        ((2, 32, 256), [25], [0], 8, "y0"),  # y0 + bh > Hp
        ((2, 32, 200), [0], [0], 8, "multiple of 128"),
        ((2, 32, 128), [0], [0], 8, ">= 256"),
        ((2, 32, 256), [0], [0], 12, "multiple of 8"),
    ],
)
def test_contract_is_checked(shape, y0, x0, bh, err):
    img = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=err):
        twg.window_gather_planes(img, np.array(y0), np.array(x0), bh=bh)
    with pytest.raises(ValueError, match=err):
        twg.window_gather(img[0], np.array(y0), np.array(x0), bh=bh)


def test_rejects_narrow_types_and_other_devices():
    with pytest.raises(TypeError):
        twg.window_gather(torch.zeros((8, 256), dtype=torch.uint16), [0], [0], bh=8)
    with pytest.raises(TypeError):
        twg.window_gather(torch.zeros((8, 256), dtype=torch.float64), [0], [0], bh=8)
    img = torch.zeros((8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        twg.window_gather(img, [0], [0], bh=8)
    before = twg.window_gather.launches
    twg.window_gather(torch.zeros((8, 256), dtype=torch.int32), [0], [0], bh=8)
    assert twg.window_gather.launches == before  # the CPU takes the plain version
