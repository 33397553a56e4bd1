"""The port's dense 4-connected labelling
(``ffs_tpu_torch.ops.connected_components.label_components_2d``) against
ffs_tpu's, bit for bit (int32 root linear indices, BIG off the mask), and
its partition against ``scipy.ndimage.label`` and the port's sparse path.
Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from ffs_tpu.ops import connected_components as jcc
from ffs_tpu_torch.ops import connected_components as tcc

S4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


def spiral(n: int) -> np.ndarray:
    """One 4-connected path winding inward over an n x n square: labels that
    need ~2n rounds (chip_smoke.py draws the same path at Eiger scale)."""
    s = np.zeros((n, n), bool)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top <= bottom and left <= right:
        s[top, left : right + 1] = True
        s[top : bottom + 1, right] = True
        if bottom - top >= 2:
            s[bottom, left : right + 1] = True
        if bottom - top >= 4 and right - left >= 4:
            s[top + 2 : bottom + 1, left] = True
            s[top + 2, left : left + 3] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return s


def _partition(labels, mask):
    """Each component as the sorted tuple of its pixels, sorted."""
    comps: dict = {}
    for y, x in zip(*np.nonzero(mask)):
        comps.setdefault(labels[y, x], []).append((y, x))
    return sorted(tuple(v) for v in comps.values())


def _masks():
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        out.append((f"seed{seed}", rng.random((64, 96)) < 0.2))
    out.append(("spiral", spiral(40)))
    blank = np.zeros((5, 7), bool)
    out.append(("blank", blank))
    return out


@pytest.mark.parametrize("name,strong", _masks(), ids=[m[0] for m in _masks()])
def test_label_components_2d_matches_jax(name, strong):
    got = tcc.label_components_2d(torch.from_numpy(strong))
    want = np.asarray(jcc.label_components_2d(jnp.asarray(strong)))
    assert got.dtype == torch.int32 and tuple(got.shape) == strong.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~strong] == tcc.BIG).all()
    ref, n = ndimage.label(strong, structure=S4)
    assert _partition(got.numpy(), strong) == _partition(ref, strong)
    if name == "spiral":
        assert n == 1 and tcc.label_components_2d.rounds > 5


def test_neighbor_min_matches_jax():
    rng = np.random.default_rng(4)
    lbl = rng.integers(0, 1000, size=(9, 13)).astype(np.int32)
    np.testing.assert_array_equal(tcc._neighbor_min(torch.from_numpy(lbl)).numpy(),
                                  np.asarray(jcc._neighbor_min(jnp.asarray(lbl))))


def test_dense_partition_equals_sparse_path():
    """The dense labels and the sparse path's roots (compaction then
    ``label_compact_pixels``) give each strong pixel the same root."""
    strong = spiral(48) | (np.random.default_rng(5).random((48, 48)) < 0.15)
    image = np.ones(strong.shape, np.uint16)
    dense = tcc.label_components_2d(torch.from_numpy(strong)).numpy()
    pixels = tcc.compact_strong_pixels(torch.from_numpy(strong), torch.from_numpy(image),
                                       max_pixels=4096)
    root = tcc.label_compact_pixels(pixels, width=strong.shape[1])
    n = int(pixels.count)
    lin = pixels.linear_index[:n].to(torch.int64)
    np.testing.assert_array_equal(dense.reshape(-1)[lin.numpy()],
                                  pixels.linear_index[root[:n].to(torch.int64)].numpy())
