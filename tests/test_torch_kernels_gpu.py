"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  On a GPU machine run

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

which builds the kernels with nvcc on first use.
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.ops import dispersion_extended_packed as txp
from ffs_tpu_torch.ops import dispersion_packed as tp

pytestmark = pytest.mark.gpu

KERNELS = {
    "dispersion": (tp.dispersion_packed_raw, tp.dispersion_packed_plain, tp.mask_box_count),
    "dispersion_extended": (
        txp.dispersion_extended_packed_raw,
        txp.dispersion_extended_packed_plain,
        txp.mask_box_count_extended,
    ),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _frame(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    image = rng.poisson(6.0, size=(h, w)).astype(dtype)
    for y, x in zip(rng.integers(4, h - 4, 40), rng.integers(4, w - 4, 40)):
        image[y - 1 : y + 2, x - 2 : x + 2] += dtype(900)
    mask = np.ones((h, w), np.uint8)
    mask[h // 3 : h // 3 + 5] = 0
    mask[:, w // 2 : w // 2 + 3] = 0
    if dtype == np.uint32:
        image[5, 7] = image[h - 3, w - 9] = 0xFFFFFFFF
    if dtype == np.int32:  # CBF-like: -1 under the mask, one unmasked -2
        image[mask == 0] = -1
        image[h - 5, 3] = -2
    return image, mask


@pytest.mark.parametrize("shape", [(37, 70), (130, 333), (515, 1030)])
@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_kernel_matches_plain(cuda, algorithm, pixels, shape):
    raw, plain, mbox_fn = KERNELS[algorithm]
    image, mask = _frame(*shape, pixels, seed=shape[0])
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    want = plain(img, msk, 65535.0)
    assert torch.equal(want.cpu(), raw(img.cpu(), msk.cpu(), 65535.0))
    for mbox in (None, mbox_fn(msk)):
        before = raw.launches
        got = raw(img, msk, 65535.0, mbox=mbox)
        torch.cuda.synchronize()
        assert raw.launches == before + 1
        assert torch.equal(got, want)
    nwl = want.shape[-1] // 2
    assert int(want[:, nwl - 1].sum()) > 0


def test_batched_frames(cuda):
    image, mask = _frame(96, 200, np.uint16, seed=1)
    batch = torch.from_numpy(np.stack([image, np.roll(image, 5, axis=0)])).to(cuda)
    msk = torch.from_numpy(mask).to(cuda)
    for raw, plain, _ in KERNELS.values():
        assert torch.equal(raw(batch, msk, 65535.0), plain(batch, msk, 65535.0))


def test_kernel_rejects_bad_inputs(cuda):
    image, mask = _frame(40, 64, np.uint16, seed=2)
    img = torch.from_numpy(image).to(cuda)
    with pytest.raises(ValueError, match="mask is on"):
        tp.dispersion_packed_raw(img, torch.from_numpy(mask), 65535.0)
    with pytest.raises(TypeError):
        tp.dispersion_packed_raw(img.to(torch.float32), torch.from_numpy(mask).to(cuda), 65535.0)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(precision="f32"),
        dict(precision="f32", algorithm="dispersion_extended"),
        dict(precision="f32", compact_backend="host"),
        dict(precision="f32", cc_backend="device"),
        dict(precision="f64"),
        dict(precision="f64", cc_backend="host", algorithm="dispersion_extended"),
    ],
)
def test_processor_on_gpu_matches_cpu(cuda, cfg):
    """Every processor path on the card against the same path on the CPU
    (the CPU side runs the kernels' plain versions)."""
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    image, mask = _frame(300, 420, np.uint16, seed=3)
    gpu_cfg = SpotfindConfig(min_spot_size=1, **cfg)
    gpu = SpotfindProcessor(420, 300, mask, 65535.0, gpu_cfg, device=cuda)
    cpu_cfg = SpotfindConfig(min_spot_size=1, use_kernel=gpu.use_kernel, **cfg)
    cpu = SpotfindProcessor(420, 300, mask, 65535.0, cpu_cfg, device=torch.device("cpu"))
    assert gpu.use_kernel == (cfg["precision"] == "f32")
    for num, frame in enumerate([image, np.roll(image, 17, axis=1)]):
        a, b = gpu.process_frame(num, frame), cpu.process_frame(num, frame)
        assert (a.n_strong_pixels, a.n_spots, a.n_spots_prefilter, a.n_strong_pixels_filtered) == (
            b.n_strong_pixels, b.n_spots, b.n_spots_prefilter, b.n_strong_pixels_filtered
        )
        for name in ("linear_index", "intensity", "root"):
            np.testing.assert_array_equal(getattr(a.pixels, name), getattr(b.pixels, name))
        assert a.n_strong_pixels > 0
