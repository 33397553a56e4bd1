"""Each CUDA kernel entry launches on its tensors' card, not the current
device (every ctypes launch runs under ``torch.cuda.device(tensor.device)``).

Marked ``gpu``; needs two cards and skips with fewer (decided inside the
fixture).  On a machine with two or more GPUs run

    python -m pytest tests/test_torch_kernels_gpu_devices.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.ops import dispersion_extended_packed as txp
from ffs_tpu_torch.ops import dispersion_packed as tp

from .test_torch_kernels_gpu import KERNELS, _frame

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda1():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 1)


def test_every_entry_launches_on_the_tensors_card(cuda1):
    """With the current device cuda:0 and every tensor on cuda:1, each
    kernel entry launches on cuda:1 and equals its plain version there."""
    from ffs_tpu_torch.ops import bitshuffle_device as bd
    from ffs_tpu_torch.ops import window_gather as wg

    assert torch.cuda.current_device() == 0
    image, mask = _frame(130, 333, np.uint16, seed=3)
    img, msk = torch.from_numpy(image).to(cuda1), torch.from_numpy(mask).to(cuda1)
    for raw, plain, _ in KERNELS.values():
        assert torch.equal(raw(img, msk, 65535.0), plain(img, msk, 65535.0))
    assert torch.equal(tp.dispersion_fused(img, msk, 65535.0)[1],
                       tp.dispersion_fused_plain(img, msk, 65535.0)[1])
    assert torch.equal(txp.dispersion_extended_fused(img, msk, 65535.0)[1],
                       txp.dispersion_extended_fused_plain(img, msk, 65535.0)[1])

    rng = np.random.default_rng(1)
    planes, hp, wp, bh, a = 4, 70, 512, 24, 100
    stack = torch.from_numpy(rng.integers(0, 2**31 - 1, (planes, hp, wp), dtype=np.int64)
                             .astype(np.int32)).to(cuda1)
    pl = stack.reshape(planes, hp, wp // 128, 128).permute(1, 2, 0, 3).contiguous()
    y0, x0 = rng.integers(0, hp - bh + 1, a), rng.integers(0, wp - 128, a)
    for fn, plain, src in (
        (wg.window_gather_planes, wg.window_gather_planes_plain, stack),
        (wg.window_gather, wg.window_gather_plain, stack[0]),
        (wg.window_gather_planes_packed, wg.window_gather_planes_packed_plain, stack),
        (wg.window_gather_planes_pl, wg.window_gather_planes_pl_plain, pl),
        (wg.window_gather_probe, wg.window_gather_probe_plain, stack),
    ):
        got = fn(src, y0, x0, bh=bh)
        assert got.device == cuda1 and torch.equal(got, plain(src, y0, x0, bh=bh)), fn.__name__

    raw_planes = torch.from_numpy(rng.integers(0, 256, (2, 13, 4096 * 2), dtype=np.uint8)).to(cuda1)
    got = bd.frames_from_planes(raw_planes, 48, 1030, torch.uint16)
    assert torch.equal(got, bd.frames_from_planes_plain(raw_planes, 48, 1030, torch.uint16))
    torch.cuda.synchronize(cuda1)
