"""The indexers' device steps on the card: the SSX search (float32, TF32
off) against the same search on the CPU device, and ``fft3d``'s complex128
transform against NumPy's at 1e-12 of the peak.

Marked ``gpu``: skips where ``torch.cuda.is_available()`` is False
(decided inside the fixture).  On a GPU machine run

    python -m pytest tests/test_torch_indexing_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def test_ssx_search_on_the_card_matches_the_cpu(cuda):
    """The SSX score, top-k and refinement on the card (float32, TF32 off)
    index the adversarial stills as the CPU device does."""
    from ffs_tpu_torch.indexing import ssx
    from ffs_tpu_torch.tools import ssx_adversarial as adv
    from ffs_tpu_torch.utils import torchinit

    torchinit.setup()
    images = []
    for seed in range(1, 9):
        crystal, panel, wavelength, s0, rng = adv.make_experiment(seed)
        images.append(np.concatenate([adv.lattice_spots(crystal, panel, s0, rng),
                                      adv.noise_spots(rng, 10)]))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ix = ssx.SSXIndexer(device=dev)
        ix.panel, ix.cell, ix.wavelength = panel, adv.CELL, wavelength
        out[dev.type] = ix.index_batch(images)
    for (rg, ng), (rc, nc) in zip(out["cuda"], out["cpu"]):
        assert ng == nc
        np.testing.assert_array_equal(rg.miller_indices, rc.miller_indices)
        np.testing.assert_allclose(rg.cell_parameters, rc.cell_parameters, rtol=1e-4)


def test_fft3d_on_the_card_matches_numpy(cuda):
    from ffs_tpu_torch.indexing import fft3d

    rlp = np.random.default_rng(2).normal(0.0, 0.15, size=(3000, 3))
    got, _ = fft3d.fft3d(rlp, 2.0, fft3d.b_iso_from_d_min(2.0), 64, device=cuda)
    want, _ = fft3d.fft3d(rlp, 2.0, fft3d.b_iso_from_d_min(2.0), 64, use_device=False)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * want.max())
