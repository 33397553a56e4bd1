"""The port's fuzzers on the card: the spotfinder's kernel path (the CUDA
threshold walkers and the decode kernel) against its dense path, and the
blocked Kabsch step (the CUDA window gathers) against the float64 oracle.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture).  On a GPU machine:

    python -m pytest tests/test_torch_fuzz_gpu.py -m gpu --noconftest -q
"""

import pytest
import torch

from ffs_tpu_torch.ops import kernel_wrappers
from ffs_tpu_torch.tools import fuzz_integrator, fuzz_spotfind

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _launched(fn):
    """fn()'s result and the launches of kernel rows 1-5 it made."""
    wrappers = kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches - before[name] for name, w in wrappers.items()}


def _walker(pool, seed):
    algorithm = pool[seed % len(pool)][3]
    return "dispersion_packed" if algorithm == "dispersion" else "dispersion_extended_packed"


@pytest.mark.parametrize("seed", [0, 3, 4, 8])
def test_fuzz_spotfind_seed(cuda, seed):
    ok, launched = _launched(lambda: fuzz_spotfind.run_seed(seed, cuda))
    assert ok
    assert launched[_walker(fuzz_spotfind.CONFIGS, seed)] > 0
    assert launched["bitshuffle_frames"] > 0


@pytest.mark.parametrize("seed", [319, 346])
def test_fuzz_spotfind_batch_centroids_seed(cuda, seed):
    """The seeds whose batch and per-frame centroids differed by an ulp of
    x (float32 atomic sums in another order): the card's spot-table sums
    are now order-free, so three runs each agree."""
    for _ in range(3):
        assert fuzz_spotfind.run_seed(seed, cuda)


@pytest.mark.parametrize("seed", [0, 3])  # dispersion, dispersion_extended
def test_fuzz_spotfind_edge_seed(cuda, seed):
    ok, launched = _launched(lambda: fuzz_spotfind.run_seed(seed, cuda, edges=True))
    assert ok
    assert launched[_walker(fuzz_spotfind.EDGE_CONFIGS, seed)] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_integrator_seed(cuda, seed):
    ok, launched = _launched(lambda: fuzz_integrator.run_seed(seed, cuda, verbose=True))
    assert ok
    assert launched["window_gather_planes"] > 0 and launched["window_gather"] > 0
