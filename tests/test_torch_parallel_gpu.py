"""The multi-device cases of tests/test_torch_parallel.py under NCCL, one
rank a card, against the same cases over gloo on the CPU (which that file
holds to ffs_tpu.parallel).

Marked ``gpu``; needs two cards and skips with fewer (decided inside the
fixture); runs on min(cards, 4) ranks.  On a machine with two or more GPUs:

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.parallel.launch import RankError, run_ranks

from . import torch_parallel_ranks as ranks

pytestmark = pytest.mark.gpu

KEYS = ("counts", "halo", "shard", "packed", "planes", "sp", "ext", "sp_rounds", "ext_rounds",
        "rotation", "kabsch", "kabsch_local", "kabsch_local_short", "guards", "fills", "dryrun")


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from ffs_tpu_torch.utils import cuda_build

    cuda_build.build()  # once, before the ranks load the library
    return min(torch.cuda.device_count(), 4)


@pytest.fixture(scope="module")
def nccl(world):
    return run_ranks(ranks.rank_cases, world, backend="nccl", args=(world, "nccl"), timeout=600)


@pytest.fixture(scope="module")
def cpu(world):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_TORCH_DEVICE", "cpu")
        return run_ranks(ranks.rank_cases, world, backend="gloo", args=(world,), timeout=600)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def test_every_rank_runs_on_its_own_card(world, nccl):
    assert [r["device"] for r in nccl] == [f"cuda:{r}" for r in range(world)]


@pytest.mark.parametrize("key", KEYS)
def test_nccl_equals_the_cpu_run(nccl, cpu, key):
    for rank, (g, c) in enumerate(zip(nccl, cpu)):
        assert _same(g[key], c[key]), f"rank {rank}: {key}"


def test_every_kernel_of_the_path_launched(nccl):
    for r in nccl:
        assert min(r["launches"].values()) > 0, r["launches"]


def test_a_lone_failure_under_nccl_fails_the_call(world):
    with pytest.raises(RankError, match="rank 1 fails alone"):
        run_ranks(ranks.lone_failure, 2, backend="nccl", args=("raise",), timeout=120)
