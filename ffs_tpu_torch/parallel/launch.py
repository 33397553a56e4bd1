"""Start one process per rank, run a function in each, and collect the
results.

The JAX package drives a mesh from one process; ``torch.distributed`` wants
a process per device.  :func:`run_ranks` spawns ``world`` fresh
interpreters, rendezvous through a ``FileStore`` in a temporary directory
(no TCP port to race for), initialises the process group (NCCL with one
rank a card: ``torch.cuda.set_device(rank)`` and ``device_id`` first; or
gloo) with a timeout, calls ``fn(*args)`` in every rank and returns the
results in rank order.

A rank that raises fails the whole call with that rank's traceback; the
other ranks are terminated, so the call never hangs in a collective the
failed rank will not join and never returns a partial result.  Each worker
blocks ``jax``, ``ffs_tpu`` and ``bench`` in ``sys.modules`` before it
unpickles ``fn``: the port runs without them, and so must every function
handed to it (one defined in a module that imports JAX fails its ranks).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

BLOCKED = ("jax", "ffs_tpu", "bench")


class RankError(RuntimeError):
    """A rank raised, or died without a result."""


def _tensor_from(a):
    import torch

    return torch.from_numpy(a)


class _Unsigned:
    """A uint16 or uint32 tensor in a pickle, as its numpy array: PyTorch
    cannot unpickle a tensor of those dtypes."""

    def __init__(self, t):
        self.array = t.numpy()

    def __reduce__(self):
        return _tensor_from, (self.array,)


def _host(obj):
    """``obj`` with every tensor copied to the CPU (tuples, named tuples,
    lists and dicts walked), so the parent can unpickle it without a card;
    the copy owns its storage (pickle cannot restore a tensor viewed from a
    storage of another dtype, as the collectives' byte buffers are)."""
    import torch

    if isinstance(obj, torch.Tensor):
        t = obj.detach().to("cpu", copy=True)
        return _Unsigned(t) if t.dtype in (torch.uint16, torch.uint32) else t
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, backend: str, store_path: str, timeout: float,
               payload: bytes, results) -> None:
    for name in BLOCKED:
        sys.modules[name] = None
    try:
        import torch
        import torch.distributed as dist

        fn, args = pickle.loads(payload)
        device_id = None
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device_id = torch.device("cuda", rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout), device_id=device_id,
        )
        out = pickle.dumps(_host(fn(*args)))
        dist.barrier()
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_ranks(fn, world: int, *, backend: str, args: tuple = (), timeout: float = 600.0) -> list:
    """``[fn(*args) in rank 0, ..., in rank world-1]``, each rank a spawned
    process in a ``world``-rank group on ``backend`` ("nccl" or "gloo").

    ``fn`` must be importable by name (a module-level function of a module
    that does not import JAX, ``ffs_tpu`` or ``bench``); ``args`` and the
    results are pickled, tensors in the results arrive on the CPU.  Raises
    :class:`RankError` with the first failing rank's traceback, or when a
    rank dies without a result or the ranks take longer than ``timeout``
    seconds (also the process group's timeout).
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if world < 1:
        raise ValueError(f"world {world} < 1")
    if backend == "nccl":
        import torch

        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"NCCL runs one rank a card: {world} ranks, "
                f"{torch.cuda.device_count()} CUDA device(s)"
            )
    payload = pickle.dumps((fn, args))
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ffs_ranks_") as tmp:
        results = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"ffs-rank-{rank}",
                        args=(rank, world, backend, os.path.join(tmp, "store"), timeout,
                              payload, results))
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        try:
            got = _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [pickle.loads(got[rank]) for rank in range(world)]


def _collect(procs, results, timeout: float) -> dict:
    """Every rank's pickled result; raises at the first failure."""
    deadline = time.monotonic() + timeout
    got: dict[int, bytes] = {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(len(procs)) if r not in got]
            raise RankError(f"ranks {missing} gave no result within {timeout} s")
        try:
            rank, ok, blob = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            for rank, p in enumerate(procs):
                if rank not in got and p.exitcode not in (None, 0):
                    raise RankError(
                        f"rank {rank} of {len(procs)} exited with code {p.exitcode} "
                        "without a result"
                    ) from None
            continue
        if not ok:
            raise RankError(f"rank {rank} of {len(procs)} failed:\n{blob}")
        got[rank] = blob
    return got
