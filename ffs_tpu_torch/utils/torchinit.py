"""PyTorch runtime set-up for the CLI entry points (counterpart of
ffs_tpu.utils.jaxinit).

Device selection never falls back to the CPU silently: the CPU is used only
when ``FFS_TORCH_DEVICE=cpu`` asks for it (the CPU test suite sets it, as it
sets ``JAX_PLATFORMS=cpu`` for the JAX package); otherwise a CUDA device
must exist.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "FFS_TORCH_DEVICE"


def setup() -> None:
    """Parity settings: TF32 off for float32 matrix products and
    convolutions (the JAX package needed Precision.HIGHEST wherever a
    product feeds a numeric band)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_device(index: int = 0) -> torch.device:
    """``cuda:index``, or the CPU when FFS_TORCH_DEVICE=cpu; raises otherwise."""
    want = os.environ.get(DEVICE_ENV, "").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise ValueError(f"{DEVICE_ENV}={want!r}: expected 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available; set {DEVICE_ENV}=cpu to run on the CPU"
        )
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(f"--device {index} out of range: {count} CUDA device(s)")
    return torch.device("cuda", index)


def list_devices() -> list[str]:
    """``i: <name>`` for every CUDA device (empty without one)."""
    if not torch.cuda.is_available():
        return []
    return [f"{i}: {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"


def resolve_device(*arrays, device: torch.device | None = None) -> torch.device:
    """``device`` when given, else the device of the first tensor among
    ``arrays``, else :func:`select_device` (the CUDA device, or the CPU
    under FFS_TORCH_DEVICE=cpu)."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return select_device()
