"""Detector frames from a seed: the traffic's background and spots on the
configuration's detector, made on the torch device in a few bulk calls.

The same seed, configuration and traffic give the same frames on the same
device type; :func:`checksums` lets a second process confirm it made the
frames the first one made.  Frames are zero under the mask, as a detector
writes its gaps.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def bench_device() -> torch.device:
    """The card, or the CPU where ``FFS_TORCH_DEVICE=cpu`` asks for it (the
    benchmark's own tests); the harness refuses a run with neither."""
    if os.environ.get("FFS_TORCH_DEVICE") == "cpu":
        return torch.device("cpu")
    return torch.device("cuda")


def detector_mask(det: dict) -> np.ndarray:
    """(H, W) uint8, 1 on pixels that count, from the configuration's mask model."""
    h, w = det["height"], det["width"]
    spec = det["mask"]
    if spec["kind"] == "modules":
        mask = np.zeros((h, w), np.uint8)
        (mh, mw), (gh, gw), (ny, nx) = spec["module"], spec["gap"], spec["grid"]
        for j in range(ny):
            for i in range(nx):
                y0, x0 = j * (mh + gh), i * (mw + gw)
                mask[y0 : y0 + mh, x0 : x0 + mw] = 1
        return mask
    if spec["kind"] == "row_band":
        mask = np.ones((h, w), np.uint8)
        mask[h // 2 : h // 2 + spec["rows"]] = 0
        return mask
    raise ValueError(f"unknown mask kind {spec['kind']!r}")


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def spot_profiles(sp: dict, n: int, g: torch.Generator, device: torch.device) -> torch.Tensor:
    """(n, 2r+1, 2r+1) unit-sum Gaussian profiles, r = ``spots.half_width``, each
    with its own width drawn uniformly from ``spots.sigma_px``."""
    r = int(sp["half_width"])
    lo, hi = (float(v) for v in sp["sigma_px"])
    sigma = lo + (hi - lo) * torch.rand(n, 1, 1, generator=g, device=device)
    d = torch.arange(-r, r + 1, device=device, dtype=torch.float32)
    prof = torch.exp(-(d.view(1, -1, 1) ** 2 + d.view(1, 1, -1) ** 2) / (2 * sigma * sigma))
    return prof / prof.sum(dim=(1, 2), keepdim=True)


def spot_intensities(sp: dict, n: int, g: torch.Generator, device: torch.device) -> torch.Tensor:
    """(n,) mean counts of each spot on a frame.  ``wilson_acentric``: the
    exponential law of acentric reflection intensities (A. J. C. Wilson,
    Acta Cryst. 2 (1949) 318-321), mean ``spots.intensity.mean``."""
    law = sp["intensity"]
    if law["kind"] != "wilson_acentric":
        raise ValueError(f"unknown intensity law {law['kind']!r}")
    return torch.empty(n, device=device).exponential_(1.0 / float(law["mean"]), generator=g)


def make_frames(config: dict, traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """(K, H, W) frames of the detector's pixel type on ``device``.

    Each frame: a Poisson background (a fresh draw a frame), then, on hit
    frames, ``spots.count`` spots, each a reflection of Wilson-distributed
    intensity on a Gaussian profile; a spot's pixels add Poisson(intensity x
    profile) counts.  A spot set holds its positions, intensities and
    profiles for ``spots.persist_frames`` frames in a row (a reflection
    crossing the Ewald sphere over a rotation) with fresh counts each frame.
    A frame is a hit with probability ``hit_rate``, drawn per spot set.
    """
    det = config["detector"]
    h, w = det["height"], det["width"]
    k = traffic["distinct_frames"]
    bg, sp = traffic["background"], traffic["spots"]
    g = generator(seed, device)
    top = (1 << det["bit_depth"]) - 1
    frames = torch.poisson(torch.full((k, h, w), float(bg["mean"]), device=device), generator=g)
    frames = frames.to(torch.int64)

    persist = int(sp["persist_frames"])
    n_sets = -(-k // persist)
    count, margin = int(sp["count"]), int(sp["margin"])
    ys = torch.randint(margin, h - margin, (n_sets, count), generator=g, device=device)
    xs = torch.randint(margin, w - margin, (n_sets, count), generator=g, device=device)
    hit = torch.rand(n_sets, generator=g, device=device) < float(traffic["hit_rate"])
    level = spot_intensities(sp, n_sets * count, g, device).view(n_sets, count, 1, 1)
    profile = spot_profiles(sp, n_sets * count, g, device)
    ph, pw = profile.shape[1:]
    profile = profile.view(n_sets, count, ph, pw)

    set_of = torch.arange(k, device=device) // persist
    mean = (level * profile)[set_of] * hit[set_of].view(k, 1, 1, 1)
    counts = torch.poisson(mean.contiguous(), generator=g).to(torch.int64)
    dy = torch.arange(ph, device=device) - ph // 2
    dx = torch.arange(pw, device=device) - pw // 2
    yy = ys[set_of].view(k, count, 1, 1) + dy.view(1, 1, ph, 1)
    xx = xs[set_of].view(k, count, 1, 1) + dx.view(1, 1, 1, pw)
    zz = torch.arange(k, device=device).view(k, 1, 1, 1)
    zz, yy, xx = torch.broadcast_tensors(zz, yy, xx)
    frames.index_put_((zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)), counts.reshape(-1),
                      accumulate=True)
    mask = torch.from_numpy(detector_mask(det)).to(device)
    frames = torch.where(mask.bool(), frames.clamp(max=top), 0)
    # through same-width signed types: PyTorch converts few ops to its unsigned ones
    if det["bit_depth"] == 16:
        return torch.where(frames > 32767, frames - 65536, frames).to(torch.int16).view(torch.uint16)
    return torch.where(frames > 2**31 - 1, frames - 2**32, frames).to(torch.int32).view(torch.uint32)


def checksums(frames: torch.Tensor) -> list[int]:
    """One integer a frame: the pixels weighted by their position, on the device."""
    k = frames.shape[0]
    flat = frames.reshape(k, -1)
    vals = flat.view(torch.int16).to(torch.int64) & 0xFFFF if flat.dtype == torch.uint16 \
        else flat.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    weight = torch.arange(flat.shape[1], device=frames.device, dtype=torch.int64) % 65521 + 1
    return [int(v) for v in (vals * weight).sum(dim=1).cpu()]
