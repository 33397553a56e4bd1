"""The detector stream a run feeds the spotfinder, in the layout the Eiger
stream dumper writes and the spotfinder's stream reader reads:

    start_1          JSON header (image count, geometry, bit depth, omega)
    start_4          present once the collection has started
    start_5          int32 mask, non-zero on masked pixels
    image_NNNNNN_2   one bitshuffle-LZ4 chunk an image

The K distinct chunks live once as ``blob_KKKK``; releasing image i makes the
symlink ``image_{i:06d}_2`` to blob ``i mod K``, so a long collection costs no
disk.  The stream repeats with period K: that is a property of the benchmark,
and no program may key anything on it.

    python -m ffsbench.stream CONFIG.json TRAFFIC.json SEED DIR THREADS

makes the frames on the torch device from the seed, writes DIR, and prints
one JSON line (the chunks' bytes, the frames' checksums).  It runs as a
process of its own so that the card is free again, context and all, before
the spotfinder starts.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

HEADER_IMAGES = 10_000_000  # more than any window reaches, at any detector rate


def header(config: dict) -> dict:
    det, geo = config["detector"], config["geometry"]
    px_m = det["pixel_size_mm"] / 1000.0
    hdr = {
        "nimages": HEADER_IMAGES,
        "ntrigger": 1,
        "y_pixels_in_detector": det["height"],
        "x_pixels_in_detector": det["width"],
        "bit_depth_image": det["bit_depth"],
        "countrate_correction_count_cutoff": det["trusted_max"],
        "wavelength": geo["wavelength_A"],
        "detector_distance": geo["distance_mm"],
        "y_pixel_size": px_m,
        "x_pixel_size": px_m,
        "beam_center_y": geo["beam_center_px"][1],
        "beam_center_x": geo["beam_center_px"][0],
    }
    if "omega_increment_deg" in geo:
        hdr["omega_start"] = geo["omega_start_deg"]
        hdr["omega_increment"] = geo["omega_increment_deg"]
    return hdr


def blob_name(k: int) -> str:
    return f"blob_{k:04d}"


def release(stream: pathlib.Path, image: int, k: int) -> None:
    """Make image ``image`` appear: a relative symlink to its blob."""
    os.symlink(blob_name(image % k), stream / f"image_{image:06d}_2")


def write(config: dict, traffic: dict, seed: int, stream: pathlib.Path, threads: int) -> dict:
    import torch

    from . import codec
    from .frames import bench_device, checksums, detector_mask, make_frames

    device = bench_device()
    t0 = time.perf_counter()
    frames = make_frames(config, traffic, seed, device)
    sums = checksums(frames)
    host = frames.cpu().numpy()
    del frames
    t1 = time.perf_counter()
    blobs = codec.encode_all(host, threads)
    t2 = time.perf_counter()
    stream.mkdir(parents=True, exist_ok=True)
    mask = detector_mask(config["detector"])
    (stream / "start_5").write_bytes((mask == 0).astype(np.int32).tobytes())
    for k, blob in enumerate(blobs):
        (stream / blob_name(k)).write_bytes(blob)
    (stream / "start_1").write_text(json.dumps(header(config)))
    (stream / "start_4").write_text("{}")
    return {"checksums": sums, "compressed_bytes": sum(len(b) for b in blobs),
            "raw_bytes": int(host.nbytes), "make_s": t1 - t0, "encode_s": t2 - t1,
            "write_s": time.perf_counter() - t2, "device": str(device)}


def main(argv: list[str]) -> int:
    config_path, traffic_path, seed, out, threads = argv
    config = json.loads(pathlib.Path(config_path).read_text())
    traffic = json.loads(pathlib.Path(traffic_path).read_text())
    info = write(config, traffic, int(seed), pathlib.Path(out), int(threads))
    print(json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
