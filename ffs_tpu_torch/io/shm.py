"""/dev/shm Eiger stream reader (reference: spotfinder/shmread.cc:13-95).

Layout written by the beamline stream dumper:
  <dir>/start_1        JSON header (nimages, geometry, bit depth, ...)
  <dir>/start_5        int32 mask (non-zero = masked; inverted here)
  <dir>/image_%06d_2   per-image bitshuffle-LZ4 compressed blob
Readiness requires start_1 and start_4 to exist.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import compression


class SHMRead:
    def __init__(self, path: str):
        self._base = path
        with open(os.path.join(path, "start_1")) as f:
            hdr = json.load(f)
        self._num_images = int(hdr["nimages"]) * int(hdr.get("ntrigger", 1))
        self._shape = (
            int(hdr["y_pixels_in_detector"]),
            int(hdr["x_pixels_in_detector"]),
        )
        depth = int(hdr["bit_depth_image"])
        if depth == 16:
            self._dtype = np.dtype(np.uint16)
        elif depth == 32:
            self._dtype = np.dtype(np.uint32)
        else:
            raise RuntimeError(f"Data is unhandled bit-depth: {depth}-bit")
        self._trusted_range = (0, int(hdr["countrate_correction_count_cutoff"]))
        self._wavelength = hdr.get("wavelength")
        self._distance = float(hdr["detector_distance"]) / 1000.0  # mm -> m
        self._pixel_size = (float(hdr["y_pixel_size"]), float(hdr["x_pixel_size"]))
        self._beam_center = (float(hdr["beam_center_y"]), float(hdr["beam_center_x"]))
        if "omega_start" in hdr and "omega_increment" in hdr:
            self._oscillation = (
                float(hdr["omega_start"]),
                float(hdr["omega_increment"]),
            )
        else:
            self._oscillation = (0.0, 0.0)

        raw_mask = np.fromfile(os.path.join(path, "start_5"), dtype=np.int32)
        if raw_mask.size != self._shape[0] * self._shape[1]:
            raise RuntimeError("Error: Mask file does not match expected size")
        self._mask = (raw_mask == 0).astype(np.uint8).reshape(self._shape)

    @property
    def image_shape(self):
        return self._shape

    def get_number_of_images(self):
        return self._num_images

    def get_mask(self):
        return self._mask

    def get_trusted_range(self):
        return self._trusted_range

    def get_wavelength(self):
        return self._wavelength

    def get_pixel_size(self):
        return self._pixel_size

    def get_beam_center(self):
        return self._beam_center

    def get_detector_distance(self):
        return self._distance

    def get_oscillation(self):
        return self._oscillation

    def get_element_size(self):
        return self._dtype.itemsize

    def is_image_available(self, index: int) -> bool:
        return os.path.exists(os.path.join(self._base, f"image_{index:06d}_2"))

    def get_raw_chunk(self, index: int) -> bytes:
        with open(os.path.join(self._base, f"image_{index:06d}_2"), "rb") as f:
            return f.read()

    def get_image(self, index: int) -> np.ndarray:
        chunk = self.get_raw_chunk(index)
        h, w = self._shape
        flat = compression.bshuf_lz4_decompress(chunk, h * w, self._dtype.itemsize)
        return flat.view(self._dtype).reshape(h, w)

    def get_image_planes(self, index: int):
        """LZ4-only decode for the device-side untranspose (see
        io/nexus.py get_image_planes); None when the frame has a raw
        sub-8-element tail."""
        h, w = self._shape
        if (h * w) % 8:
            return None
        chunk = self.get_raw_chunk(index)
        planes, _tail, _be, _ns = compression.bshuf_lz4_planes(
            chunk, h * w, self._dtype.itemsize
        )
        return planes


def is_ready_for_read(path: str) -> bool:
    return os.path.exists(os.path.join(path, "start_1")) and os.path.exists(
        os.path.join(path, "start_4")
    )
