"""CBF byte-offset image-file reader
(reference: spotfinder/cbfread.cc:37-130, cbfread.hpp).

Filename templates use ``#`` runs for the image number; image dimensions are
scanned from the header; the binary section starts after the CBF marker
``\\x0c\\x1a\\x04\\xd5``; the mask is derived from the negative pixels of the
first frame.
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import compression

BINARY_MARKER = b"\x0c\x1a\x04\xd5"


def expand_template(template: str, index: int) -> str:
    first = template.find("#")
    last = template.rfind("#")
    if first < 0:
        return template
    width = last - first + 1
    return template[:first] + str(index).zfill(width) + template[last + 1 :]


class CBFRead:
    def __init__(self, template: str, num_images: int, first_index: int = 0):
        if first_index > 1:
            raise ValueError("Can only handle CBF start index of 0 or 1")
        self._template = template
        self._num_images = num_images
        self._first_index = first_index

        # one read of the first file serves the header scan AND the
        # first-frame decode for the mask (the header keys live in the
        # pre-binary text section; re-reading a multi-MB file twice is
        # pure waste)
        first_file = expand_template(template, first_index)
        with open(first_file, "rb") as f:
            data = f.read()
        dims = {}
        for key in ("X-Binary-Size-Fastest-Dimension", "X-Binary-Size-Second-Dimension"):
            m = re.search((key + r":?\s+(\d+)").encode(), data)
            if not m:
                raise IOError(f"CBF header missing {key} in {first_file}")
            dims[key] = int(m.group(1))
        self._shape = (
            dims["X-Binary-Size-Second-Dimension"],
            dims["X-Binary-Size-Fastest-Dimension"],
        )
        # mask = negative pixels of frame 0 (cbfread.cc:62-83); stored 1=valid
        start = data.find(BINARY_MARKER)
        if start < 0:
            raise IOError(f"No binary section in {first_file}")
        h, w = self._shape
        img0 = compression.byte_offset_decompress(
            data[start + len(BINARY_MARKER) :], h * w
        ).reshape(h, w)
        self._mask = (img0.view(np.int32) >= 0).astype(np.uint8)

    @property
    def image_shape(self):
        return self._shape

    def get_number_of_images(self):
        return self._num_images

    def get_mask(self):
        return self._mask

    def get_trusted_range(self):
        return (0.0, float(np.iinfo(np.int32).max))

    def get_wavelength(self):
        return None

    def get_pixel_size(self):
        return None

    def get_beam_center(self):
        return None

    def get_detector_distance(self):
        return None

    def get_oscillation(self):
        return (0.0, 0.0)

    def get_element_size(self):
        return 4  # CBF data decodes to 32-bit

    def is_image_available(self, index: int) -> bool:
        return os.path.exists(
            expand_template(self._template, index + self._first_index)
        )

    def get_raw_chunk(self, index: int) -> bytes:
        path = expand_template(self._template, index + self._first_index)
        with open(path, "rb") as f:
            data = f.read()
        start = data.find(BINARY_MARKER)
        if start < 0:
            raise IOError(f"No binary section in {path}")
        return data[start + len(BINARY_MARKER) :]

    def get_image(self, index: int) -> np.ndarray:
        chunk = self.get_raw_chunk(index)
        h, w = self._shape
        return compression.byte_offset_decompress(chunk, h * w).reshape(h, w)


def is_ready_for_read(template: str) -> bool:
    return os.path.exists(expand_template(template, 1))
