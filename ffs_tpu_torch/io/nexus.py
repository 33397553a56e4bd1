"""NeXus/HDF5 (Eiger master file) reader.

Equivalent of the reference's h5read (reference: h5read/src/h5read.c:280-446):
opens the master SWMR, walks the VDS map of /entry/data/data into per-file
blocks, reads compressed chunks directly (H5Dread_chunk equivalent:
``dataset.id.read_direct_chunk``), and decodes them with our own
bitshuffle-LZ4 codec so no HDF5 filter plugins are required.  Metadata paths
mirror h5read.c (wavelength, beam centre, pixel size, distance, mask,
saturation/underload, omega).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from . import compression

FILTER_BSHUF = 32008
FILTER_LZ4 = 32004


def _read_scalar(f, path, default=None):
    if path not in f:
        return default
    v = f[path][()]
    return float(np.atleast_1d(v)[0])


@dataclass
class _DataBlock:
    frames: int
    offset: int  # first global frame index
    dset_name: str = ""
    file_name: str | None = None  # None: dataset lives in the master file
    src_start: int = 0  # source-side first row of the VDS mapping
    dataset: object = None  # h5py.Dataset, opened lazily for source files
    filters: tuple | None = None  # cached filter-pipeline ids


class NexusReader:
    """SWMR-capable reader over an Eiger NeXus master file."""

    def __init__(self, path: str):
        import h5py

        self._path = path
        # the spotfinder's reader threads read chunks while its main thread
        # polls (a SWMR refresh): HDF5 calls from two threads at once break
        # the read, so each holds this lock; decoding runs outside it
        self._hdf5 = threading.Lock()
        try:
            self._f = h5py.File(path, "r", swmr=True)
        except (OSError, ValueError):
            self._f = h5py.File(path, "r")
        f = self._f

        data = f["/entry/data/data"] if "/entry/data/data" in f else None
        self._blocks: list[_DataBlock] = []
        self._src_files: list = []
        if data is not None and data.is_virtual:
            # Walk the VDS map of /entry/data/data (h5read.c:280-377).
            # Frame offsets/counts come from the VIRTUAL-space mapping
            # extents — not from source dataset shapes or iteration order
            # (a mapping may cover only part of its source, and
            # virtual_sources() order is not guaranteed; h5read takes its
            # per-file counts from the layout too, h5read.c:348-358).
            # Source files open LAZILY: during a live SWMR collection the
            # master appears before the data files do ("Failing to open a
            # data file isn't necessarily an error - it could not exist
            # yet" — h5read.c:301-318), so a missing file must read as
            # frame-not-yet-available, not a constructor crash.
            for vs in data.virtual_sources():
                (v0, *_), (v1, *_) = vs.vspace.get_select_bounds()
                try:
                    (s0, *_), _ = vs.src_space.get_select_bounds()
                except Exception:
                    s0 = 0
                src_path = vs.file_name
                if src_path in (".", path):
                    src_path = None  # dataset lives in the master file
                elif not os.path.isabs(src_path):
                    src_path = os.path.join(os.path.dirname(path), src_path)
                self._blocks.append(
                    _DataBlock(
                        frames=int(v1) - int(v0) + 1,
                        offset=int(v0),
                        dset_name=vs.dset_name,
                        file_name=src_path,
                        src_start=int(s0),
                    )
                )
            self._blocks.sort(key=lambda b: b.offset)
            # the virtual dataset's own extent is the planned frame count
            self._num_images = int(data.shape[0])
            self._shape = data.shape[1:]
            self._dtype = data.dtype
        elif data is not None:
            self._blocks = [
                _DataBlock(frames=data.shape[0], offset=0, dataset=data)
            ]
            self._num_images = data.shape[0]
            self._shape = data.shape[1:]
            self._dtype = data.dtype
        else:
            # data_000001 style external links under /entry/data
            offset = 0
            grp = f["/entry/data"]
            for key in sorted(grp.keys()):
                try:
                    src = grp[key]
                except KeyError:
                    continue  # broken external link (file not yet written)
                self._blocks.append(
                    _DataBlock(frames=src.shape[0], offset=offset, dataset=src)
                )
                offset += src.shape[0]
            if not self._blocks:
                raise IOError(f"No image data found in {path}")
            self._num_images = offset
            self._shape = self._blocks[0].dataset.shape[1:]
            self._dtype = self._blocks[0].dataset.dtype

        # metadata (paths per h5read.c)
        det = "/entry/instrument/detector"
        self._wavelength = _read_scalar(f, "/entry/instrument/beam/incident_wavelength")
        self._beam_center = (
            _read_scalar(f, f"{det}/beam_center_y"),
            _read_scalar(f, f"{det}/beam_center_x"),
        )
        self._pixel_size = (
            _read_scalar(f, f"{det}/y_pixel_size"),
            _read_scalar(f, f"{det}/x_pixel_size"),
        )
        self._distance = _read_scalar(f, f"{det}/distance") or _read_scalar(
            f, f"{det}/detector_distance"
        )
        sat = _read_scalar(f, f"{det}/saturation_value")
        under = _read_scalar(f, f"{det}/underload_value", 0.0)
        if sat is None:
            sat = float(np.iinfo(self._dtype).max)
        self._trusted_range = (under, sat)

        # mask: 0 = valid in the file; we store 1 = valid (h5read.c:561-640)
        self._mask = None
        if f"{det}/pixel_mask" in f:
            raw = f[f"{det}/pixel_mask"][()]
            self._mask = (raw == 0).astype(np.uint8)

        # oscillation (h5read.c:827-856)
        self._oscillation = (0.0, 0.0)
        if "/entry/sample/sample_omega/omega" in f:
            omega = np.atleast_1d(f["/entry/sample/sample_omega/omega"][()])
            if len(omega) >= 2:
                self._oscillation = (
                    float(omega[0]),
                    float(omega[1]) - float(omega[0]),
                )
            elif len(omega) == 1:
                self._oscillation = (float(omega[0]), 0.0)

    # --- Reader interface ---------------------------------------------------

    @property
    def image_shape(self) -> tuple[int, int]:
        return (int(self._shape[0]), int(self._shape[1]))

    def get_number_of_images(self) -> int:
        return self._num_images

    def get_mask(self):
        return self._mask

    def get_trusted_range(self):
        return self._trusted_range

    def get_wavelength(self):
        return self._wavelength

    def get_pixel_size(self):
        return self._pixel_size  # (slow, fast) metres

    def get_beam_center(self):
        return self._beam_center  # (slow, fast) px

    def get_detector_distance(self):
        return self._distance  # metres

    def get_oscillation(self):
        return self._oscillation

    def get_element_size(self) -> int:
        return self._dtype.itemsize

    def _block_for(self, index: int):
        for b in self._blocks:
            if b.offset <= index < b.offset + b.frames:
                return b, index - b.offset + b.src_start
        raise IndexError(index)

    def _dataset_for(self, b: _DataBlock):
        """Open the block's source dataset on first use (live-collection
        safe: raises OSError while the data file is still unwritten —
        is_image_available turns that into 'not yet')."""
        if b.dataset is None:
            import h5py

            if b.file_name is None:
                b.dataset = self._f[b.dset_name]
            else:
                try:
                    fh = h5py.File(b.file_name, "r", swmr=True)
                except (OSError, ValueError):
                    fh = h5py.File(b.file_name, "r")
                self._src_files.append(fh)
                b.dataset = fh[b.dset_name]
        return b.dataset

    def is_image_available(self, index: int) -> bool:
        if index >= self._num_images:
            return False
        try:
            b, local = self._block_for(index)
            with self._hdf5:
                ds = self._dataset_for(b)
                ds.id.refresh()
                return ds.shape[0] > local
        except Exception:
            return False

    def get_image(self, index: int) -> np.ndarray:
        """Read + decode one frame, bypassing HDF5 filter plugins."""
        b, local = self._block_for(index)
        with self._hdf5:
            ds = self._dataset_for(b)
            if b.filters is None:
                # the filter pipeline is a per-dataset constant: walk it once,
                # not per frame (a 3600-frame read otherwise repeats 3600
                # create-plist/filter-enumeration HDF5 round-trips)
                b.filters = tuple(
                    f_id for f_id, *_ in self._chunk_filters(ds)
                )
            filters = b.filters
            if not (FILTER_BSHUF in filters or FILTER_LZ4 in filters):
                return ds[local]  # uncompressed / gzip: h5py handles it
            _, chunk = ds.id.read_direct_chunk((local, 0, 0))
        h, w = self.image_shape
        if FILTER_BSHUF in filters:
            flat = compression.bshuf_lz4_decompress(
                chunk, h * w, self._dtype.itemsize
            )
        else:  # plain LZ4 filter: same framing without bit transpose
            flat = compression.lz4_chunk_decompress(
                chunk, h * w * self._dtype.itemsize
            )
        return flat.view(self._dtype).reshape(h, w)

    def get_raw_chunk(self, index: int) -> bytes:
        b, local = self._block_for(index)
        with self._hdf5:
            return self._dataset_for(b).id.read_direct_chunk((local, 0, 0))[1]

    def get_image_planes(self, index: int) -> np.ndarray | None:
        """LZ4-only decode of one frame for the device-side bitshuffle
        untranspose (SpotfindProcessor.dispatch_batch_planes): returns a
        (n_blocks, block_bytes) uint8 plane matrix, or None when the frame
        is not bitshuffle-LZ4 compressed (caller falls back to
        :meth:`get_image`)."""
        b, local = self._block_for(index)
        h, w = self.image_shape
        with self._hdf5:
            ds = self._dataset_for(b)
            if b.filters is None:
                b.filters = tuple(f_id for f_id, *_ in self._chunk_filters(ds))
            if FILTER_BSHUF not in b.filters:
                return None
            if (h * w) % 8:
                return None  # raw <8-element tail: keep the host decode
            _, chunk = ds.id.read_direct_chunk((local, 0, 0))
        planes, _tail, _be, _ns = compression.bshuf_lz4_planes(
            chunk, h * w, self._dtype.itemsize
        )
        return planes

    @staticmethod
    def _chunk_filters(ds):
        """(filter_id, flags, values) triples on the dataset's pipeline."""
        plist = ds.id.get_create_plist()
        out = []
        for i in range(plist.get_nfilters()):
            out.append(plist.get_filter(i))
        return out

    def close(self):
        for fh in self._src_files:
            try:
                fh.close()
            except Exception:
                pass
        self._src_files.clear()
        self._f.close()
