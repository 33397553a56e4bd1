"""ssx_index CLI on PyTorch — standalone serial-crystallography indexing.

Counterpart of :mod:`ffs_tpu.service.ssx_index` (reference ``ssx_index``,
src/ffs/ssx_index.py:160-420) with the same flags, prints and outputs: per
image with >= min_spots strong spots, index against a known cell with the
port's SSX indexer (:mod:`..indexing.ssx`, the search on the device) and
aggregate the per-image lattices into indexed.refl / indexed.expt.

:func:`index_strong_spots` is the per-image loop; it needs no h5py, which
only :func:`run` (reading the strong spots) and
:meth:`IndexedCollection.write_reflections` use.

Console script: ``ssx_index_torch``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


class IndexedCollection:
    """One record per indexed lattice; renders the two output artefacts.

    The FILE formats (`indexed.expt` crystal dicts, the DIALS
    ``dials/processing/group_0`` reflection-table layout with its
    ``experiment_ids``/``identifiers`` attrs) are fixed by downstream
    DIALS consumers; the in-memory shape is our own — a flat list of
    per-lattice records, with columns materialised only at write time.
    """

    def __init__(self, identifiers_map):
        self._records: list[dict] = []
        self._identifiers = identifiers_map

    def __len__(self) -> int:
        return len(self._records)

    def record(self, result, image_no: int) -> None:
        """Store one indexing solution (all arrays copied out of the
        result so the indexer can reuse its buffers)."""
        b_real = np.linalg.inv(np.asarray(result.a_matrix))
        self._records.append(
            {
                "image": int(image_no),
                "crystal": {
                    "__id__": "crystal",
                    "real_space_a": [float(v) for v in b_real[0]],
                    "real_space_b": [float(v) for v in b_real[1]],
                    "real_space_c": [float(v) for v in b_real[2]],
                    "space_group_hall_symbol": "P 1",
                },
                "miller": np.asarray(result.miller_indices, np.int32),
                "xyzobs": np.asarray(result.xyzobs_px, float).reshape(-1, 3),
                "xyzcal": np.asarray(result.xyzcal_px, float).reshape(-1, 3),
                "delpsi": np.asarray(result.delpsi, float),
                "s1": np.asarray(result.s1, float).reshape(-1, 3),
            }
        )

    @property
    def crystals(self) -> list[dict]:
        return [r["crystal"] for r in self._records]

    @property
    def crystal_image_numbers(self) -> list[int]:
        return [r["image"] for r in self._records]

    def write_reflections(self, filename) -> None:
        """Emit the DIALS-layout reflection table for every lattice."""
        import h5py

        def col(key):
            return np.concatenate([r[key] for r in self._records])

        lattice_sizes = [len(r["delpsi"]) for r in self._records]
        lattice_id = np.repeat(
            np.arange(len(self._records), dtype=np.int32), lattice_sizes
        )
        image_no = np.repeat(
            np.asarray([r["image"] for r in self._records], np.int32),
            lattice_sizes,
        )
        with h5py.File(Path.cwd() / filename, "w") as f:
            g = f.create_group("dials/processing/group_0")
            g["id"] = lattice_id
            g["image"] = image_no
            g["xyzobs.px.value"] = col("xyzobs")
            g["xyzcal.px"] = col("xyzcal")
            g["s1"] = col("s1")
            g["delpsical.rad"] = col("delpsi")
            g["miller_index"] = col("miller").astype(np.int32)
            # experiment ids are the DENSE lattice numbers; identifiers
            # map each back to its source image's identifier string
            g.attrs["experiment_ids"] = np.arange(
                len(self._records), dtype=np.uint64
            )
            g.attrs["identifiers"] = [
                self._identifiers[r["image"]] for r in self._records
            ]
            g["panel"] = np.zeros_like(lattice_id, dtype=np.uint64)


def index_strong_spots(indexer, xyzs: np.ndarray, ids: np.ndarray, min_spots: int,
                       collection: "IndexedCollection") -> tuple[int, int, int]:
    """Index every image of a strong-spot list (``xyzobs.px.value`` rows
    with their image ``id``s, grouped by id) with an armed indexer, record
    each solution in ``collection`` and print the CLI's per-image lines.
    Returns (images indexed, images considered, non-empty images)."""
    unique_ids, starts = np.unique(ids, return_index=True)
    ends = np.append(starts[1:], len(ids))

    n_indexed_images = 0
    n_considered = 0
    n_total = 0
    for id_, start, end in zip(unique_ids, starts, ends):
        xyzs_this = xyzs[start:end]
        if not xyzs_this.any():
            continue
        n_total += 1
        if len(xyzs_this) < min_spots:
            continue
        n_considered += 1
        result, n_unindexed = indexer.index(xyzs_this)
        if result is not None and len(result.delpsi):
            n_indexed_images += 1
            collection.record(result, int(id_))
            rmsdx, rmsdy, rmsd_psi = result.rmsds
            cell_str = ", ".join(f"{v:.3f}" for v in result.cell_parameters)
            print(
                f"Indexed {len(result.delpsi)}/{len(xyzs_this)} spots on image "
                f"{int(id_) + 1}:\n  cell: {cell_str}\n"
                f"  RMSDs: (x(px), y(px), psi(rad)): {rmsdx:.3f}, {rmsdy:.3f}, "
                f"{rmsd_psi:.5f}"
            )
        else:
            print(f"No indexing solution for image {int(id_) + 1}")
    return n_indexed_images, n_considered, n_total


def run(args=None) -> None:
    st = time.time()
    parser = argparse.ArgumentParser(
        prog="index",
        description=(
            "Runs standalone indexing of serial data using the "
            "fast-feedback-indexer on PyTorch"
        ),
    )
    parser.add_argument("-r", "--reflections", help="Path to the strong spots h5 file")
    parser.add_argument("-e", "--experiments", help="Path to the imported.expt json")
    parser.add_argument(
        "-c",
        "--cell",
        type=float,
        nargs=6,
        metavar=("a", "b", "c", "alpha", "beta", "gamma"),
        help="Unit cell parameters: a b c alpha beta gamma",
    )
    parser.add_argument("--min-spots", type=int, default=10)
    parser.add_argument("--test", action="store_true")
    parsed = parser.parse_args(args)

    if not parsed.experiments:
        print("No imported experiment list provided.")
        return
    with open(parsed.experiments) as f:
        expts = json.load(f)
    wavelength = expts["beam"][0]["wavelength"]
    panel_dict = expts["detector"][0]["panels"][0]
    hierarchy = expts["detector"][0].get(
        "hierarchy", {"origin": [0.0, 0.0, 0.0]}
    )

    from ..models.geometry import simple_panel

    px_x, px_y = panel_dict["pixel_size"]
    origin = np.asarray(hierarchy["origin"]) + np.asarray(panel_dict["origin"])
    distance = -origin[2]
    beam_center_x = -origin[0] / px_x
    beam_center_y = origin[1] / px_y
    panel = simple_panel(
        distance_mm=distance,
        beam_center_px=(beam_center_x, beam_center_y),
        pixel_size_mm=(px_x, px_y),
        image_size=tuple(panel_dict["image_size"]),
        mu=panel_dict.get("mu", 0.0),
        thickness=panel_dict.get("thickness", 0.0),
        parallax=panel_dict.get("mu", 0.0) > 0,
        material=panel_dict.get("material", ""),
    )

    if not parsed.reflections:
        print("No strong reflections h5 file provided.")
        return
    try:
        import h5py

        with h5py.File(parsed.reflections) as refls:
            g = refls["dials"]["processing"]["group_0"]
            xyzs = g["xyzobs.px.value"][:]
            ids = g["id"][:]
            experiment_ids = g.attrs["experiment_ids"]
            identifiers = [
                i.decode() if isinstance(i, bytes) else str(i)
                for i in g.attrs["identifiers"]
            ]
            identifiers_map = dict(zip((int(i) for i in experiment_ids), identifiers))
    except Exception as e:
        print(
            "Unable to interpret the reflection file - please check input.\n"
            f" Error: {e}"
        )
        return

    if parsed.cell is None:
        # friendly error like the -r/-e paths (divergence: the reference
        # crashes with a raw TypeError via gemmi.UnitCell(*None))
        print("Please specify the unit cell with -c/--cell")
        return

    from ..indexing.ssx import SSXIndexer

    indexer = SSXIndexer(min_spots=parsed.min_spots)
    indexer.panel = panel
    indexer.cell = tuple(parsed.cell)
    indexer.wavelength = wavelength

    collection = IndexedCollection(identifiers_map)
    t1 = time.time()
    n_indexed_images, n_considered, n_total = index_strong_spots(
        indexer, xyzs, ids, parsed.min_spots, collection
    )
    t2 = time.time()
    print(
        f"Indexing attempted on {n_considered}/{n_total} non-empty images with "
        f">= {parsed.min_spots} spots"
    )
    print(f"Indexed {n_indexed_images}/{n_total} non-empty images in {t2 - t1:.3f}s")

    if parsed.test:
        with open("indexed_crystals.json", "w") as f:
            json.dump(collection.crystals, f, indent=2)
    else:
        expts["crystal"] = collection.crystals
        for i, id_ in enumerate(collection.crystal_image_numbers):
            expts["experiment"][id_]["crystal"] = i
        with open("indexed.expt", "w") as f:
            json.dump(expts, f, indent=2)

    if not len(collection):
        print("no indexed lattices - skipping the reflection table")
    else:
        collection.write_reflections("indexed.refl")
    t3 = time.time()
    print(
        f"Setup time: {t1 - st:.3f}s, index time {t2 - t1:.3f}s, "
        f"write time {t3 - t2:.3f}s"
    )


def main() -> None:
    run()


if __name__ == "__main__":
    run()
