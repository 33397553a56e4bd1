"""DIALS-compatible reflection table with HDF5 I/O.

Matches the on-disk layout the reference reads/writes: datasets under
``dials/processing/group_0`` with ``experiment_ids`` / ``identifiers``
group attributes (reference: spotfinder/spotfinder.cc:1234-1249,
src/ffs/ssx_index.py:217-241, dx2 ReflectionTable).
"""

from __future__ import annotations

import uuid

import numpy as np

DEFAULT_GROUP = "dials/processing/group_0"

# DIALS reflection flags (reference: baseline/predictor/scan_static_predictor.cc:18,
# integrator/integrator.cc flag usage)
PREDICTED = 1 << 0
OBSERVED = 1 << 1
INDEXED = 1 << 2
USED_IN_REFINEMENT = 1 << 3
STRONG = 1 << 5
INTEGRATED_SUM = 1 << 8
CENTROID_OUTLIER = 1 << 17


class ReflectionTable:
    """Column store of equal-length arrays plus experiment identifiers."""

    def __init__(self):
        self._columns: dict[str, np.ndarray] = {}
        self.experiment_ids: list[int] = []
        self.identifiers: list[str] = []
        self.generate_new_attributes()

    # --- identifiers -------------------------------------------------------

    def generate_new_attributes(self) -> int:
        """Add a new experiment id with a fresh UUID identifier; returns it."""
        new_id = (max(self.experiment_ids) + 1) if self.experiment_ids else 0
        self.experiment_ids.append(new_id)
        self.identifiers.append(str(uuid.uuid4()))
        return new_id

    # --- columns ------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __setitem__(self, name: str, values: np.ndarray) -> None:
        values = np.asarray(values)
        if self._columns:
            n = len(next(iter(self._columns.values())))
            if len(values) != n:
                raise ValueError(
                    f"column {name!r} has {len(values)} rows, table has {n}"
                )
        self._columns[name] = values

    def __len__(self) -> int:
        if not self._columns:
            return 0
        return len(next(iter(self._columns.values())))

    def column_names(self) -> list[str]:
        return list(self._columns)

    def select(self, mask_or_idx: np.ndarray) -> "ReflectionTable":
        out = ReflectionTable()
        out.experiment_ids = list(self.experiment_ids)
        out.identifiers = list(self.identifiers)
        for k, v in self._columns.items():
            out._columns[k] = v[mask_or_idx]
        return out

    # --- I/O -----------------------------------------------------------------

    def write(self, path: str, group: str = DEFAULT_GROUP) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            g = f.create_group(group)
            g.attrs["experiment_ids"] = np.asarray(self.experiment_ids, dtype=np.int64)
            g.attrs["identifiers"] = np.asarray(self.identifiers, dtype=object)
            for name, values in self._columns.items():
                g.create_dataset(name, data=values)

    @classmethod
    def read(cls, path: str, group: str = DEFAULT_GROUP) -> "ReflectionTable":
        import h5py

        table = cls()
        table.experiment_ids = []
        table.identifiers = []
        with h5py.File(path, "r") as f:
            g = f[group]
            ids = g.attrs.get("experiment_ids")
            idents = g.attrs.get("identifiers")
            if ids is not None:
                table.experiment_ids = [int(i) for i in np.atleast_1d(ids)]
            if idents is not None:
                table.identifiers = [
                    i.decode() if isinstance(i, bytes) else str(i)
                    for i in np.atleast_1d(idents)
                ]
            if not table.experiment_ids and not table.identifiers:
                table.experiment_ids, table.identifiers = [0], [str(uuid.uuid4())]
            elif not table.experiment_ids:
                # one attr present without the other: synthesize the
                # missing one so the pair always zips (consumers map
                # experiment_ids -> identifiers, e.g. ssx_index)
                table.experiment_ids = list(range(len(table.identifiers)))
            elif not table.identifiers:
                table.identifiers = [
                    str(uuid.uuid4()) for _ in table.experiment_ids
                ]
            for name in g:
                table._columns[name] = g[name][()]
        return table
