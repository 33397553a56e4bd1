"""The PIA service's per-line indexing step, without the service's
transport or pydantic (counterpart of the hook in
ffs_tpu.service.pia.PiaService.handle's ``read_and_send``, reference:
src/ffs/service.py:447-491).

:class:`.pia.PiaService` calls :func:`index_pipe_payload` on every pipe line
of a collection whose request carried a unit cell and a wavelength;
``chip_smoke.py`` calls it the same way.
"""

from __future__ import annotations

import numpy as np


def index_pipe_payload(indexer, data: dict) -> dict:
    """Index one spotfinder pipe line in place and return it.

    A line with ``spot_centers`` (the spotfinder's ``--output-for-index``)
    loses them and gains ``lattices`` (one entry per solution: unit cell,
    space group P1, indexed count, rmsds) and ``n_unindexed``; other lines
    are returned unchanged.  ``indexer`` is an armed
    :class:`..indexing.ssx.SSXIndexer` (panel, cell and wavelength set).
    A failure of the indexer raises.
    """
    if "spot_centers" not in data:
        return data
    xyzobs = np.array(data.pop("spot_centers")).reshape(-1, 3)
    result, n_unindexed = indexer.index(xyzobs)
    lattices = []
    if result is not None:
        lattices.append(
            {
                "unit_cell": result.cell_parameters,
                "space_group": "P1",
                "n_indexed": len(result.delpsi),
                "rmsds": result.rmsds,
            }
        )
    data["lattices"] = lattices
    data["n_unindexed"] = int(n_unindexed)
    return data
