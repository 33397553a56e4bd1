"""Typed detector registry and geometry payloads.

Equivalent of the reference's pydantic detector models (reference:
src/ffs/service.py:67-153): Eiger16M / Eiger4M / Eiger9MCdTe with sensor
thickness, material and a cached attenuation coefficient.

The attenuation coefficient mu(lambda) (reference delegates to dx2's
tabulated attenuation data via ffs.index.calculate_mu_for_material_at_
wavelength, baseline/indexer/index_module.cpp:225-227) is computed here
from embedded mass-attenuation tables with log-log interpolation — the
same NIST/XCOM data family and interpolation scheme the dx2/cctbx tables
use.  The Si grid is the NIST SRD-126 table verbatim (validated against
the dx2-computed anchor mu(Si, 0.97625 A) = 3.92199 mm^-1 to < 0.3 %);
the Cd/Te grids are power-law reconstructions of the NIST data anchored
at 10 keV with the K-edge discontinuities in place (provenance note: the
zero-egress build environment has no XCOM source, so the CdTe values
carry a few-percent table uncertainty — still far more faithful than any
single-anchor scaling law, and the parallax offsets they feed are tens of
microns, so a few percent is < 0.05 px).
"""

from __future__ import annotations

import json
import math
from enum import Enum
from typing import Literal, Union

from pydantic import BaseModel, Field, PrivateAttr

_HC_KEV_A = 12.398419843320026  # keV * Angstrom

# NIST SRD-126 mass attenuation (total, with coherent) grids: (keV, cm^2/g).
# Duplicated energies mark absorption-edge discontinuities; interpolation is
# log-log within a segment (the cctbx/dx2 scheme).
_SI_TABLE = [
    (1.0, 1570.0),
    (1.5, 535.5),
    (1.8389, 309.2),
    (1.8389, 3193.0),
    (2.0, 2777.0),
    (3.0, 978.4),
    (4.0, 452.9),
    (5.0, 245.0),
    (6.0, 147.0),
    (8.0, 64.68),
    (10.0, 33.89),
    (15.0, 10.34),
    (20.0, 4.464),
    (30.0, 1.436),
    (40.0, 0.7012),
    (50.0, 0.4385),
    (60.0, 0.3207),
    (80.0, 0.2228),
    (100.0, 0.1835),
]


def _powerlaw_grid(anchor_kev, anchor_val, k_edge_kev, jump, lo=4.2, hi=60.0):
    """NIST-shaped reconstruction: mu/rho ~ E^-2.75 between edges, with the
    K-edge jump applied above ``k_edge_kev``."""
    exp = -2.75
    grid = []
    es = [lo, 5.0, 6.0, 8.0, 10.0, 12.0, 15.0, 20.0, 25.0]
    es = [e for e in es if e < k_edge_kev] + [k_edge_kev]
    for e in es:
        grid.append((e, anchor_val * (e / anchor_kev) ** exp))
    above = anchor_val * (k_edge_kev / anchor_kev) ** exp * jump
    grid.append((k_edge_kev, above))
    for e in (30.0, 40.0, 50.0, hi):
        if e > k_edge_kev:
            grid.append((e, above * (e / k_edge_kev) ** exp))
    return grid


_CD_TABLE = _powerlaw_grid(10.0, 101.7, 26.7112, 5.3)
_TE_TABLE = _powerlaw_grid(10.0, 114.0, 31.8138, 5.0)


def _mu_rho_interp(table, energy_kev: float) -> float:
    """Log-log interpolation within a segment; edges via duplicate abscissae."""
    es = [e for e, _ in table]
    if energy_kev <= es[0]:
        i = 0
    elif energy_kev >= es[-1]:
        i = len(table) - 2
    else:
        i = 0
        for k in range(len(es) - 1):
            if es[k] <= energy_kev <= es[k + 1] and es[k] != es[k + 1]:
                i = k
                break
    e0, v0 = table[i]
    e1, v1 = table[i + 1]
    t = (math.log(energy_kev) - math.log(e0)) / (math.log(e1) - math.log(e0))
    return math.exp(math.log(v0) * (1 - t) + math.log(v1) * t)


# material -> ((element table, mass fraction)..., density g/cm^3)
_MATERIALS = {
    "Si": (((_SI_TABLE, 1.0),), 2.33),
    # CdTe: mass fractions from atomic weights Cd 112.414 / Te 127.60
    "CdTe": (((_CD_TABLE, 0.46836), (_TE_TABLE, 0.53164)), 5.85),
}


def calculate_mu_for_material_at_wavelength(material, wavelength: float) -> float:
    """Linear attenuation coefficient in mm^-1 from tabulated mass
    attenuation (reference: dx2 detector_attenuations via
    index_module.cpp:225-227)."""
    mat = Material(material)
    components, density = _MATERIALS[mat.value]
    energy_kev = _HC_KEV_A / float(wavelength)
    mu_rho = sum(
        frac * _mu_rho_interp(table, energy_kev) for table, frac in components
    )
    return mu_rho * density / 10.0  # cm^-1 -> mm^-1


class Material(str, Enum):
    Si = "Si"
    CdTe = "CdTe"


class DetectorParameters(BaseModel):
    detector_type: str
    thickness: float
    material: Material
    pixel_size_x: float
    pixel_size_y: float
    image_size_x: int
    image_size_y: int
    _mu_cache: dict = PrivateAttr(default_factory=dict)

    def calculate_mu(self, wavelength: float) -> float:
        if wavelength not in self._mu_cache:
            self._mu_cache[wavelength] = calculate_mu_for_material_at_wavelength(
                self.material, wavelength
            )
        return self._mu_cache[wavelength]


class Eiger16M(DetectorParameters):
    detector_type: Literal["Eiger16M"] = "Eiger16M"
    thickness: float = 0.45
    material: Material = Material.Si
    pixel_size_x: float = 0.075
    pixel_size_y: float = 0.075
    image_size_x: int = 4148
    image_size_y: int = 4362


class Eiger4M(DetectorParameters):
    detector_type: Literal["Eiger4M"] = "Eiger4M"
    thickness: float = 0.45
    material: Material = Material.Si
    pixel_size_x: float = 0.075
    pixel_size_y: float = 0.075
    image_size_x: int = 2068
    image_size_y: int = 2162


class Eiger9MCdTe(DetectorParameters):
    detector_type: Literal["Eiger9MCdTe"] = "Eiger9MCdTe"
    thickness: float = 0.75
    material: Material = Material.CdTe
    pixel_size_x: float = 0.075
    pixel_size_y: float = 0.075
    image_size_x: int = 3108
    image_size_y: int = 3262


class DetectorGeometry(BaseModel):
    distance: float
    beam_center_x: float
    beam_center_y: float
    detector: Union[Eiger9MCdTe, Eiger16M, Eiger4M] = Field(
        ..., discriminator="detector_type"
    )

    def to_json(self) -> str:
        d = self.model_dump(exclude={"detector"})
        d.update(self.detector.model_dump())
        return json.dumps(d, indent=4)
