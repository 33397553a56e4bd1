"""Experimental models: beam, detector, goniometer, scan, crystal, tables.

NumPy host-side equivalents of the dx2 model classes the reference links
against (reference: SURVEY.md L0; used throughout e.g.
baseline/indexer/indexer.cc:11-19).  Device code receives plain arrays.
"""

from .geometry import (  # noqa: F401
    MonochromaticBeam,
    Panel,
    Scan,
    Goniometer,
    simple_panel,
)
