"""Beamline service layer on PyTorch: per-image analysis, SSX indexing."""
