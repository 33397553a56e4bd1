"""Data ingestion: NeXus/HDF5, CBF, shared-memory readers and sample data."""
