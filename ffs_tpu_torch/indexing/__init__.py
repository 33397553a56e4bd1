"""Indexing: FFT rotation indexer and serial-crystallography indexer."""
