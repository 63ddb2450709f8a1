"""Standalone tools: the FITS comparator and the compute probe."""
