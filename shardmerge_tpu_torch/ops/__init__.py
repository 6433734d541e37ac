"""Spectral merge numerics, order statistics and profiling."""
