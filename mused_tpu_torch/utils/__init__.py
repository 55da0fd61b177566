"""Profiling spans and JAX-state conversion."""
