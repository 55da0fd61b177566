"""Synthetic streams and host->device ingest."""
