"""Streaming engine (dense windows)."""
