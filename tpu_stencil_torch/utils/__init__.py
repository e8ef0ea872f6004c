"""Utilities: compute-window timing."""
