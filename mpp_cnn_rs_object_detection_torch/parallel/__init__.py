"""Segments of the exact whole-scene chain (single device in this port)."""
