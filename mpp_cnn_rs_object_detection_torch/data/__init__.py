"""Synthetic scenes and datasets, and rectangle rasterisation."""
