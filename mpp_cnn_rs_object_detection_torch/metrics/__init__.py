"""Evaluation: rotated-polygon IoU, the DOTA devkit text format and AP."""
