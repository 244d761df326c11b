"""Synthetic scenes for checks and smoke runs (the dataset layer is not
ported yet)."""
