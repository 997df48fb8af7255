"""Synthetic clips, windowing, clip featurization and window features."""

from . import dataset, preprocess, synthetic, windows
