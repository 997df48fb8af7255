"""Visualization: matplotlib 3D stick-figure animation (host only)."""

from .plot import animation_plot
