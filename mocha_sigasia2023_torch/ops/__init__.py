"""Numerics guards and the hand-written CUDA kernels."""

from . import attention, numerics
