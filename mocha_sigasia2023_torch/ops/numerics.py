"""Gradient-safe primitives (counterpart of mocha_sigasia2023_tpu/ops/numerics.py:49-75).

Value-identical to the plain formulas on non-degenerate data; they keep
the forward finite at the sqrt-at-zero and 0/0 edges the JAX module
documents.  The optimizer-side guard of that module belongs to training
and is not ported here.
"""

from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor, tiny: float = 1e-24) -> torch.Tensor:
    """sqrt(max(x, tiny)): identical to ``torch.sqrt`` for ``x >= tiny``."""
    return torch.sqrt(torch.clamp_min(x, tiny))


def safe_unit_denom(c: torch.Tensor, tiny: float = 1e-12) -> torch.Tensor:
    """``sqrt(sum(c^2))`` over the last axis (kept), with degenerate rows
    (``sum(c^2) <= tiny``) redirected to 1."""
    ss = torch.sum(c * c, dim=-1, keepdim=True)
    return torch.sqrt(torch.where(ss > tiny, ss, torch.ones_like(ss)))
