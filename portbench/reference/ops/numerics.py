"""Gradient-safe primitives (counterpart of mocha_sigasia2023_tpu/ops/numerics.py).

Value-identical to the plain formulas on non-degenerate data; they keep
the forward finite at the sqrt-at-zero and 0/0 edges the JAX module
documents, and :func:`safe_clip_by_global_norm` keeps a non-finite
gradient from reaching the parameters.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def safe_sqrt(x: torch.Tensor, tiny: float = 1e-24) -> torch.Tensor:
    """sqrt(max(x, tiny)): identical to ``torch.sqrt`` for ``x >= tiny``."""
    return torch.sqrt(torch.clamp_min(x, tiny))


def safe_unit_denom(c: torch.Tensor, tiny: float = 1e-12) -> torch.Tensor:
    """``sqrt(sum(c^2))`` over the last axis (kept), with degenerate rows
    (``sum(c^2) <= tiny``) redirected to 1."""
    ss = torch.sum(c * c, dim=-1, keepdim=True)
    return torch.sqrt(torch.where(ss > tiny, ss, torch.ones_like(ss)))


def safe_clip_by_global_norm(grads: Sequence[torch.Tensor],
                             max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm`` over a list of gradients, surviving
    non-finite ones.  With a finite global norm it does what optax does:
    the gradients pass unchanged while ``g_norm < max_norm``, else each
    becomes ``(t / g_norm) * max_norm``.  When the norm is inf or NaN every
    gradient is zeroed; the optimizer still steps on the zeros (its moments
    and count advance), as the JAX package's chain does.  No value leaves
    the device."""
    g_norm = torch.sqrt(sum(torch.sum(torch.square(t)) for t in grads))
    finite = torch.isfinite(g_norm)
    trigger = g_norm < max_norm   # false for inf and NaN norms
    safe_norm = torch.where(finite, g_norm, torch.ones_like(g_norm))
    return [torch.where(
        finite,
        torch.where(trigger, t, (t / safe_norm.to(t.dtype)) * max_norm),
        torch.zeros_like(t)) for t in grads]
