"""3x3 rotation-matrix ops and FK, used inside the differentiable losses.

Counterpart of mocha_sigasia2023_tpu/kinematics/xform.py.  Matrices are
(..., 3, 3) with rows on axis -2.  FK accumulates each joint's product
along its static root-to-joint chain (gathers only, no in-place writes),
as the JAX package does inside its losses.
"""

from __future__ import annotations

import torch

from ..ops.numerics import safe_unit_denom
from .quat import _as_parents_key, _cross, ancestor_chains, index


def mul(x, y):
    """x @ y for (..., 3, 3) stacks."""
    return torch.sum(x[..., :, :, None] * y[..., None, :, :], dim=-2)


def mul_vec(x, v):
    """x @ v for (..., 3, 3) x (..., 3)."""
    return torch.sum(x * v[..., None, :], dim=-1)


def inv_mul(x, y):
    """x^T @ y (the inverse of a rotation is its transpose)."""
    return torch.sum(x[..., :, :, None] * y[..., :, None, :], dim=-3)


def inv_mul_vec(x, v):
    """x^T @ v."""
    return torch.sum(x * v[..., :, None], dim=-2)


def from_xy(xy):
    """The two-column 6D form (..., 3, 2) -> full 3x3 by Gram-Schmidt and
    cross products; parallel or tiny columns give a finite rotation."""
    c0 = xy[..., 0]
    c2 = _cross(c0, xy[..., 1])
    c2 = c2 / safe_unit_denom(c2)
    c1 = _cross(c2, c0)
    c1 = c1 / safe_unit_denom(c1)
    return torch.stack([c0, c1, c2], dim=-1)


def fk_vel(lrot, lpos, lvel, lang, parents):
    """Matrix-form FK with velocity propagation over ancestor chains.
    lrot (..., J, 3, 3); lpos, lvel, lang (..., J, 3)."""
    anc = ancestor_chains(_as_parents_key(parents))
    ident = torch.eye(3, dtype=lrot.dtype, device=lrot.device).expand(
        lrot.shape[:-3] + (1, 3, 3))
    zero3 = lpos.new_zeros(lpos.shape[:-2] + (1, 3))
    lrotp = torch.cat([lrot, ident], dim=-3)
    lposp = torch.cat([lpos, zero3], dim=-2)
    lvelp = torch.cat([lvel, zero3], dim=-2)
    langp = torch.cat([lang, zero3], dim=-2)

    col = index(anc[:, 0], lrot.device)
    gr, gp = lrotp[..., col, :, :], lposp[..., col, :]
    gv, ga = lvelp[..., col, :], langp[..., col, :]
    for d in range(1, anc.shape[1]):
        col = index(anc[:, d], lrot.device)
        rp = mul_vec(gr, lposp[..., col, :])
        gv = gv + mul_vec(gr, lvelp[..., col, :]) + torch.cross(ga, rp, dim=-1)
        ga = ga + mul_vec(gr, langp[..., col, :])
        gp = gp + rp
        gr = mul(gr, lrotp[..., col, :, :])
    return gr, gp, gv, ga
