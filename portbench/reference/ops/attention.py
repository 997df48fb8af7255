"""Attention by the plain formula.

Copied from the port's ``ops/attention.attention_reference``; the port's
``fused_attention`` (its CUDA kernels) has no counterpart here: serving
calls the same plain formula that training takes.
"""

from __future__ import annotations

import torch


def attention_reference(q, k, v, scale: float, weights_fn=None):
    """softmax(q k^T * scale) v in the inputs' dtype (float32 here).
    ``weights_fn``, when given, maps the softmax weights before the product
    with v (training's dropout)."""
    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale,
                         dim=-1)
    if weights_fn is not None:
        attn = weights_fn(attn)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)
