"""Random weights made on the device from a seed, in a few large draws.

The distributions are the port's and the JAX package's initializers
(``numpy_init_``): U(+-1/sqrt(fan_in)) for Linear and Conv weights and
biases, ones and zeros for LayerNorm, xavier-uniform ``in_proj`` weights
with zero biases, N(0, 1) for embeddings and learned tokens.  Every uniform
leaf is a slice of one ``torch.rand`` draw and every normal leaf a slice of
one ``torch.randn`` draw, both from a ``torch.Generator`` on the module's
device, so the program's modules and the reference's (which have the same
parameter names and shapes) get the same values from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .seeds import subseed

_NORMAL = ("pos_emb", "mu_token", "logvar_token")


def _plan(module: nn.Module):
    """[(name, parameter, kind, bound)] with kind in uniform / normal /
    ones / zeros."""
    plan = []
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        if leaf in _NORMAL:
            plan.append((name, p, "normal", 1.0))
        elif leaf == "in_proj_weight":
            bound = math.sqrt(6.0 / (p.shape[0] // 3 + p.shape[1]))
            plan.append((name, p, "uniform", bound))
        elif leaf == "in_proj_bias":
            plan.append((name, p, "zeros", 0.0))
        elif leaf == "weight" and p.dim() == 1:
            plan.append((name, p, "ones", 1.0))
        elif leaf in ("weight", "bias"):
            w = module.get_submodule(owner_name).weight
            if w.dim() == 1:
                plan.append((name, p, "zeros", 0.0))
            else:
                fan_in = math.prod(w.shape[1:])
                plan.append((name, p, "uniform", 1.0 / math.sqrt(fan_in)))
        else:
            raise ValueError(f"no initializer for parameter {name!r}")
    return plan


@torch.no_grad()
def fill_(module: nn.Module, seed: int, tag: str) -> nn.Module:
    """Overwrite every parameter of ``module`` from (``seed``, ``tag``)."""
    plan = _plan(module)
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(subseed(seed, tag))
    sizes = {k: sum(p.numel() for _, p, kind, _ in plan if kind == k)
             for k in ("uniform", "normal")}
    draws = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=dev),
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=dev)}
    offset = {"uniform": 0, "normal": 0}
    for _, p, kind, bound in plan:
        if kind in ("ones", "zeros"):
            p.fill_(1.0 if kind == "ones" else 0.0)
            continue
        n = p.numel()
        block = draws[kind][offset[kind]:offset[kind] + n].view(p.shape)
        offset[kind] += n
        p.copy_(block * (2.0 * bound) - bound if kind == "uniform" else block)
    return module


def same_layout(a: nn.Module, b: nn.Module) -> None:
    """Raise unless ``a`` and ``b`` have the same parameter names and
    shapes in the same order (so :func:`fill_` gives them equal values)."""
    la = [(n, tuple(p.shape)) for n, p in a.named_parameters()]
    lb = [(n, tuple(p.shape)) for n, p in b.named_parameters()]
    if la != lb:
        diff = [x for x, y in zip(la, lb) if x != y][:4]
        raise ValueError(f"parameter layouts differ ({len(la)} against "
                         f"{len(lb)} leaves; first differences {diff})")
