"""Load JAX-package parameter pytrees into the port's modules.

The JAX pytrees already use torch layouts (Linear (out, in), Conv2d
(O, I, kh, kw)) and the port's modules use the pytree paths as parameter
names, so carrying weights across is a flatten to dotted keys and a strict
``load_state_dict``.  The pytrees come as nested dicts/lists of NumPy
arrays (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from .cvae import CVAE, CVAEConfig
from .generator import Generator, GeneratorConfig


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_pytree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _load(module: torch.nn.Module, params_np, device):
    state = {k: torch.as_tensor(np.array(v, np.float32))
             for k, v in flatten_pytree(params_np).items()}
    module.load_state_dict(state, strict=True)
    return module.requires_grad_(False).to(resolve_device(device)).eval()


def generator_from_jax(params_np, cfg: GeneratorConfig = GeneratorConfig(),
                       device=None) -> Generator:
    """The port's Generator holding the JAX generator's weights."""
    return _load(Generator(cfg), params_np, device)


def cvae_from_jax(params_np, cfg: CVAEConfig = CVAEConfig(),
                  device=None) -> CVAE:
    """The port's CVAE holding the JAX CVAE's weights."""
    return _load(CVAE(cfg), params_np, device)
