"""Patch-sampling projection head for PatchNCE.

Counterpart of mocha_sigasia2023_tpu/models/projector.py.  Mode 'all' (the
one training uses) treats each token as a patch; a permutation selects
``num_patches`` of them (all when -1) and an MLP projects them to
``prj_dim``.  The selection takes an explicit index tensor or a
``torch.Generator`` in place of the JAX key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.numerics import safe_sqrt
from .layers import linear, numpy_init_


class ProjectorConfig(NamedTuple):
    mode: str = "all"
    num_patches: int = -1
    encoder_dim: int = 256
    prj_dim: int = 1024
    nframes: int = 60
    temporal_patch_size: int = 4
    nbody: int = 6
    hidden: int = 1024

    @property
    def m_dim(self) -> int:
        num_temp = self.nframes // self.temporal_patch_size
        return {"spatial": num_temp, "temp": self.nbody, "all": 1,
                "style": 2, "no_patches": num_temp * self.nbody}[self.mode]


class Projector(nn.Module):
    """The projector's two linear layers, under the JAX pytree paths."""

    def __init__(self, cfg: ProjectorConfig = ProjectorConfig()):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.m_dim * cfg.encoder_dim, cfg.hidden)
        self.fc2 = nn.Linear(cfg.hidden, cfg.prj_dim)


def init_projector(cfg: ProjectorConfig = ProjectorConfig(), seed: int = 0,
                   device=None) -> Projector:
    """A projector with random weights drawn from a NumPy seed (trainable:
    it exists only for training)."""
    return numpy_init_(Projector(cfg), seed).to(resolve_device(device))


def sample_patches(cfg: ProjectorConfig, feat: torch.Tensor,
                   patch_id: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Group tokens (B, S, C) into patches and select a subset."""
    b, s, c = feat.shape
    if cfg.mode in ("spatial", "temp", "all"):
        feat = feat.reshape(b, -1, cfg.m_dim * c)
        n = feat.shape[1]
        if patch_id is None:
            if generator is None:
                patch_id = torch.arange(n, device=feat.device)
            else:
                patch_id = torch.randperm(
                    n, generator=generator,
                    device=generator.device).to(feat.device)
            if cfg.num_patches != -1:
                patch_id = patch_id[: min(cfg.num_patches, n)]
        return feat[:, patch_id, :].reshape(-1, cfg.m_dim * c), patch_id
    if cfg.mode == "style":
        n = feat.shape[1]
        mean = feat.mean(dim=1)
        # the variance of the centered tokens, as jnp.var takes it (and
        # layers.mean_variance_norm): then its gradient sums to zero over
        # the tokens up to rounding, as the exact one does
        centered = feat - mean[:, None]
        var = centered.var(dim=1, correction=0) * (n / max(n - 1, 1))
        # safe_sqrt: a dead channel (var == 0) must not give inf grads
        return torch.cat([safe_sqrt(var), mean], dim=1), None
    return feat.reshape(b, cfg.m_dim * c), None


def apply_projector(prj: Projector, cfg: ProjectorConfig, feat: torch.Tensor,
                    patch_id: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Sampled patches through fc1 -> ReLU -> fc2; returns (projected,
    patch ids)."""
    sampled, patch_id = sample_patches(cfg, feat, patch_id, generator)
    return linear(prj.fc2, F.relu(linear(prj.fc1, sampled))), patch_id
