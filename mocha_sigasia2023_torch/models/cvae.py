"""Transformer CVAE: autoregressive character-feature predictor (inference).

Counterpart of mocha_sigasia2023_tpu/models/cvae.py:28-284 (``mha``, the
post-norm encoder/decoder layers, the sincos positions, ``prior``,
``decode``, ``sample``).  Its attention is plain PyTorch, as it is XLA in
the JAX package.  The posterior's parameters are held so the JAX pytree
loads whole; serving does not call it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import layer_norm, linear, numpy_init_


class CVAEConfig(NamedTuple):
    output_seq: int = 90
    latent_dim: int = 256
    depth: int = 2
    nheads: int = 4
    feedforward_dim: int = 512
    dropout: float = 0.1


class MHAParams(nn.Module):
    """torch-MultiheadAttention-shaped parameters (packed in_proj)."""

    def __init__(self, dim):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


def _encoder_layer_params(dim, ff_dim) -> nn.ModuleDict:
    return nn.ModuleDict({
        "self_attn": MHAParams(dim),
        "linear1": nn.Linear(dim, ff_dim),
        "linear2": nn.Linear(ff_dim, dim),
        "norm1": nn.LayerNorm(dim), "norm2": nn.LayerNorm(dim),
    })


def _decoder_layer_params(dim, ff_dim) -> nn.ModuleDict:
    return nn.ModuleDict({
        "self_attn": MHAParams(dim),
        "multihead_attn": MHAParams(dim),
        "linear1": nn.Linear(dim, ff_dim),
        "linear2": nn.Linear(ff_dim, dim),
        "norm1": nn.LayerNorm(dim), "norm2": nn.LayerNorm(dim),
        "norm3": nn.LayerNorm(dim),
    })


class TokenEncoder(nn.Module):
    """Prior/posterior: learned mu/logvar tokens + post-norm encoder."""

    def __init__(self, dim, ff_dim, depth):
        super().__init__()
        self.mu_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.logvar_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.layers = nn.ModuleList(
            [_encoder_layer_params(dim, ff_dim) for _ in range(depth)])


class CVAE(nn.Module):
    def __init__(self, cfg: CVAEConfig = CVAEConfig()):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.latent_dim, cfg.feedforward_dim
        self.prior = TokenEncoder(d, ff, cfg.depth)
        self.posterior = TokenEncoder(d, ff, cfg.depth)
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            [_decoder_layer_params(d, ff) for _ in range(cfg.depth)])})


def init_cvae(cfg: CVAEConfig = CVAEConfig(), seed: int = 0,
              device=None) -> CVAE:
    """A CVAE with random weights drawn from a NumPy seed."""
    dev = resolve_device(device)
    return numpy_init_(CVAE(cfg), seed).requires_grad_(False).to(dev).eval()


def mha(p: MHAParams, query, kv, *, nheads):
    """torch-compatible multi-head attention with the packed in_proj (one
    matmul for self-attention, a packed kv matmul for cross-attention)."""
    d = query.shape[-1]
    if query is kv:
        qkv = query @ p.in_proj_weight.T + p.in_proj_bias
        q, k, v = torch.split(qkv, d, dim=-1)
    else:
        q = query @ p.in_proj_weight[:d].T + p.in_proj_bias[:d]
        kv_p = kv @ p.in_proj_weight[d:].T + p.in_proj_bias[d:]
        k, v = torch.split(kv_p, d, dim=-1)

    b, n, _ = q.shape
    dh = d // nheads

    def split(t_):
        return t_.reshape(b, t_.shape[1], nheads, dh).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    attn = torch.softmax(
        torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(dh), dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    out = out.transpose(1, 2).reshape(b, n, d)
    return linear(p.out_proj, out)


def encoder_layer(p, x, *, nheads, out_tokens: Optional[int] = None):
    """Post-norm TransformerEncoderLayer (relu).  ``out_tokens=n`` computes
    the first n tokens only (keys/values over the whole sequence) — the
    same values as slicing the full layer's output."""
    q_in = x if out_tokens is None else x[:, :out_tokens]
    sa = mha(p["self_attn"], q_in, x, nheads=nheads)
    x = layer_norm(p["norm1"], q_in + sa)
    h = linear(p["linear2"], torch.relu(linear(p["linear1"], x)))
    return layer_norm(p["norm2"], x + h)


def decoder_layer(p, tgt, memory, *, nheads):
    """Post-norm TransformerDecoderLayer (relu)."""
    sa = mha(p["self_attn"], tgt, tgt, nheads=nheads)
    tgt = layer_norm(p["norm1"], tgt + sa)
    ca = mha(p["multihead_attn"], tgt, memory, nheads=nheads)
    tgt = layer_norm(p["norm2"], tgt + ca)
    h = linear(p["linear2"], torch.relu(linear(p["linear1"], tgt)))
    return layer_norm(p["norm3"], tgt + h)


def sincos_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Fixed sin/cos table, computed in f32 like the torch reference."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp((np.arange(0, d_model, 2)
                  * (-np.log(10000.0) / d_model)).astype(np.float32))
    pe = np.zeros((1, max_len, d_model), dtype=np.float32)
    pe[0, :, 0::2] = np.sin(position * div)
    pe[0, :, 1::2] = np.cos(position * div)
    return pe


@functools.lru_cache(maxsize=None)
def _pe_cached(n, d, dtype, device):
    return torch.as_tensor(sincos_positional_encoding(n, d)).to(
        dtype=dtype, device=device)


def _pe(n, d, like):
    """The sincos table on ``like``'s device, built once per shape (the
    stream step calls this every frame)."""
    return _pe_cached(n, d, like.dtype, like.device)


def _encode_tokens(p: TokenEncoder, tokens, cfg: CVAEConfig):
    x = tokens + _pe(tokens.shape[1], cfg.latent_dim, tokens)
    n_layers = len(p.layers)
    for i, layer in enumerate(p.layers):
        # only the mu/logvar tokens are read downstream: the last layer
        # needs 2 query rows
        out_tokens = 2 if i == n_layers - 1 else None
        x = encoder_layer(layer, x, nheads=cfg.nheads, out_tokens=out_tokens)
    return x[:, 0], x[:, 1]


def prior(cvae: CVAE, c):
    """p(z | c) -> (mu, logvar)."""
    p, cfg = cvae.prior, cvae.cfg
    b = c.shape[0]
    mu_tok = p.mu_token.expand(b, 1, cfg.latent_dim)
    lv_tok = p.logvar_token.expand(b, 1, cfg.latent_dim)
    return _encode_tokens(p, torch.cat([mu_tok, lv_tok, c], dim=1), cfg)


def decode(cvae: CVAE, z, c):
    """Zero queries + sincos positions cross-attending to [z; c]."""
    cfg = cvae.cfg
    b, _, d = c.shape
    memory = torch.cat([z[:, None, :], c], dim=1)
    x = _pe(cfg.output_seq, d, c).expand(b, cfg.output_seq, d)
    for layer in cvae.decoder["layers"]:
        x = decoder_layer(layer, x, memory, nheads=cfg.nheads)
    return x


def sample(cvae: CVAE, c, *, deterministic: bool = False,
           generator: Optional[torch.Generator] = None):
    """Prior -> decode.  ``deterministic`` takes z = mu; otherwise the
    noise is drawn from ``generator`` (required)."""
    mu, logvar = prior(cvae, c)
    if deterministic:
        z = mu
    else:
        if generator is None:
            raise ValueError("sample: pass a torch.Generator for the noise "
                             "or deterministic=True")
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype)
        z = mu + noise * torch.exp(0.5 * logvar)
    return decode(cvae, z, c)
