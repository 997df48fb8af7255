"""Transformer CVAE: autoregressive character-feature predictor.

Counterpart of mocha_sigasia2023_tpu/models/cvae.py:28-284 (``mha``, the
post-norm encoder/decoder layers, the sincos positions, ``prior``,
``posterior``, ``reparameterize``, ``decode``, ``forward``, ``sample``).
Its attention is plain PyTorch, as it is XLA in the JAX package, so the
training forward differentiates on every device.

Training forwards (``train=True``) drop out the attention weights, each
residual branch, the ReLU output and the position-encoded inputs where a
``torch.Generator`` is given (in place of the JAX ``key``), each stream
derived by :func:`layers.split`; they keep every query row of the last
encoder layer.  Serving (``train=False``) reads the mu/logvar tokens off
two query rows and never drops out.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import draw, dropout, layer_norm, linear, numpy_init_, split


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

    def forward(self, x, c, generator=None, train=False):
        """The training forward (module-level :func:`forward`), so that
        ``torch.func.functional_call`` can run it on cast parameters."""
        return forward(self, x, c, generator=generator, train=train)


def init_cvae(cfg: CVAEConfig = CVAEConfig(), seed: int = 0,
              device=None, trainable: bool = False) -> CVAE:
    """A CVAE with random weights drawn from a NumPy seed: frozen for
    serving, or with ``trainable`` requiring gradients."""
    cvae = numpy_init_(CVAE(cfg), seed).to(resolve_device(device))
    if trainable:
        return cvae.train()
    return cvae.requires_grad_(False).eval()


def _streams(generator, n):
    """``n`` generators split from ``generator``, or ``n`` Nones."""
    return split(generator, n) if generator is not None else [None] * n


def mha(p: MHAParams, query, kv, *, nheads, drop=0.0, generator=None,
        train=False):
    """torch-compatible multi-head attention with the packed in_proj (one
    matmul for self-attention, a packed kv matmul for cross-attention);
    in training, dropout on the attention weights."""
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
    attn = dropout(attn, drop, generator, train)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    out = out.transpose(1, 2).reshape(b, n, d)
    return linear(p.out_proj, out)


def encoder_layer(p, x, *, nheads, drop=0.0, generator=None, train=False,
                  out_tokens: Optional[int] = None):
    """Post-norm TransformerEncoderLayer (relu).  ``out_tokens=n`` computes
    the first n tokens only (keys/values over the whole sequence) — the
    same values as slicing the full layer's output."""
    g_attn, g_sa, g_relu, g_ff = _streams(generator, 4)
    q_in = x if out_tokens is None else x[:, :out_tokens]
    sa = mha(p["self_attn"], q_in, x, nheads=nheads, drop=drop,
             generator=g_attn, train=train)
    x = layer_norm(p["norm1"], q_in + dropout(sa, drop, g_sa, train))
    h = dropout(torch.relu(linear(p["linear1"], x)), drop, g_relu, train)
    h = linear(p["linear2"], h)
    return layer_norm(p["norm2"], x + dropout(h, drop, g_ff, train))


def decoder_layer(p, tgt, memory, *, nheads, drop=0.0, generator=None,
                  train=False):
    """Post-norm TransformerDecoderLayer (relu)."""
    g_sa_attn, g_sa, g_ca_attn, g_ca, g_relu, g_ff = _streams(generator, 6)
    sa = mha(p["self_attn"], tgt, tgt, nheads=nheads, drop=drop,
             generator=g_sa_attn, train=train)
    tgt = layer_norm(p["norm1"], tgt + dropout(sa, drop, g_sa, train))
    ca = mha(p["multihead_attn"], tgt, memory, nheads=nheads, drop=drop,
             generator=g_ca_attn, train=train)
    tgt = layer_norm(p["norm2"], tgt + dropout(ca, drop, g_ca, train))
    h = dropout(torch.relu(linear(p["linear1"], tgt)), drop, g_relu, train)
    h = linear(p["linear2"], h)
    return layer_norm(p["norm3"], tgt + dropout(h, drop, g_ff, train))


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


def _encode_tokens(p: TokenEncoder, tokens, cfg: CVAEConfig, *,
                   generator=None, train=False):
    x = tokens + _pe(tokens.shape[1], cfg.latent_dim, tokens)
    n_layers = len(p.layers)
    g_in, *g_layers = _streams(generator, n_layers + 1)
    x = dropout(x, cfg.dropout, g_in, train)
    for i, (layer, g) in enumerate(zip(p.layers, g_layers)):
        # only the mu/logvar tokens are read downstream: in serving the
        # last layer needs 2 query rows; training keeps them all, as the
        # JAX package does (its dropout masks take the full shapes)
        out_tokens = 2 if (i == n_layers - 1 and not train) else None
        x = encoder_layer(layer, x, nheads=cfg.nheads, drop=cfg.dropout,
                          generator=g, train=train, out_tokens=out_tokens)
    return x[:, 0], x[:, 1]


def _with_tokens(p: TokenEncoder, cfg: CVAEConfig, *rest):
    b = rest[0].shape[0]
    mu_tok = p.mu_token.expand(b, 1, cfg.latent_dim)
    lv_tok = p.logvar_token.expand(b, 1, cfg.latent_dim)
    return torch.cat([mu_tok, lv_tok, *rest], dim=1)


def prior(cvae: CVAE, c, *, generator=None, train=False):
    """p(z | c) -> (mu, logvar)."""
    return _encode_tokens(cvae.prior, _with_tokens(cvae.prior, cvae.cfg, c),
                          cvae.cfg, generator=generator, train=train)


def posterior(cvae: CVAE, x, c, *, generator=None, train=False):
    """q(z | x, c) -> (mu, logvar): the tokens [mu; logvar; c; x]."""
    return _encode_tokens(cvae.posterior,
                          _with_tokens(cvae.posterior, cvae.cfg, c, x),
                          cvae.cfg, generator=generator, train=train)


def reparameterize(generator: torch.Generator, mu, logvar):
    """mu + N(0, 1) * exp(logvar / 2), the noise drawn from ``generator``
    (on ``mu``'s device)."""
    if generator is None:
        raise ValueError("reparameterize: pass a torch.Generator for the "
                         "noise")
    std = torch.exp(0.5 * logvar)
    noise = draw(torch.randn, std.shape, generator, std.device, std.dtype)
    return mu + noise * std


def decode(cvae: CVAE, z, c, *, generator=None, train=False):
    """Zero queries + sincos positions cross-attending to [z; c]."""
    cfg = cvae.cfg
    b, _, d = c.shape
    memory = torch.cat([z[:, None, :], c], dim=1)
    g_in, *g_layers = _streams(generator, cfg.depth + 1)
    x = _pe(cfg.output_seq, d, c).expand(b, cfg.output_seq, d)
    x = dropout(x, cfg.dropout, g_in, train)
    for layer, g in zip(cvae.decoder["layers"], g_layers):
        x = decoder_layer(layer, x, memory, nheads=cfg.nheads,
                          drop=cfg.dropout, generator=g, train=train)
    return x


def forward(cvae: CVAE, x, c, *, generator: torch.Generator, train=False):
    """Training forward: posterior sample -> decode.  Returns (out,
    (mu_po, logvar_po), (mu_pr, logvar_pr)).  ``generator`` gives the
    reparameterization noise and, in training, the dropout masks."""
    g_po, g_pr, g_rp, g_de = split(generator, 4)
    mu_po, logvar_po = posterior(cvae, x, c, generator=g_po, train=train)
    mu_pr, logvar_pr = prior(cvae, c, generator=g_pr, train=train)
    z = reparameterize(g_rp, mu_po, logvar_po)
    out = decode(cvae, z, c, generator=g_de, train=train)
    return out, (mu_po, logvar_po), (mu_pr, logvar_pr)


def sample(cvae: CVAE, c, *, deterministic: bool = False,
           generator: Optional[torch.Generator] = None):
    """Prior -> decode.  ``deterministic`` takes z = mu; otherwise the
    noise is drawn from ``generator`` (required), for every stream of the
    batch under ``layers.batch_shard``."""
    mu, logvar = prior(cvae, c)
    if deterministic:
        z = mu
    else:
        if generator is None:
            raise ValueError("sample: pass a torch.Generator for the noise "
                             "or deterministic=True")
        noise = draw(torch.randn, mu.shape, generator, mu.device, mu.dtype)
        z = mu + noise * torch.exp(0.5 * logvar)
    return decode(cvae, z, c)
