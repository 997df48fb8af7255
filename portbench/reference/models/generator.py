"""MOCHA generator: ST-GCN motion embedding + context-matching transformer.

Counterpart of mocha_sigasia2023_tpu/models/generator.py
(``embed_tokens``, ``encode``, ``content_feature``, ``decode``,
``decode_stream``, ``forward``).  A generator cast to bf16
(``.to(torch.bfloat16)``) computes in bf16, as the JAX functions do with
bf16 parameters.  ``encode``, ``decode`` and ``forward`` take ``train``
and a ``torch.Generator`` for the training forwards (plain attention,
dropout at ``cfg.dropout``), split into streams where the JAX functions
split their ``key``.

    (B, 60, 24, 15) motion windows
      -> 1x1 conv -> joint ST-GCN (pool folded into the graph contraction,
         temporal conv + mean-pool folded into one stride-4 conv)
      -> body ST-GCN -> (B, 90, 256) tokens + learned positional embedding
      -> encoder transformer (self-attention)
      -> decoder transformer (AdaIN + IN-q/k cross-attention)
      -> head (joint 1x1 graph conv hoisted before the time repeat/unpool)
      -> (B, 60, 24, 15)

:class:`Generator` holds the parameters under the JAX pytree paths and the
graph tables as non-persistent buffers; the functions below take it as the
JAX functions take ``(params, cfg)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import graph
from .layers import (
    conv1x1, leaky_relu, mean_variance_norm, numpy_init_, split,
    stgcn_block, stgcn_params, temporal_conv, transformer,
    transformer_params,
)


class GeneratorConfig(NamedTuple):
    """Model hyperparameters (defaults are the shipped model)."""

    mot_in_dim: int = 15
    nframes: int = 60
    njoints: int = 24
    nbody: int = 6
    temporal_patch_size: int = 4
    encoder_dim: int = 256
    encoder_depth: int = 2
    encoder_heads: int = 4
    encoder_dim_head: int = 128
    encoder_mlp_dim: int = 512
    decoder_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 4
    decoder_dim_head: int = 256
    decoder_mlp_dim: int = 512
    dropout: float = 0.1
    layout: str = "mocha"
    joint_strategy: str = "distance"
    joint_max_hop: int = 2
    bodypart_strategy: str = "distance"
    bodypart_max_hop: int = 1

    @property
    def num_temp(self) -> int:
        return self.nframes // self.temporal_patch_size

    @property
    def num_tokens(self) -> int:
        return self.nbody * self.num_temp

    @staticmethod
    def from_dict(d) -> "GeneratorConfig":
        """The config file's ``model`` section -> GeneratorConfig."""
        g = d.get("graph", {})
        joint = g.get("joint", {})
        body = g.get("bodypart", {})
        base = GeneratorConfig()
        widths = base._fields[:base._fields.index("dropout")]
        return base._replace(
            **{k: d[k] for k in widths if k in d},
            layout=joint.get("layout", base.layout),
            joint_strategy=joint.get("strategy", base.joint_strategy),
            joint_max_hop=joint.get("max_hop", base.joint_max_hop),
            bodypart_strategy=body.get("strategy", base.bodypart_strategy),
            bodypart_max_hop=body.get("max_hop", base.bodypart_max_hop))


def _joint0_support(A_j: np.ndarray) -> np.ndarray:
    """The joints whose columns of the (K, V, V) joint adjacency reach
    joint 0: the only inputs of the graph conv's output at joint 0."""
    return np.nonzero(np.any(A_j[:, :, 0] != 0, axis=0))[0]


def _meanpool_taps(k: int, tps: int) -> np.ndarray:
    """(k + tps - 1, k) map from a temporal kernel to the kernel of the
    same conv followed by the kernel==stride==tps mean-pool."""
    Fm = np.zeros((k + tps - 1, k), np.float32)
    for i in range(tps):
        Fm[np.arange(k) + i, np.arange(k)] += 1.0 / tps
    return Fm


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        self.cfg = cfg
        A_j = torch.as_tensor(graph.joint_adjacency(
            cfg.layout, cfg.joint_strategy, cfg.joint_max_hop), dtype=torch.float32)
        A_b = torch.as_tensor(graph.bodypart_adjacency(
            cfg.layout, cfg.bodypart_strategy, cfg.bodypart_max_hop),
            dtype=torch.float32)
        pool = torch.as_tensor(graph.pool_matrix(cfg.layout))
        unpool = torch.as_tensor(graph.unpool_matrix(cfg.layout))
        K_j, K_b = A_j.shape[0], A_b.shape[0]
        e, d, tps = cfg.encoder_dim, cfg.decoder_dim, cfg.temporal_patch_size

        self.pos_emb = nn.Parameter(torch.zeros(1, cfg.num_tokens, e))
        self.embed = nn.ModuleDict({
            "conv_in": nn.Conv2d(cfg.mot_in_dim, e // tps, 1),
            "joint": stgcn_params(e // tps, e, K_j, 5),
            "body": stgcn_params(e, e, K_b, 3),
        })
        self.encoder = transformer_params(
            e, cfg.encoder_depth, cfg.encoder_heads, cfg.encoder_dim_head,
            cfg.encoder_mlp_dim, adain_on=False)
        self.decoder = transformer_params(
            d, cfg.decoder_depth, cfg.decoder_heads, cfg.decoder_dim_head,
            cfg.decoder_mlp_dim, adain_on=True)
        self.head = nn.ModuleDict({
            "body": stgcn_params(d, d, K_b, 3),
            "joint": stgcn_params(d, d // tps, K_j, 5),
            "conv_out": nn.Conv2d(d // tps, cfg.mot_in_dim, 1),
        })
        # graph tables (not parameters, not in the state dict)
        self.register_buffer("A_b", A_b, persistent=False)
        self.register_buffer(
            "AP", torch.einsum("kvw,wu->kvu", A_j, pool), persistent=False)
        self.register_buffer(
            "UA", torch.einsum("vw,kwu->kvu", unpool, A_j), persistent=False)
        self.register_buffer(
            "meanpool_taps", torch.as_tensor(_meanpool_taps(5, tps)),
            persistent=False)
        # decode_stream's: the joint graph, the unpool, joint 0's support
        self.register_buffer("A_j", A_j, persistent=False)
        self.register_buffer("unpool", unpool, persistent=False)
        self.register_buffer("joint0_support", torch.as_tensor(
            _joint0_support(A_j.numpy())), persistent=False)

    def forward(self, src_X, cha_X, **kw):
        """:func:`forward` of this generator (what ``torch.func.
        functional_call`` runs, e.g. on parameters cast to bf16)."""
        return forward(self, src_X, cha_X, **kw)


def init_generator(cfg: GeneratorConfig = GeneratorConfig(), seed: int = 0,
                   device=None) -> Generator:
    """A generator with random weights drawn from a NumPy seed."""
    dev = resolve_device(device)
    return numpy_init_(Generator(cfg), seed).requires_grad_(False).to(dev).eval()


def _tconv_meanpool(p, taps, x, tps: int):
    """Reflect-padded temporal conv followed by the kernel==stride==tps
    mean-pool, as ONE stride-tps conv with the averaged kernel."""
    w = p.weight                                   # (O, I, k, 1)
    k = int(w.shape[2])
    pad = (k - 1) // 2
    w2 = torch.einsum("oikv,mk->oimv", w, taps.to(w.dtype))
    x = F.pad(x.to(w.dtype), (0, 0, pad, pad), mode="reflect")
    return F.conv2d(x, w2, p.bias, stride=(tps, 1))


def embed_tokens(gen: Generator, x: torch.Tensor) -> torch.Tensor:
    """Motion window (B, T, V, C) -> tokens (B, num_temp*nbody, dim)."""
    cfg = gen.cfg
    h = x.permute(0, 3, 1, 2)                      # b t v c -> b c t v
    h = conv1x1(gen.embed["conv_in"], h)
    h = leaky_relu(h, 0.2)
    y = conv1x1(gen.embed["joint"]["gcn"], h)
    n, kc, t, v = y.shape
    K = gen.AP.shape[0]
    h = torch.einsum("nkctv,kvu->nctu", y.reshape(n, K, kc // K, t, v),
                     gen.AP)
    h = _tconv_meanpool(gen.embed["joint"]["tcn"], gen.meanpool_taps, h,
                        cfg.temporal_patch_size)
    h = stgcn_block(gen.embed["body"], h, gen.A_b)
    b, c, t, v = h.shape
    return h.permute(0, 2, 3, 1).reshape(b, t * v, c)


def encode(gen: Generator, x: torch.Tensor, *, generator=None,
           train=False) -> torch.Tensor:
    """Embedding + positional embedding + encoder transformer."""
    tokens = embed_tokens(gen, x)
    tokens = tokens + gen.pos_emb[:, : tokens.shape[1]]
    return transformer(gen.encoder, tokens, None, heads=gen.cfg.encoder_heads,
                       adain_on=False, drop=gen.cfg.dropout,
                       generator=generator, train=train)


def content_feature(encoded: torch.Tensor) -> torch.Tensor:
    """The 'cnt' context feature: per-channel instance norm over tokens."""
    return mean_variance_norm(encoded)


def _decode_trunk(gen: Generator, src_encoded, cha_encoded, *,
                  generator=None, train=False):
    """Decoder transformer + the head's body ST-GCN, before the time
    repeat and unpool: (B, C, num_temp, nbody)."""
    cfg = gen.cfg
    tok = transformer(gen.decoder, src_encoded, cha_encoded,
                      heads=cfg.decoder_heads, adain_on=True,
                      drop=cfg.dropout, generator=generator, train=train)
    b, s, c = tok.shape
    h = tok.reshape(b, cfg.num_temp, cfg.nbody, c).permute(0, 3, 1, 2)
    return stgcn_block(gen.head["body"], h, gen.A_b)


def decode(gen: Generator, src_encoded: torch.Tensor,
           cha_encoded: torch.Tensor, *, generator=None,
           train=False) -> torch.Tensor:
    """Decoder transformer + inverse embedding -> (B, T, V, 15) motion, with
    the joint head's lrelu + 1x1 graph conv hoisted before the time repeat
    and the unpool folded into the adjacency contraction."""
    cfg = gen.cfg
    if generator is not None:
        generator = split(generator, 2)[1]
    h = _decode_trunk(gen, src_encoded, cha_encoded, generator=generator,
                      train=train)
    p_j = gen.head["joint"]
    g = conv1x1(p_j["gcn"], leaky_relu(h, 0.2))   # (B, K*C', num_temp, 6)
    n, kc, t, v = g.shape
    K = gen.UA.shape[0]
    h = torch.einsum("nkctv,kvu->nctu", g.reshape(n, K, kc // K, t, v),
                     gen.UA)                      # (B, C', num_temp, 24)
    h = torch.repeat_interleave(h, cfg.temporal_patch_size, dim=2)
    h = temporal_conv(p_j["tcn"], h)
    h = leaky_relu(h, 0.2)
    h = conv1x1(gen.head["conv_out"], h)
    return h.permute(0, 2, 3, 1)                  # b c t v -> b t v c


def decode_stream(gen: Generator, src_encoded: torch.Tensor,
                  cha_encoded: torch.Tensor):
    """The decoder restricted to what the stream step reads: the last
    frame's pose (all joints, all 15 channels) and joint 0's velocity
    channels over the whole window (the hip-speed guard).  Both tails of
    the joint head are sliced with the same math: the reflect-padded
    temporal conv at frame T-1 reads frames T-1-pad..T-1 only, and joint
    0's graph conv reads only its adjacency support.  Returns
    (last (B, njoints, 15), joint-0 velocity (B, T, 3)), both still
    normalized."""
    cfg = gen.cfg
    h = torch.repeat_interleave(_decode_trunk(gen, src_encoded, cha_encoded),
                                cfg.temporal_patch_size, dim=2)
    u = torch.einsum("nctv,vw->nctw", h, gen.unpool.to(h.dtype))
    T = u.shape[2]
    p_j = gen.head["joint"]
    co = gen.head["conv_out"]
    w_t = p_j["tcn"].weight                       # (O, I, k, 1)
    k_t = int(w_t.shape[2])
    # the reflect taps below assume symmetric same-padding (an odd kernel)
    if k_t % 2 != 1:
        raise ValueError(f"decode_stream needs an odd t-kernel, got {k_t}")
    pad = (k_t - 1) // 2
    A_j = gen.A_j
    K = A_j.shape[0]

    def gcn(x):
        y = conv1x1(p_j["gcn"], x)
        n, kc, tt, v = y.shape
        return y.reshape(n, K, kc // K, tt, v)

    # last-frame pose: the conv window at T-1 is reflect{T-1-pad..T-1};
    # tap j reads slice-relative frame pad - |pad - j| (k=5: 0,1,2,1,0)
    lf = leaky_relu(u[:, :, T - 1 - pad:, :], 0.2)
    g = torch.einsum("nkctv,kvw->nctw", gcn(lf), A_j.to(lf.dtype))
    pose = sum(torch.einsum("niv,oi->nov", g[:, :, pad - abs(pad - j), :],
                            w_t[:, :, j, 0].to(g.dtype))
               for j in range(k_t))
    pose = leaky_relu(pose + p_j["tcn"].bias[None, :, None], 0.2)
    pose = (torch.einsum("niv,oi->nov", pose, co.weight[:, :, 0, 0])
            + co.bias[None, :, None])
    last = pose.permute(0, 2, 1)                  # (B, V, 15)

    # hip-velocity track: joint 0 over all frames
    jsub = gen.joint0_support
    su = leaky_relu(u[:, :, :, jsub], 0.2)
    g0 = torch.einsum("nkctv,kv->nct", gcn(su),
                      A_j[:, jsub, 0].to(su.dtype))   # (B, C, T)
    v0 = leaky_relu(temporal_conv(p_j["tcn"], g0[..., None])[..., 0], 0.2)
    vel0 = (torch.einsum("nct,oc->not", v0, co.weight[9:12, :, 0, 0])
            + co.bias[9:12][None, :, None])
    return last, vel0.permute(0, 2, 1)            # (B, T, 3)


def forward(gen: Generator, src_X, cha_X, *, extract_feature: bool = False,
            generator=None, train=False):
    """Full generator forward."""
    g = [None] * 3 if generator is None else split(generator, 4)[1:]
    src_encoded = encode(gen, src_X, generator=g[0], train=train)
    cha_encoded = encode(gen, cha_X, generator=g[1], train=train)
    if extract_feature:
        return (src_encoded, cha_encoded,
                content_feature(src_encoded), content_feature(cha_encoded))
    return decode(gen, src_encoded, cha_encoded, generator=g[2], train=train)
