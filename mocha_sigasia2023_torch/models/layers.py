"""Building blocks of the generator (PyTorch).

Counterpart of mocha_sigasia2023_tpu/models/layers.py.  Parameters live in
``nn.Module`` containers whose paths are the JAX pytree paths (``to_q``,
``layers.0.ff.w1``, ...) with torch layouts (Linear (out, in), Conv2d
(O, I, kh, kw)), so JAX weights load with a flatten.  The apply functions
take those containers and tensors, as the JAX functions take param dicts.
Inference only: there is no dropout path.  As in the JAX package, the
convolutions cast their input to the weight's dtype, so bf16 weights
compute in bf16; the attention product then launches the bf16 kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..ops.numerics import safe_sqrt


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------


def stgcn_params(in_ch, out_ch, K, t_kernel) -> nn.ModuleDict:
    return nn.ModuleDict({
        "gcn": nn.Conv2d(in_ch, out_ch * K, 1),
        "tcn": nn.Conv2d(out_ch, out_ch, (t_kernel, 1)),
    })


def attention_params(dim, heads, dim_head) -> nn.ModuleDict:
    inner = heads * dim_head
    p = nn.ModuleDict({
        "to_q": nn.Linear(dim, inner, bias=False),
        "to_k": nn.Linear(dim, inner, bias=False),
        "to_v": nn.Linear(dim, inner, bias=False),
    })
    if not (heads == 1 and dim_head == dim):
        p["to_out"] = nn.Linear(inner, dim)
    return p


def transformer_params(dim, depth, heads, dim_head, mlp_dim,
                       adain_on) -> nn.ModuleDict:
    layers = nn.ModuleList()
    for _ in range(depth):
        layer = nn.ModuleDict({
            "attn": attention_params(dim, heads, dim_head),
            "ff": nn.ModuleDict({"w1": nn.Linear(dim, mlp_dim),
                                 "w2": nn.Linear(mlp_dim, dim)}),
        })
        if adain_on:
            layer["adain"] = nn.ModuleDict({
                "fc1": nn.Linear(dim, dim * 2),
                "fc2": nn.Linear(dim * 2, dim * 2)})
        layers.append(layer)
    return nn.ModuleDict({"layers": layers})


def numpy_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a NumPy seed, in the JAX initializers'
    distributions: U(+-1/sqrt(fan_in)) for Linear/Conv weights and biases,
    ones/zeros for LayerNorm, xavier-uniform in_proj weights with zero
    biases, N(0, 1) for embeddings and learned tokens.  The same seed gives
    the same weights on every device."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            shape = tuple(p.shape)
            if leaf in ("pos_emb", "mu_token", "logvar_token"):
                val = rng.standard_normal(shape)
            elif leaf == "in_proj_weight":
                bound = math.sqrt(6.0 / (shape[0] // 3 + shape[1]))
                val = rng.uniform(-bound, bound, shape)
            elif leaf == "in_proj_bias":
                val = np.zeros(shape)
            elif leaf == "weight" and p.dim() == 1:
                val = np.ones(shape)
            elif leaf in ("weight", "bias"):
                w = module.get_submodule(owner_name).weight
                if w.dim() == 1:
                    val = np.zeros(shape)
                else:
                    bound = 1.0 / math.sqrt(int(np.prod(w.shape[1:])))
                    val = rng.uniform(-bound, bound, shape)
            else:
                raise ValueError(f"no initializer for parameter {name!r}")
            p.copy_(torch.as_tensor(val, dtype=p.dtype))
    return module


# ---------------------------------------------------------------------------
# Primitive applies
# ---------------------------------------------------------------------------


def linear(p, x):
    return F.linear(x, p.weight, p.bias)


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p.weight, p.bias, eps)


def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def gelu(x):
    return F.gelu(x)  # exact erf form, as torch nn.GELU's default


def mean_variance_norm(x, eps=1e-5):
    """Instance norm over tokens (axis -2) per channel for (..., s, c)
    inputs, with the Bessel-corrected variance and eps added to the std
    (not F.instance_norm, whose variance is biased)."""
    n = x.shape[-2]
    mean = x.mean(dim=-2, keepdim=True)
    var = x.var(dim=-2, keepdim=True, correction=0) * (n / max(n - 1, 1))
    return (x - mean) / (safe_sqrt(var) + eps)


def conv1x1(p, x):
    """Pointwise Conv2d on (n, c, t, v) tensors, in the weight's dtype."""
    return F.conv2d(x.to(p.weight.dtype), p.weight, p.bias)


def temporal_conv(p, x):
    """Conv2d with kernel (k, 1) over the time axis of (n, c, t, v), with
    reflect same-padding, in the weight's dtype."""
    pad = (p.weight.shape[2] - 1) // 2
    x = x.to(p.weight.dtype)
    if pad:
        x = F.pad(x, (0, 0, pad, pad), mode="reflect")
    return F.conv2d(x, p.weight, p.bias)


def spatial_conv(p, x, A):
    """1x1 conv to K*C channels, contracted with the (K, V, V) adjacency."""
    K = A.shape[0]
    y = conv1x1(p, x)
    n, kc, t, v = y.shape
    return torch.einsum("nkctv,kvw->nctw", y.reshape(n, K, kc // K, t, v), A)


def stgcn_block(p, x, A):
    """Pre-activation ST-GCN block: lrelu -> graph conv -> temporal conv."""
    x = spatial_conv(p["gcn"], leaky_relu(x, 0.2), A)
    return temporal_conv(p["tcn"], x)


# ---------------------------------------------------------------------------
# Context-matching transformer
# ---------------------------------------------------------------------------


def attention(p, src, tar=None, *, heads, adain=False):
    """Multi-head attention; with ``adain=True`` queries/keys read
    instance-normalized tokens while values keep style.  The (b, h, n, dh)
    product runs through :func:`fused_attention` (the CUDA kernel on the
    card, the plain version on the CPU)."""
    tar = src if tar is None else tar
    q_in = mean_variance_norm(src) if adain else src
    k_in = mean_variance_norm(tar) if adain else tar

    q = linear(p["to_q"], q_in)
    k = linear(p["to_k"], k_in)
    v = linear(p["to_v"], tar)

    b, n, inner = q.shape
    dh = inner // heads

    def split(t_):
        return t_.reshape(b, t_.shape[1], heads, dh).transpose(1, 2)

    out = fused_attention(split(q), split(k), split(v), scale=dh ** -0.5)
    out = out.transpose(1, 2).reshape(b, n, inner)
    if "to_out" in p:
        out = linear(p["to_out"], out)
    return out


def feedforward(p, x):
    return linear(p["w2"], gelu(linear(p["w1"], x)))


def adain(p, x, style):
    """Token-level AdaIN: pooled style -> (gamma, beta) through a LeakyReLU
    MLP, modulating the instance-normalized input."""
    pooled = style.mean(dim=1)
    h = leaky_relu(linear(p["fc1"], pooled), 0.2)
    gb = linear(p["fc2"], h)
    fin = gb.shape[-1] // 2
    gamma = gb[:, None, :fin]
    beta = gb[:, None, fin:]
    return (1.0 + gamma) * mean_variance_norm(x) + beta


def transformer(p, x, sty=None, *, heads, adain_on=False):
    """depth x [AdaIN? -> attention(+res) -> FF(+res)], no LayerNorm."""
    for layer in p["layers"]:
        if sty is not None and adain_on:
            x = adain(layer["adain"], x, sty)
        x = attention(layer["attn"], x, sty, heads=heads,
                      adain=adain_on) + x
        x = feedforward(layer["ff"], x) + x
    return x
