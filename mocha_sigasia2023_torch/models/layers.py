"""Building blocks of the generator (PyTorch).

Counterpart of mocha_sigasia2023_tpu/models/layers.py.  Parameters live in
``nn.Module`` containers whose paths are the JAX pytree paths (``to_q``,
``layers.0.ff.w1``, ...) with torch layouts (Linear (out, in), Conv2d
(O, I, kh, kw)), so JAX weights load with a flatten.  The apply functions
take those containers and tensors, as the JAX functions take param dicts.
As in the JAX package, the convolutions cast their input to the weight's
dtype, so bf16 weights compute in bf16; the attention product then
launches the bf16 kernel.

Training forwards (``train=True``) take the JAX package's training path:
attention by the plain formula (the kernels have no backward; JAX trains
through its einsum path too), and dropout where a ``torch.Generator`` is
given, in place of the JAX ``key``.  :func:`split` derives independent
generators from one, as ``jax.random.split`` derives keys.  Under
:func:`batch_shard` (a rank of a data-parallel step or of sharded serving)
the draws that follow the batch are taken at the global batch's shape and
cut to this rank's rows, so that they equal the single-process draws.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_reference, fused_attention
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


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def split(generator: torch.Generator, n: int):
    """``n`` generators on ``generator``'s device, seeded from its seed
    alone (not from its draws), as ``jax.random.split`` derives keys from a
    key: the same generator splits into the same streams every time, so a
    forward recomputed from the same seed redraws the same masks.  Each
    generator is either drawn from or split, never both."""
    base = _splitmix64(generator.initial_seed())
    return [torch.Generator(device=generator.device).manual_seed(
        _splitmix64((base + i + 1) & _MASK64)) for i in range(n)]


# (this process's block, the number of blocks) of the leading axis
_BATCH_SHARD = (0, 1)


@contextlib.contextmanager
def batch_shard(index: int, count: int):
    """Within the block, :func:`draw` takes every draw at ``count`` times
    the leading axis it is asked for and keeps block ``index``: a process
    holding rows ``[index b, (index + 1) b)`` of a batch split into
    ``count`` blocks then draws what one process holding the whole batch
    draws for those rows (JAX's sharded jit draws a global-shape mask).
    Every draw that follows the batch has the batch on its leading axis:
    dropout on the attention weights (b, heads, n, m), on the attention
    and feed-forward outputs (b, tokens, dim), and the CVAE's noise
    (b, latent)."""
    global _BATCH_SHARD
    if not 0 <= index < count:
        raise ValueError(f"batch_shard: block {index} of {count}")
    saved, _BATCH_SHARD = _BATCH_SHARD, (int(index), int(count))
    try:
        yield
    finally:
        _BATCH_SHARD = saved


def current_shard():
    """(block index, block count) that :func:`draw` cuts to now."""
    return _BATCH_SHARD


def draw(fn, shape, generator, device, dtype=None) -> torch.Tensor:
    """``fn(shape, generator=, device=, dtype=)`` (``torch.rand`` or
    ``torch.randn``), under :func:`batch_shard` drawn for the whole batch
    and cut to this process's block of the leading axis."""
    index, count = _BATCH_SHARD
    shape = tuple(shape)
    if count == 1:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    b = shape[0]
    full = fn((b * count,) + shape[1:], generator=generator, device=device,
              dtype=dtype)
    return full[index * b:(index + 1) * b]


def dropout(x, rate: float, generator, train: bool):
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate), the mask drawn from
    ``generator`` (on ``x``'s device; see :func:`batch_shard`); the
    identity unless training with a generator and a positive rate."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = (draw(torch.rand, x.shape, generator, x.device)
            < keep).to(x.dtype)
    return x * mask * (1.0 / keep)


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p.weight, p.bias, eps)


def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def gelu(x):
    return F.gelu(x)  # exact erf form, as torch nn.GELU's default


def mean_variance_norm(x, eps=1e-5):
    """Instance norm over tokens (axis -2) per channel for (..., s, c)
    inputs, with the Bessel-corrected variance and eps added to the std
    (not F.instance_norm, whose variance is biased).  The variance is taken
    of the centered tokens, as ``jnp.var`` takes it: then the gradient sums
    to zero over the tokens up to rounding, as the exact one does.  From
    ``x`` itself, var's backward scales ``x - mean`` by the variance's
    gradient, and the rounding of that mean (larger on a GPU's reduction
    than on the CPU's) leaves a sum over the tokens that a per-channel
    shift upstream (AdaIN's beta) collects."""
    n = x.shape[-2]
    centered = x - x.mean(dim=-2, keepdim=True)
    var = centered.var(dim=-2, keepdim=True, correction=0) * (
        n / max(n - 1, 1))
    return centered / (safe_sqrt(var) + eps)


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


def attention(p, src, tar=None, *, heads, adain=False, drop=0.0,
              generator=None, train=False):
    """Multi-head attention; with ``adain=True`` queries/keys read
    instance-normalized tokens while values keep style.  Serving runs the
    (b, h, n, dh) product through :func:`fused_attention` (the CUDA kernel
    on the card, the plain version on the CPU).  A training forward takes
    the plain formula on every device, with dropout on the attention weights
    and on the ``to_out`` output, as the JAX package trains."""
    tar = src if tar is None else tar
    q_in = mean_variance_norm(src) if adain else src
    k_in = mean_variance_norm(tar) if adain else tar

    q = linear(p["to_q"], q_in)
    k = linear(p["to_k"], k_in)
    v = linear(p["to_v"], tar)

    b, n, inner = q.shape
    dh = inner // heads

    def split_heads(t_):
        return t_.reshape(b, t_.shape[1], heads, dh).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    g_attn = g_out = None
    if train:
        if generator is not None:
            g_attn, g_out = split(generator, 2)
        out = attention_reference(
            q, k, v, dh ** -0.5,
            lambda a: dropout(a, drop, g_attn, train))
    else:
        out = fused_attention(q, k, v, scale=dh ** -0.5)
    out = out.transpose(1, 2).reshape(b, n, inner)
    if "to_out" in p:
        out = dropout(linear(p["to_out"], out), drop, g_out, train)
    return out


def feedforward(p, x, *, drop=0.0, generator=None, train=False):
    g1 = g2 = None
    if train and generator is not None:
        g1, g2 = split(generator, 2)
    h = dropout(gelu(linear(p["w1"], x)), drop, g1, train)
    return dropout(linear(p["w2"], h), drop, g2, train)


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


def transformer(p, x, sty=None, *, heads, adain_on=False, drop=0.0,
                generator=None, train=False):
    """depth x [AdaIN? -> attention(+res) -> FF(+res)], no LayerNorm."""
    for layer in p["layers"]:
        if sty is not None and adain_on:
            x = adain(layer["adain"], x, sty)
        g1 = g2 = None
        if generator is not None:
            generator, g1, g2 = split(generator, 3)
        x = attention(layer["attn"], x, sty, heads=heads, adain=adain_on,
                      drop=drop, generator=g1, train=train) + x
        x = feedforward(layer["ff"], x, drop=drop, generator=g2,
                        train=train) + x
    return x
