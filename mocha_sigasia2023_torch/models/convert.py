"""Load weights into the port's modules.

Two sources:

- JAX-package parameter pytrees.  They already use torch layouts (Linear
  (out, in), Conv2d (O, I, kh, kw)) and the port's modules use the pytree
  paths as parameter names, so carrying weights across is a flatten to
  dotted keys and a strict ``load_state_dict``.  The pytrees come as nested
  dicts/lists of NumPy arrays (``jax.tree.map(np.asarray, params)``), or
  as the JAX package's msgpack checkpoints read by ``io/msgpack.py``
  (bf16 leaves as ``torch.bfloat16`` tensors); every leaf loads as
  float32.
- The reference's PyTorch checkpoints: the generator trainer's
  ``{'gen', 'gen_ema', 'gen_opt'}`` dict (``gen_125.pt``), the CVAE's
  bare state dict (``cvae_020000.pt``) and the projector's state dict,
  with or without DataParallel
  ``module.`` prefixes.  Every port parameter name maps to one reference
  key; the reference's fixed buffers (graph adjacency stacks, pooling
  matrices, sincos tables) are recomputed by the port and skipped.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..io.msgpack import listify
from .cvae import CVAE, CVAEConfig
from .generator import Generator, GeneratorConfig
from .projector import Projector, ProjectorConfig


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif torch.is_tensor(tree):
        return {prefix: tree}
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_pytree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def pytree_from_state_dict(state_dict) -> Dict:
    """The inverse of :func:`flatten_pytree`: dotted names as nested dicts,
    maps keyed "0".."n-1" as lists, leaves as NumPy arrays (the JAX
    package's pytree of a port module's ``state_dict()``)."""
    tree: Dict = {}
    for name, value in state_dict.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy() if torch.is_tensor(value) \
            else np.asarray(value)
    return listify(tree)


def _float32(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(torch.float32)
    return torch.as_tensor(np.array(v, np.float32))


def state_dict_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """A JAX pytree's leaves as float32 tensors under the port's names."""
    return {k: _float32(v) for k, v in flatten_pytree(params_np).items()}


def _load(module: torch.nn.Module, params_np, device):
    module.load_state_dict(state_dict_from_jax(params_np), strict=True)
    return module.requires_grad_(False).to(resolve_device(device)).eval()


def generator_from_jax(params_np, cfg: GeneratorConfig = GeneratorConfig(),
                       device=None) -> Generator:
    """The port's Generator holding the JAX generator's weights."""
    return _load(Generator(cfg), params_np, device)


def cvae_from_jax(params_np, cfg: CVAEConfig = CVAEConfig(),
                  device=None) -> CVAE:
    """The port's CVAE holding the JAX CVAE's weights."""
    return _load(CVAE(cfg), params_np, device)


def projector_from_jax(params_np, cfg: ProjectorConfig = ProjectorConfig(),
                       device=None) -> Projector:
    """The port's Projector holding the JAX projector's weights."""
    return _load(Projector(cfg), params_np, device)


def _maps_with_keys(tree, keys, found):
    """Every dict of ``tree`` (nested dicts and lists) whose keys are
    ``keys``, depth first."""
    if isinstance(tree, dict):
        if set(tree) == keys:
            found.append(tree)
            return found
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _maps_with_keys(v, keys, found)
    return found


def adamw_from_optax(opt_state) -> Dict:
    """The AdamW state of the JAX generator trainer's optax state, as its
    msgpack checkpoint holds it: ``chain(masked(safe_clip), adamw(lr
    schedule))`` is ``[{"inner_state": {}}, [ScaleByAdamState {count, mu,
    nu}, {}, ScaleByScheduleState {count}]]``.  Returns ``{"count",
    "schedule_count", "exp_avg", "exp_avg_sq"}``: the update count, the
    schedule's, and ``mu`` / ``nu`` as ``{"gen": ..., "prj": ...}`` state
    dicts under the port's parameter names (the pytrees use torch layouts,
    so this is the weights' own flatten), float32."""
    adam = _maps_with_keys(opt_state, {"count", "mu", "nu"}, [])
    sched = _maps_with_keys(opt_state, {"count"}, [])
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(f"optax state: {len(adam)} ScaleByAdamState and "
                         f"{len(sched)} ScaleByScheduleState found, want "
                         "one of each (chain(masked(clip), adamw(schedule)))")
    return {"count": int(np.asarray(adam[0]["count"])),
            "schedule_count": int(np.asarray(sched[0]["count"])),
            "exp_avg": {part: state_dict_from_jax(tree)
                        for part, tree in adam[0]["mu"].items()},
            "exp_avg_sq": {part: state_dict_from_jax(tree)
                           for part, tree in adam[0]["nu"].items()}}


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints
# ---------------------------------------------------------------------------

# port parameter name -> reference state-dict key, applied in order
# (reference module tree: model.py's Generator, model_CVAE.py's CVAE)
_GENERATOR_KEYS = (
    (r"^embed\.conv_in\.", "mot_embedding.1."),
    (r"^embed\.joint\.", "mot_embedding.2.blk."),
    (r"^embed\.body\.", "mot_embedding.5.blk."),
    (r"^head\.body\.", "to_mot.1.blk."),
    (r"^head\.joint\.", "to_mot.4.blk."),
    (r"^head\.conv_out\.", "to_mot.6."),
    (r"\.gcn\.", ".gcn.conv."),
    (r"\.attn\.to_([qk])\.", r".1.to_\1.1."),
    (r"\.attn\.to_v\.", ".1.to_v."),
    (r"\.attn\.to_out\.", ".1.to_out.0."),
    (r"\.ff\.w1\.", ".2.net.0."),
    (r"\.ff\.w2\.", ".2.net.3."),
    (r"\.adain\.fc1\.", ".0.style.2."),
    (r"\.adain\.fc2\.", ".0.style.4."),
)
_PROJECTOR_KEYS = ((r"^fc1\.", "mlp.0."), (r"^fc2\.", "mlp.2."))
_CVAE_KEYS = (
    (r"^prior\.layers\.", "prior_net.encoder.layers."),
    (r"^prior\.", "prior_net."),
    (r"^posterior\.layers\.", "encoder.encoder.layers."),
    (r"^posterior\.", "encoder."),
    (r"^decoder\.layers\.", "decoder.decoder.layers."),
)

# Fixed reference buffers the port recomputes from the config instead of
# loading: the hop-distance adjacency stacks (A_j/A_b), the joint<->bodypart
# pooling matrices, and the CVAE's sincos positional table.
_GENERATOR_BUFFER_KEYS = (
    r"(^|\.)A_[jb]$",
    r"^mot_embedding\.3\.weight$",
    r"^to_mot\.3\.weight$",
)
_CVAE_BUFFER_KEYS = (r"(^|\.)pos_encoder\.pe$",)


def strip_module_prefix(state_dict: Dict) -> Dict:
    """Drop DataParallel's ``module.`` prefix from every key."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _reference_key(name: str, rules) -> str:
    """The reference key of the port parameter ``name``."""
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _from_reference(module: torch.nn.Module, state_dict: Dict, rules,
                    ignore, what: str, strict: bool, device):
    """Fill ``module`` from a reference state dict.  A port parameter whose
    key is missing raises; a reference key that no parameter reads raises
    under ``strict`` unless it is one of the ``ignore`` buffers."""
    sd = strip_module_prefix(state_dict)
    flat, used = {}, set()
    for name in module.state_dict():
        key = _reference_key(name, rules)
        if key not in sd:
            raise KeyError(f"{what} checkpoint has no key {key!r} (for the "
                           f"port's {name!r})")
        v = sd[key]
        flat[name] = v.detach().cpu() if torch.is_tensor(v) else v
        used.add(key)
    left = sorted(k for k in sd if k not in used
                  and not any(re.search(p, k) for p in ignore))
    if left and strict:
        raise ValueError(
            f"{what} conversion dropped {len(left)} state_dict key(s): "
            f"{left[:8]}{' ...' if len(left) > 8 else ''}; pass strict=False "
            "to ignore them")
    return _load(module, flat, device)


def load_torch_file(path: str):
    """A reference ``.pt`` file's object, read on the CPU (tensors, dicts
    and numbers only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def generator_from_torch(state_dict: Dict,
                         cfg: GeneratorConfig = GeneratorConfig(), *,
                         strict: bool = True, device=None) -> Generator:
    """The port's Generator from a reference Generator state dict."""
    return _from_reference(Generator(cfg), state_dict, _GENERATOR_KEYS,
                           _GENERATOR_BUFFER_KEYS, "Generator", strict,
                           device)


def cvae_from_torch(state_dict: Dict, cfg: CVAEConfig = CVAEConfig(), *,
                    strict: bool = True, device=None) -> CVAE:
    """The port's CVAE from a reference CVAE state dict."""
    return _from_reference(CVAE(cfg), state_dict, _CVAE_KEYS,
                           _CVAE_BUFFER_KEYS, "CVAE", strict, device)


def projector_from_torch(state_dict: Dict,
                         cfg: ProjectorConfig = ProjectorConfig(), *,
                         strict: bool = True, device=None) -> Projector:
    """The port's Projector from a reference Projector state dict (its MLP
    at ``mlp.0`` / ``mlp.2``)."""
    return _from_reference(Projector(cfg), state_dict, _PROJECTOR_KEYS, (),
                           "Projector", strict, device)


def load_reference_generator_checkpoint(
        path: str, cfg: GeneratorConfig = GeneratorConfig(), *,
        use_ema: bool = True, device=None) -> Generator:
    """The generator of a reference trainer checkpoint
    ``{'gen', 'gen_ema', 'gen_opt'}``: its EMA branch unless ``use_ema`` is
    false."""
    ckpt = load_torch_file(path)
    return generator_from_torch(ckpt["gen_ema" if use_ema else "gen"], cfg,
                                device=device)
