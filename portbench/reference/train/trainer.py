"""Generator trainer: the full MOCHA objective on one device.

Counterpart of mocha_sigasia2023_tpu/train/trainer.py (``make_optimizer``,
``compute_gen_loss``, ``GeneratorTrainer``).  A step runs six generator
forwards (translate src->cha, reconstruct src and cha, a feature pass for
PatchNCE, two cycle passes), the FK reconstruction losses, InfoNCE and
the cycle losses; AdamW with a staircase learning-rate decay, the safe
global-norm clip on the generator's gradients only, and an EMA of the
generator (beta 0.999) applied after the update.

Every forward here is a training forward (``train=True``): attention by
the plain formula, never the CUDA kernels, which have no backward.  The
JAX package trains through its einsum path too.  The JAX trainer's
workarounds for one TPU compiler (``split_step``'s separately compiled
pieces and ``tail_barrier``) are gradient-identical to its monolithic
step; the config keys are accepted and not acted on.

Departures from the port's ``train/trainer.py``, of which this is a
copy: one device only (no ``mesh``, no all-reduce, no gathered PatchNCE
keys), no checkpoint files, and the trainer takes its initial weights as
state dicts instead of drawing them from a NumPy seed.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..models.generator import Generator, GeneratorConfig
from ..models.layers import split
from ..models.projector import Projector, ProjectorConfig, apply_projector
from ..ops.numerics import safe_clip_by_global_norm
from .losses import (contrastive_acc, convert_YtilToX, patch_nce_loss,
                     recon_criterion)

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LR_GAMMA = 0.1


def make_optimizer(gen: Generator, prj: torch.nn.Module, lr: float,
                   weight_decay: float, lr_drop_epochs: int,
                   steps_per_epoch: int):
    """AdamW over the generator's and the projector's parameters (decoupled
    weight decay on every one of them, biases included) and a StepLR that,
    stepped once per update, gives optax's ``exponential_decay(lr,
    lr_drop_epochs * steps_per_epoch, 0.1, staircase=True)``.  Returns
    (optimizer, schedule).  The clip is :meth:`GeneratorTrainer.update`'s:
    it covers the generator's gradients only."""
    opt = torch.optim.AdamW(
        [{"params": list(gen.parameters())},
         {"params": list(prj.parameters())}],
        lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=weight_decay)
    schedule = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(lr_drop_epochs * steps_per_epoch, 1),
        gamma=LR_GAMMA)
    return opt, schedule


def _make_fwd(gen: Generator, compute_dtype=None, remat=False):
    """The generator's training forward ``fwd(a, b, seed, extract=False)``.
    ``seed`` (or None: no dropout) seeds the forward's own generator on the
    inputs' device; it is drawn before the call, so that ``remat``'s
    recomputation redraws the same masks.  With ``compute_dtype`` (e.g.
    bf16) the parameters, buffers and inputs are cast for the forward and
    the outputs cast back to float32: the gradients flow through the casts
    to the float32 master weights.  ``remat`` recomputes the activations
    in the backward (``torch.utils.checkpoint``)."""

    def base(a, b, seed, extract):
        g = None
        if seed is not None:
            g = torch.Generator(device=a.device).manual_seed(seed)
        kw = dict(extract_feature=extract, generator=g, train=True)
        if compute_dtype is None:
            return gen(a, b, **kw)
        tensors = {n: t.to(compute_dtype) if t.is_floating_point() else t
                   for n, t in (*gen.named_parameters(),
                                *gen.named_buffers())}
        out = functional_call(gen, tensors,
                              (a.to(compute_dtype), b.to(compute_dtype)), kw)
        if extract:
            return tuple(o.float() for o in out)
        return out.float()

    def fwd(a, b, seed, extract=False):
        if remat:
            return checkpoint(base, a, b, seed, extract, use_reentrant=False)
        return base(a, b, seed, extract)

    return fwd


def compute_gen_loss(gen: Generator, prj, prj_cfg: ProjectorConfig,
                     batch_src, batch_cha, norm, parents, weights,
                     generator: Optional[torch.Generator] = None,
                     loss_dtype=None, compute_dtype=None, remat=False,
                     gather_keys=None):
    """The full generator objective.  Returns (total, metrics, logits): 0-d
    tensors on the device, and the PatchNCE logits that the top-k
    accuracies rank (positive in column 0).  ``generator`` (None: no
    dropout) splits into the forwards' streams as the JAX package splits
    its key; ``gather_keys`` goes to :func:`patch_nce_loss`."""
    X_mean, X_std = norm["X_mean"][None, None], norm["X_std"][None, None]
    Y_mean, Y_std = norm["Y_mean"][None, None], norm["Y_std"][None, None]

    def norm_x(X):
        return (X[:, :, 1:] - X_mean[:, :, 1:]) / X_std[:, :, 1:]

    def denorm_y(o):
        return o * Y_std[:, :, 1:] + Y_mean[:, :, 1:]

    src_Y, cha_Y = batch_src["Y"], batch_cha["Y"]
    src_in, cha_in = norm_x(batch_src["X"]), norm_x(batch_cha["X"])

    seeds = [None] * 8
    if generator is not None:
        seeds = [g.initial_seed() for g in split(generator, 8)]
    fwd = _make_fwd(gen, compute_dtype, remat)

    def recon(o, gt):
        return recon_criterion(denorm_y(o), gt, parents,
                               compute_dtype=loss_dtype)

    trans_Ytil = fwd(src_in, cha_in, seeds[0])
    recon_src = fwd(src_in, src_in, seeds[1])
    recon_cha = fwd(cha_in, cha_in, seeds[2])

    trans_X = convert_YtilToX(denorm_y(trans_Ytil), src_Y[:, :, 0:1],
                              parents, compute_dtype=loss_dtype)
    trans_in = norm_x(trans_X)
    loss_recon = 0.5 * (recon(recon_src, src_Y) + recon(recon_cha, cha_Y))

    # PatchNCE context preservation: every token a patch ('all' mode), in
    # a fixed order (the loss does not depend on it)
    _, _, src_cnt, trans_cnt = fwd(src_in, trans_in, seeds[3], extract=True)
    feat_k, patch_id = apply_projector(prj, prj_cfg, trans_cnt)
    feat_q, _ = apply_projector(prj, prj_cfg, src_cnt, patch_id)
    loss_nce, logits = patch_nce_loss(feat_q, feat_k,
                                      compute_dtype=loss_dtype,
                                      gather_keys=gather_keys)
    top1, top5 = contrastive_acc(logits)

    cyc_src = fwd(trans_in, src_in, seeds[4])
    cyc_cha = fwd(cha_in, trans_in, seeds[5])
    loss_cyc = 0.5 * (recon(cyc_src, src_Y) + recon(cyc_cha, cha_Y))

    total = (weights["rec_w"] * loss_recon + weights["nce_w"] * loss_nce
             + weights["cyc_w"] * loss_cyc)
    metrics = {
        "gen/loss_total": total,
        "gen/loss_recon": loss_recon,
        "gen/loss_nce_cnt": loss_nce,
        "gen/cnt_acc_top1": top1,
        "gen/cnt_acc_top5": top5,
        "gen/loss_cyc": loss_cyc,
    }
    return total, metrics, logits


def _dtype(name):
    return getattr(torch, name) if name else None


class GeneratorTrainer:
    """The generator, projector, EMA, optimizer and schedule on one device,
    with the training step.  ``weights`` holds the initial ``gen`` and
    ``prj`` state dicts; the EMA starts as a copy of ``gen``.

    Config keys beyond the model and loss weights: ``dropout`` (false runs
    every forward without dropout), ``compute_dtype``, ``remat``,
    ``loss_dtype``, ``grad_clip`` and ``ema_beta``."""

    def __init__(self, config: Dict, steps_per_epoch: int, weights: Dict,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.loss_dtype = _dtype(config.get("loss_dtype"))
        self.train_forwards = bool(config.get("dropout", True))
        self.compute_dtype = _dtype(config.get("compute_dtype"))
        self.remat = bool(config.get("remat", False))
        self.gen_cfg = GeneratorConfig.from_dict(config["model"])
        self.prj_cfg = ProjectorConfig(
            mode="all",
            num_patches=config["model"].get("num_patches", -1),
            encoder_dim=self.gen_cfg.encoder_dim,
            prj_dim=config["model"].get("prj_dim", 1024),
            nframes=self.gen_cfg.nframes,
            temporal_patch_size=self.gen_cfg.temporal_patch_size)
        parents = np.asarray(config["dataset"]["mocha"]["parents"])
        self.parents = np.concatenate([[-1], parents + 1])
        self.weights = {k: float(config[k]) for k in ("rec_w", "nce_w",
                                                      "cyc_w")}
        self.ema_beta = float(config.get("ema_beta", 0.999))
        self.grad_clip = float(config.get("grad_clip", 1.0))

        self.gen = Generator(self.gen_cfg).to(self.device)
        self.prj = Projector(self.prj_cfg).to(self.device)
        self.gen.load_state_dict(weights["gen"])
        self.prj.load_state_dict(weights["prj"])
        self.gen_ema = copy.deepcopy(self.gen).requires_grad_(False).eval()
        self.opt, self.schedule = make_optimizer(
            self.gen, self.prj, lr=float(config["lr_gen"]),
            weight_decay=float(config["weight_decay_gen"]),
            lr_drop_epochs=int(config["lr_drop"]),
            steps_per_epoch=steps_per_epoch)
        self.step = 0

    def on_device(self, tree: Dict) -> Dict:
        """Each array or tensor of ``tree`` on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in tree.items()}

    def backward(self, batch_src: Dict, batch_cha: Dict, norm: Dict,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The loss and its gradients, left in each parameter's ``.grad``
        (before the clip).  Returns the metrics as 0-d device tensors and
        the PatchNCE logits, detached."""
        self.opt.zero_grad(set_to_none=True)
        total, metrics, logits = compute_gen_loss(
            self.gen, self.prj, self.prj_cfg, self.on_device(batch_src),
            self.on_device(batch_cha), self.on_device(norm),
            self.parents, self.weights,
            generator if self.train_forwards else None,
            loss_dtype=self.loss_dtype, compute_dtype=self.compute_dtype,
            remat=self.remat)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, logits.detach()

    @torch.no_grad()
    def update(self) -> None:
        """Clip the generator's gradients (the projector's pass as they
        are), step AdamW and the schedule, then move the EMA toward the
        updated generator."""
        gen_params = list(self.gen.parameters())
        for p in (*gen_params, *self.prj.parameters()):
            if p.grad is None:    # optax steps every leaf, on zeros too
                p.grad = torch.zeros_like(p)
        clipped = safe_clip_by_global_norm([p.grad for p in gen_params],
                                           self.grad_clip)
        for p, g in zip(gen_params, clipped):
            p.grad = g
        self.opt.step()
        self.schedule.step()
        ema = list(self.gen_ema.parameters())
        torch._foreach_mul_(ema, self.ema_beta)
        torch._foreach_add_(ema, gen_params, alpha=1.0 - self.ema_beta)
        self.step += 1

    def train_step(self, batch_src: Dict, batch_cha: Dict, norm: Dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update: :meth:`backward`, then :meth:`update`.  The metrics
        stay on the device; reading one waits for the step."""
        metrics, _ = self.backward(batch_src, batch_cha, norm, generator)
        self.update()
        return metrics
