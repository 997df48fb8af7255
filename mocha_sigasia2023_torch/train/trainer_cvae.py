"""CVAE predictor trainer: scheduled-sampling autoregressive rollouts.

Counterpart of mocha_sigasia2023_tpu/train/trainer_cvae.py:39-357:

- temp-weighted context normalization (linspace 1 -> 3 over the 15
  temporal token groups);
- noise-augmented source contexts and nearest-neighbour ground-truth
  character features per action, assembled on the host from
  ``np.random.RandomState(seed)`` exactly as the JAX trainer draws them;
- 10-step rollouts with teacher -> ramp -> student scheduled sampling and a
  p = 0.8 dropout on the autoregressive condition;
- an AdamW update at every rollout offset, with L1 + annealed KL (1e-2) +
  0.1 x distance-preservation losses;
- the learning rate of optax's count-based schedule: ExponentialLR(0.99)
  stepped every 200 iterations, read at each update's count.

One iteration is :meth:`CVAETrainer.rollout`: ``rollout_steps - 1``
forwards, backwards and updates on the device with no host sync; the
student/teacher choice is a device-side select.  The CVAE's attention is
plain PyTorch (XLA in the JAX package), so no CUDA kernel runs here.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from ..models import cvae as cvae_mod
from ..models.cvae import CVAE, CVAEConfig, init_cvae
from ..models.layers import dropout, mean_variance_norm, split
from ..ops.numerics import safe_sqrt
from ..runtime.matching import nn_index
from . import checkpoint as ckpt
from .losses import kl_normal
from .trainer import ADAM_BETAS, ADAM_EPS, _dtype

def temp_weight_matrix(num_temp: int = 15, nbody: int = 6, dim: int = 256,
                       lo: float = 1.0, hi: float = 3.0) -> np.ndarray:
    """Temporal emphasis weights, recent frames weighing more: shape
    (num_temp * nbody, dim), token-major like the encoder output."""
    w = np.linspace(lo, hi, num=num_temp)
    w = np.repeat(w[:, None], nbody * dim, axis=1)
    return w.reshape(num_temp * nbody, dim).astype(np.float32)


def rollout_indices(range_starts, range_stops, steps: int, stride: int = 5):
    """Consecutive-window rollout index sequences, one every ``stride``
    windows of each range."""
    out = []
    for s, e in zip(range_starts, range_stops):
        for j in range(0, int(e - s) - steps, stride):
            out.append(np.arange(s + j, s + j + steps))
    return np.asarray(out, dtype=np.int32)


def sample_schedule(teacher: int, ramp: int, student: int) -> np.ndarray:
    """P(student forcing) per iteration."""
    return np.concatenate([
        np.zeros(teacher), np.linspace(0.0, 1.0, ramp), np.ones(student)
    ]).astype(np.float32)


class CVAETrainerConfig(NamedTuple):
    latent_dim: int = 256
    depth: int = 2
    nheads: int = 4
    feedforward_dim: int = 512
    dropout: float = 0.1
    nseq: int = 90
    rollout_steps: int = 10
    batch_size: int = 32
    lr: float = 1e-4
    weight_decay: float = 1e-4
    lr_gamma: float = 0.99
    lr_step_every: int = 200
    kl_w: float = 1e-2
    kl_anneal_start: int = 0
    kl_anneal_end: int = 5000
    dist_w: float = 0.1
    condition_dropout: float = 0.8
    teacher_iters: int = 10000
    ramping_iters: int = 10000
    student_iters: int = 20000
    # e.g. "bfloat16": bf16 forwards on float32 master weights, float32
    # loss tails (None: float32 throughout)
    compute_dtype: Optional[str] = None

    @property
    def num_iters(self):
        return self.teacher_iters + self.ramping_iters + self.student_iters


class CVAETrainer:
    """Trains the CVAE over precomputed encoder features for one
    source -> character pair, on one device."""

    def __init__(self, tc: CVAETrainerConfig, *, src_cnt, src_action,
                 src_range_starts, src_range_stops, cha_cnt, cha_encoded,
                 cha_action, cha_range_starts, cha_range_stops,
                 cnt_mean, cnt_std, target_actions, seed: int = 1777,
                 device=None):
        self.tc = tc
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(tc.compute_dtype)
        self.cfg = CVAEConfig(
            output_seq=tc.nseq, latent_dim=tc.latent_dim, depth=tc.depth,
            nheads=tc.nheads, feedforward_dim=tc.feedforward_dim,
            dropout=tc.dropout)

        tw = temp_weight_matrix(num_temp=tc.nseq // 6, nbody=6,
                                dim=tc.latent_dim)
        self.temp_weight = tw
        self.norms = {
            "src_cnt_mean": src_cnt.mean(axis=0).astype(np.float32),
            "src_cnt_std": src_cnt.std(axis=0).astype(np.float32),
            "cha_cnt_mean": cha_cnt.mean(axis=0).astype(np.float32),
            "cha_cnt_std": cha_cnt.std(axis=0).astype(np.float32),
            "cha_encoded_mean": cha_encoded.mean(axis=0).astype(np.float32),
            "cha_encoded_std": cha_encoded.std(axis=0).astype(np.float32),
        }
        # temp-weighted stds
        self._cnt_std_w = (cnt_std / tw).astype(np.float32)
        self._cnt_mean = cnt_mean.astype(np.float32)
        self._src_cnt_std_w = self.norms["src_cnt_std"] / tw
        self._cha_cnt_std_w = self.norms["cha_cnt_std"] / tw
        self._cha_enc_std_w = self.norms["cha_encoded_std"] / tw
        self._noise_std = self._cnt_std_w + 1.0

        self.src_cnt = src_cnt
        self.cha_cnt = cha_cnt
        self.cha_encoded = cha_encoded
        self.src_idx = rollout_indices(src_range_starts, src_range_stops,
                                       tc.rollout_steps)
        self.cha_idx = rollout_indices(cha_range_starts, cha_range_stops,
                                       tc.rollout_steps)
        self.src_act = src_action[self.src_idx[:, 0]]
        self.cha_act = cha_action[self.cha_idx[:, 0]]
        self.target_actions = list(target_actions)
        self.schedule = sample_schedule(
            tc.teacher_iters, tc.ramping_iters, tc.student_iters)

        self.rng = np.random.RandomState(seed)
        self.key = torch.Generator(device=self.device).manual_seed(seed)

        def on_device(a):
            return torch.as_tensor(a, device=self.device)

        self._enc_std = on_device(self._cha_enc_std_w)
        self._enc_mean = on_device(self.norms["cha_encoded_mean"])
        self._ccnt_std = on_device(self._cha_cnt_std_w)
        self._ccnt_mean = on_device(self.norms["cha_cnt_mean"])

        self.cvae = init_cvae(self.cfg, seed + 1, self.device,
                              trainable=True)
        self.restart()

    def restart(self, cvae_state: Optional[Dict] = None) -> None:
        """Load ``cvae_state`` (a state dict) if given, and start the
        optimizer afresh at update count 0."""
        if cvae_state is not None:
            with torch.no_grad():
                self.cvae.load_state_dict(cvae_state)
        self.opt = torch.optim.AdamW(
            self.cvae.parameters(), lr=self.tc.lr, betas=ADAM_BETAS,
            eps=ADAM_EPS, weight_decay=self.tc.weight_decay)
        self.updates = 0

    # ------------------------------------------------------------------

    def n_decays(self, count: int) -> int:
        """Scheduler steps taken before update ``count`` (0-based) ran:
        the reference's ExponentialLR steps at the end of iterations 0,
        200, 400, ...; an iteration makes ``rollout_steps - 1`` updates."""
        it = count // max(self.tc.rollout_steps - 1, 1)
        return 0 if it < 1 else (it - 1) // self.tc.lr_step_every + 1

    def learning_rate(self, count: int) -> float:
        """The learning rate of update ``count``, as optax's count-based
        schedule gives it to the JAX trainer."""
        return self.tc.lr * self.tc.lr_gamma ** self.n_decays(count)

    def _forward(self, tgt, cond, generator):
        """The CVAE's training forward; with ``compute_dtype`` on cast
        parameters and inputs (gradients flow through the casts to the
        float32 masters) and its outputs cast back to float32."""
        kw = {"generator": generator, "train": True}
        if self.compute_dtype is None:
            return cvae_mod.forward(self.cvae, tgt, cond, **kw)
        cdt = self.compute_dtype
        params = {n: p.to(cdt) for n, p in self.cvae.named_parameters()}
        out, (mu_po, lv_po), (mu_pr, lv_pr) = functional_call(
            self.cvae, params, (tgt.to(cdt), cond.to(cdt)), kw)
        return out.float(), (mu_po.float(), lv_po.float()), (
            mu_pr.float(), lv_pr.float())

    def _losses(self, offset, condition, src_cnt_nm, cha_enc_nm, cha_cnt_nm,
                Dgnd, anneal_w, generator):
        tc = self.tc
        out, (mu_po, lv_po), (mu_pr, lv_pr) = self._forward(
            cha_enc_nm[:, offset], condition, generator)
        kl = kl_normal(mu_po, lv_po, mu_pr, lv_pr).mean()
        enc_l1 = torch.mean(torch.abs(out - cha_enc_nm[:, offset]))
        out_un = out * self._enc_std + self._enc_mean
        cnt_til = (mean_variance_norm(out_un) - self._ccnt_mean) \
            / self._ccnt_std
        # safe_sqrt: identical src/cha content rows (distance exactly 0)
        # must not give inf gradients
        Dtil = safe_sqrt(torch.sum(torch.square(
            src_cnt_nm[:, offset] - cnt_til), dim=-1))
        dist_l1 = torch.mean(torch.abs(Dtil - Dgnd[:, offset]))
        cnt_l1 = torch.mean(torch.abs(cnt_til - cha_cnt_nm[:, offset]))
        total = enc_l1 + anneal_w * tc.kl_w * kl + tc.dist_w * dist_l1
        return total, torch.stack([enc_l1, kl, cnt_l1, dist_l1]), out

    def _condition(self, generator, cnt_next, prev_enc):
        # F.dropout semantics: zero with p, the kept scaled by 1 / (1 - p)
        kept = dropout(prev_enc, self.tc.condition_dropout, generator, True)
        return torch.cat([cnt_next, kept], dim=1)

    def _update(self):
        """One AdamW step at the learning rate of this update's count.
        A parameter with no gradient steps on zeros, as optax steps every
        leaf (its weight decay still applies)."""
        for p in self.cvae.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.learning_rate(self.updates)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.updates += 1

    def rollout(self, src_cnt_nm, cha_enc_nm, cha_cnt_nm, Dgnd,
                student_p: float, anneal_w: float,
                generator: torch.Generator) -> torch.Tensor:
        """One training iteration over rollout offsets 1 .. S-1, an
        optimizer update at each (tensors on the trainer's device).
        Returns the device metrics [enc_l1, kl, cnt_l1, dist_l1]: the
        offsets' sums divided by ``rollout_steps``, not by the number of
        offsets, as the reference logs them."""
        steps = self.tc.rollout_steps
        g_cond, key = split(generator, 2)
        condition = self._condition(g_cond, src_cnt_nm[:, 1], cha_enc_nm[:, 0])
        sums = 0.0
        for offset in range(1, steps):
            key, g_fwd, g_student, g_drop = split(key, 4)
            self.opt.zero_grad(set_to_none=True)
            total, metrics, out = self._losses(
                offset, condition, src_cnt_nm, cha_enc_nm, cha_cnt_nm, Dgnd,
                anneal_w, g_fwd)
            total.backward()
            self._update()
            sums += metrics.detach()
            if offset + 1 < steps:
                u = torch.rand((), generator=g_student, device=self.device)
                next_frame = torch.where(u < student_p, out.detach(),
                                         cha_enc_nm[:, offset])
                condition = self._condition(g_drop, src_cnt_nm[:, offset + 1],
                                            next_frame)
        return sums / steps

    # ------------------------------------------------------------------

    def sample_batch(self, it: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Host batch assembly: action pick, noise and the nearest-neighbour
        ground truth, drawn from the trainer's RandomState as the JAX
        trainer draws them.  The neighbour's distances are summed in
        float64 (``runtime.matching.nn_index``).  Only the rows the batch
        reads are gathered.  None when the action's pool is underfull."""
        tc = self.tc
        action = self.rng.choice(self.target_actions, 1)[0]
        src_pool = np.where(self.src_act == action)[0]
        if len(src_pool) < tc.batch_size:
            return None
        cha_pool = np.where(self.cha_act == action)[0]
        if len(cha_pool) < 1:
            return None

        samples = self.rng.choice(src_pool, tc.batch_size)
        bidx = self.src_idx[samples]
        src_cnt_b = self.src_cnt[bidx]  # (B, S, 90, 256)

        nsigma = self.rng.uniform(
            size=[tc.batch_size, 1, 1, 1]).astype(np.float32)
        noise = self.rng.normal(size=src_cnt_b.shape).astype(np.float32)
        src_cnt_hat = src_cnt_b + self._noise_std[None, None] * nsigma * noise

        cha_rollouts = self.cha_idx[cha_pool]
        # first-window NN in normalized cnt space
        db = ((self.cha_cnt[cha_rollouts[:, 0]] - self._cnt_mean[None]) /
              self._cnt_std_w[None]).reshape(len(cha_pool), -1)
        q = ((src_cnt_hat[:, 0] - self._cnt_mean[None]) /
             self._cnt_std_w[None]).reshape(tc.batch_size, -1)
        nearest = nn_index(torch.from_numpy(q), torch.from_numpy(db)).numpy()
        picked = cha_rollouts[nearest]

        cha_enc_gnd = (self.cha_encoded[picked]
                       - self.norms["cha_encoded_mean"][None, None]) \
            / self._cha_enc_std_w[None, None]
        src_cnt_nm = (src_cnt_hat - self.norms["src_cnt_mean"][None, None]) \
            / self._src_cnt_std_w[None, None]
        cha_cnt_nm = (self.cha_cnt[picked]
                      - self.norms["cha_cnt_mean"][None, None]) \
            / self._cha_cnt_std_w[None, None]
        Dgnd = np.sqrt(np.sum(np.square(src_cnt_nm - cha_cnt_nm), axis=-1))
        return (src_cnt_nm.astype(np.float32),
                cha_enc_gnd.astype(np.float32),
                cha_cnt_nm.astype(np.float32),
                Dgnd.astype(np.float32))

    def anneal_weight(self, it: int) -> float:
        tc = self.tc
        if it < tc.kl_anneal_start:
            return 0.0
        w = (it - tc.kl_anneal_start) / max(
            tc.kl_anneal_end - tc.kl_anneal_start, 1)
        return min(w, 1.0)

    def batch_stream(self, num_iters: int
                     ) -> Iterator[Tuple[int, Optional[Tuple]]]:
        """Yield (it, batch-or-None) for ``num_iters`` iterations.  Wrapped
        in ``data.dataset.prefetch_batches`` (with a ``place`` that copies
        to the device) the host assembly overlaps the device rollout;
        None batches keep the consumer's iteration count in step with the
        sync loop's."""
        for it in range(num_iters):
            yield it, self.sample_batch(it)

    def step_placed(self, it: int, batch: Tuple) -> torch.Tensor:
        """One training iteration on a batch of arrays or tensors (moved to
        the device unless they are there); returns the device metrics
        vector without a sync: :meth:`metrics_dict` reads it."""
        src_cnt_nm, cha_enc_nm, cha_cnt_nm, Dgnd = (
            torch.as_tensor(a, device=self.device) for a in batch)
        self.key, sub = split(self.key, 2)
        return self.rollout(
            src_cnt_nm, cha_enc_nm, cha_cnt_nm, Dgnd,
            float(self.schedule[min(it, len(self.schedule) - 1)]),
            self.anneal_weight(it), sub)

    def metrics_dict(self, it: int, m) -> Dict[str, float]:
        """Host metrics of iteration ``it`` (reading a device vector waits
        for it)."""
        if torch.is_tensor(m):
            m = m.cpu().numpy()
        enc_l1, kl, cnt_l1, dist_l1 = np.asarray(m)
        return {
            "cvae/encoded_loss": float(enc_l1),
            "cvae/kl_loss": float(kl),
            "cvae/kl_weight": self.anneal_weight(it) * self.tc.kl_w,
            "cvae/cnt_loss": float(cnt_l1),
            "cvae/dist_loss": float(dist_l1),
        }

    def train_iteration(self, it: int) -> Optional[Dict[str, float]]:
        """One synchronous iteration: assemble, step, read the metrics."""
        batch = self.sample_batch(it)
        if batch is None:
            return None
        return self.metrics_dict(it, self.step_placed(it, batch))

    def norm_artifacts(self) -> Dict[str, np.ndarray]:
        """cvae_norm.npz contents."""
        return {"std_weight": self.temp_weight, **self.norms}

    def state(self, iteration: int) -> Dict:
        """The checkpoint's contents: the CVAE's state dict on the CPU and
        the iteration."""
        return {"cvae": {k: v.detach().cpu()
                         for k, v in self.cvae.state_dict().items()},
                "iteration": int(iteration)}


def cvae_checkpoint_path(out_dir: str, iteration: int) -> str:
    return os.path.join(out_dir, f"cvae_{iteration:06d}{ckpt.SUFFIX}")


def load_cvae(path: str, cfg: CVAEConfig = CVAEConfig(), *,
              device=None) -> CVAE:
    """The CVAE of a port trainer checkpoint (``cvae_*.ckpt``), ready to
    serve."""
    cvae = CVAE(cfg)
    cvae.load_state_dict(ckpt.load_checkpoint(path)["cvae"])
    return cvae.requires_grad_(False).to(resolve_device(device)).eval()
