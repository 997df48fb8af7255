"""Training losses (differentiable end to end).

Counterpart of mocha_sigasia2023_tpu/train/losses.py:
  * recon_criterion: 12-term weighted L1 with forward kinematics inside
    the loss;
  * convert_YtilToX: character-space X features re-derived from predicted
    parent-local Y through differentiable FK;
  * patch_nce_loss: InfoNCE over projected patches, negatives across the
    minibatch, diagonal masked;
  * contrastive_acc: top-k accuracy of the positive logit;
  * kl_normal: KL between diagonal Gaussians.

``compute_dtype`` (e.g. ``torch.float64``) runs a loss tail in that dtype
and casts the result back to the input's.
"""

from __future__ import annotations

import torch

from ..kinematics import quat, xform
from ..ops.numerics import safe_sqrt


def _split_channels(Y):
    b, t, j = Y.shape[:3]
    pos = Y[..., :3]
    txy = Y[..., 3:9].reshape(b, t, j, 3, 2)
    vel = Y[..., 9:12]
    ang = Y[..., 12:15]
    return pos, txy, vel, ang


def recon_criterion(Ytil, Ygt, parents, dt: float = 1.0 / 60.0,
                    compute_dtype=None):
    """Weighted L1 over the local pose, the FK'd character-space pose and
    their finite differences.  Ytil (B, T, J-1, 15) is the prediction
    without the root bone; Ygt (B, T, J, 15) the ground truth with it (its
    root row is attached to the prediction before FK)."""
    out_dtype = Ytil.dtype
    if compute_dtype is not None:
        Ytil = Ytil.to(compute_dtype)
        Ygt = Ygt.to(compute_dtype)
    gt_pos, gt_txy, gt_vel, gt_ang = _split_channels(Ygt)
    gt_xfm = xform.from_xy(gt_txy)

    p_pos, p_txy, p_vel, p_ang = _split_channels(Ytil)
    p_pos = torch.cat([gt_pos[:, :, 0:1], p_pos], dim=2)
    p_txy = torch.cat([gt_txy[:, :, 0:1], p_txy], dim=2)
    p_xfm = xform.from_xy(p_txy)
    p_vel = torch.cat([gt_vel[:, :, 0:1], p_vel], dim=2)
    p_ang = torch.cat([gt_ang[:, :, 0:1], p_ang], dim=2)

    G_gt = xform.fk_vel(gt_xfm, gt_pos, gt_vel, gt_ang, parents)
    G_p = xform.fk_vel(p_xfm, p_pos, p_vel, p_ang, parents)

    def char_space(G):
        g_xfm, g_pos, g_vel, g_ang = G
        r = g_xfm[:, :, 0:1]
        return (xform.inv_mul(r, g_xfm),
                xform.inv_mul_vec(r, g_pos - g_pos[:, :, 0:1]),
                xform.inv_mul_vec(r, g_vel),
                xform.inv_mul_vec(r, g_ang))

    Qgt_xfm, Qgt_pos, Qgt_vel, Qgt_ang = char_space(G_gt)
    Qp_xfm, Qp_pos, Qp_vel, Qp_ang = char_space(G_p)

    def d(a):
        return (a[:, 1:] - a[:, :-1]) / dt

    def l1(w, a, b):
        return torch.mean(w * torch.abs(a - b))

    gt_txy6 = Ygt[..., 3:9]
    p_txy6 = torch.cat([Ygt[:, :, 0:1, 3:9], Ytil[..., 3:9]], dim=2)

    return (
        l1(75.0, gt_pos, p_pos)
        + l1(10.0, gt_txy, p_txy)
        + l1(10.0, gt_vel, p_vel)
        + l1(1.25, gt_ang, p_ang)
        + l1(15.0, Qgt_pos, Qp_pos)
        + l1(5.0, Qgt_xfm, Qp_xfm)
        + l1(2.0, Qgt_vel, Qp_vel)
        + l1(0.75, Qgt_ang, Qp_ang)
        + l1(10.0, d(gt_pos), d(p_pos))
        + l1(1.75, d(gt_txy6), d(p_txy6))
        + l1(2.0, d(Qgt_pos), d(Qp_pos))
        + l1(0.75, d(Qgt_xfm), d(Qp_xfm))
    ).to(out_dtype)


def convert_YtilToX(Ytil, Ygnd_root, parents, compute_dtype=None):
    """Predicted parent-local Y (no root) + the ground-truth root row ->
    character-space X features, through quaternion FK over ancestor
    chains."""
    out_dtype = Ytil.dtype
    if compute_dtype is not None:
        Ytil = Ytil.to(compute_dtype)
        Ygnd_root = Ygnd_root.to(compute_dtype)
    b, t = Ytil.shape[:2]
    r_pos, r_txy, r_vel, r_ang = _split_channels(Ygnd_root)
    p_pos, p_txy, p_vel, p_ang = _split_channels(Ytil)

    pos = torch.cat([r_pos, p_pos], dim=2)
    txy = torch.cat([r_txy, p_txy], dim=2)
    rot = quat.from_xform_xy(txy)
    vel = torch.cat([r_vel, p_vel], dim=2)
    ang = torch.cat([r_ang, p_ang], dim=2)

    Grot, Gpos, Gvel, Gang = quat.fk_vel_chain_all(rot, pos, vel, ang,
                                                   parents)

    r = Grot[:, :, 0:1]
    Xpos = quat.inv_mul_vec(r, Gpos - Gpos[:, :, 0:1])
    Xtxy = quat.to_xform_xy(quat.inv_mul(r, Grot))
    Xvel = quat.inv_mul_vec(r, Gvel)
    Xang = quat.inv_mul_vec(r, Gang)

    j = Xpos.shape[2]
    return torch.cat([Xpos, Xtxy.reshape(b, t, j, 6), Xvel, Xang],
                     dim=-1).to(out_dtype)


def patch_nce_loss(feat_q, feat_k, temp: float = 0.07,
                   all_negatives_from_minibatch: bool = True,
                   batch_size: int = 1, compute_dtype=None,
                   gather_keys=None):
    """PatchNCE InfoNCE: the positive is the matching patch, the negatives
    every other patch of the (mini)batch, the diagonal filled with -10; the
    keys carry no gradient.  Returns (loss, logits).

    With negatives from the whole minibatch, a query's negatives are every
    sample's keys: a rank of a data-parallel step holding a block of the
    batch passes ``gather_keys(k) -> (every rank's keys, the offset of its
    own)``, k (1, patches, dim) normalized and detached, so that its rows'
    logits and loss terms are the single-process step's (the keys carry no
    gradient, so the mean of the ranks' gradients is then the global
    one)."""
    n, dim = feat_q.shape
    out_dtype = feat_q.dtype
    if compute_dtype is not None:
        feat_q = feat_q.to(compute_dtype)
        feat_k = feat_k.to(compute_dtype)
    # safe_sqrt: an exactly-zero projected patch must not give NaN grads
    feat_q = feat_q / safe_sqrt(torch.sum(torch.square(feat_q), dim=1,
                                          keepdim=True))
    feat_k = feat_k / safe_sqrt(torch.sum(torch.square(feat_k), dim=1,
                                          keepdim=True))
    feat_k = feat_k.detach()

    l_pos = torch.sum(feat_q * feat_k, dim=1, keepdim=True)   # (n, 1)

    bdim = 1 if all_negatives_from_minibatch else batch_size
    q = feat_q.reshape(bdim, -1, dim)
    k = feat_k.reshape(bdim, -1, dim)
    offset = 0
    if gather_keys is not None:
        if not all_negatives_from_minibatch:
            raise ValueError("patch_nce_loss: gather_keys needs negatives "
                             "from the whole minibatch")
        k, offset = gather_keys(k)
    nq, nk = q.shape[1], k.shape[1]
    l_neg = torch.einsum("bnd,bmd->bnm", q, k)
    eye = (torch.arange(nk, device=q.device)[None, :]
           == torch.arange(offset, offset + nq, device=q.device)[:, None])
    l_neg = torch.where(eye[None], torch.full_like(l_neg, -10.0),
                        l_neg).reshape(-1, nk)

    logits = torch.cat([l_pos, l_neg], dim=1) / temp
    # the positive is column 0
    loss = -torch.log_softmax(logits, dim=1)[:, 0]
    return loss.mean().to(out_dtype), logits.to(out_dtype)


def contrastive_acc(logits, topk=(1, 5)):
    """Top-k accuracy (percent) of the positive logit, column 0."""
    order = torch.argsort(-logits, dim=1, stable=True)
    return [100.0 * torch.mean(torch.any(order[:, :k] == 0, dim=1).float())
            for k in topk]


def kl_normal(mu_po, logvar_po, mu_pr, logvar_pr):
    """KL(q || p) for diagonal Gaussians, summed over the last axis and
    clamped at zero."""
    elt = 0.5 * (logvar_pr - logvar_po
                 + torch.exp(logvar_po) / torch.exp(logvar_pr)
                 + (mu_po - mu_pr) ** 2 / torch.exp(logvar_pr)
                 - 1.0)
    return torch.clamp(torch.sum(elt, dim=-1), min=0.0)
