"""The port's differentiable FK against the JAX package: the six functions
of kinematics/xform.py and quat.fk_vel_chain_all, in value and in
gradient (jax.grad), on the 25-joint training skeleton.  Bars: 1e-5 in
value (float32 elementwise 3x3 products over at most 8 chain steps), 1e-4
relative and 1e-5 x the largest gradient in gradient
(tests/test_train.py:210's bar)."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.kinematics import quat as jquat  # noqa: E402
from mocha_sigasia2023_tpu.kinematics import xform as jxform  # noqa: E402

from mocha_sigasia2023_torch.kinematics import quat as tquat  # noqa: E402
from mocha_sigasia2023_torch.kinematics import xform as txform  # noqa: E402

torch.set_num_threads(2)
PARENTS = [-1, 0, 1, 2, 3, 4, 1, 6, 7, 8, 9, 10, 11, 12, 9, 14, 15, 9, 17,
           18, 19, 1, 21, 22, 23]
VALUE_TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _rot(rng, shape):
    """Random rotation matrices (..., 3, 3) from normalized quaternions."""
    q = rng.randn(*shape, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jquat.to_xform(jnp.asarray(q)), np.float32)


def _grad_close(tg, jg):
    tg, jg = np.asarray(tg), np.asarray(jg)
    gscale = float(np.abs(jg).max())
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5 * gscale)


def _inputs(name, rng):
    if name in ("mul", "inv_mul"):
        return _rot(rng, (4, 5)), _rot(rng, (4, 5))
    if name in ("mul_vec", "inv_mul_vec"):
        return _rot(rng, (4, 5)), rng.randn(4, 5, 3).astype(np.float32)
    return (rng.randn(4, 5, 3, 2).astype(np.float32),)


@pytest.mark.parametrize("name", ["mul", "mul_vec", "inv_mul",
                                  "inv_mul_vec", "from_xy"])
def test_xform_ops_match_jax(name):
    args = _inputs(name, _rng(1))
    jf, tf = getattr(jxform, name), getattr(txform, name)
    want = np.asarray(jf(*(jnp.asarray(a) for a in args)))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = tf(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=VALUE_TOL)
    # gradient of a fixed random projection of the output
    w = _rng(2).randn(*want.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) * w),
                      argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    torch.sum(got * torch.as_tensor(w)).backward()
    for t, j in zip(targs, jgrads):
        _grad_close(t.grad.numpy(), j)


def _chain_inputs(rng, rot_form):
    B, T, J = 2, 3, len(PARENTS)
    rot = (_rot(rng, (B, T, J)) if rot_form == "xform" else
           (lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True))(
               rng.randn(B, T, J, 4).astype(np.float32)))
    vecs = [rng.randn(B, T, J, 3).astype(np.float32) for _ in range(3)]
    return [rot] + vecs


@pytest.mark.parametrize("which", ["xform.fk_vel", "quat.fk_vel_chain_all"])
def test_chain_fk_matches_jax_in_value_and_gradient(which):
    mod, name = which.split(".")
    rot_form = "xform" if mod == "xform" else "quat"
    args = _chain_inputs(_rng(3), rot_form)
    jf = getattr(jxform if mod == "xform" else jquat, name)
    tf = getattr(txform if mod == "xform" else tquat, name)
    jout = jf(*(jnp.asarray(a) for a in args), PARENTS)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tf(*targs, PARENTS)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=VALUE_TOL * 10)
    ws = [_rng(4 + i).randn(*np.shape(j)).astype(np.float32)
          for i, j in enumerate(jout)]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jf(*a, PARENTS), ws))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    sum(torch.sum(o * torch.as_tensor(w)) for o, w in zip(tout, ws)
        ).backward()
    for t, j in zip(targs, jgrads):
        _grad_close(t.grad.numpy(), j)


def test_chain_fk_equals_the_level_form():
    """The serving path's level-scheduled quat.fk_vel and the losses' chain
    form give the same values and the same gradients."""
    args = _chain_inputs(_rng(5), "quat")
    outs, grads = [], []
    for fn in (tquat.fk_vel, tquat.fk_vel_chain_all):
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        out = fn(*targs, PARENTS)
        sum(torch.sum(o * torch.as_tensor(
            _rng(6 + i).randn(*o.shape).astype(np.float32)))
            for i, o in enumerate(out)).backward()
        outs.append([o.detach().numpy() for o in out])
        grads.append([t.grad.numpy() for t in targs])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=VALUE_TOL * 10)
    for a, b in zip(*grads):
        _grad_close(a, b)
