"""The port's quaternion ops, FK/IK and contact springs against JAX.

Same inputs (NumPy, from a seed) through mocha_sigasia2023_tpu.kinematics
and mocha_sigasia2023_torch.kinematics, held at atol 1e-5 (float32); the
IK solvers and the whole-pose inertializer at 2e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.data.synthetic import MOCHA_PARENTS  # noqa: E402
from mocha_sigasia2023_tpu.kinematics import inertial as jin  # noqa: E402
from mocha_sigasia2023_tpu.kinematics import quat as jq  # noqa: E402

from mocha_sigasia2023_torch.kinematics import inertial as tin  # noqa: E402
from mocha_sigasia2023_torch.kinematics import quat as tq  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5
PARENTS = np.concatenate([[-1], MOCHA_PARENTS + 1])   # the 25-bone rig


def _rng(seed):
    return np.random.RandomState(seed)


def _quats(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _same(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                               atol=atol, rtol=0)


def _both(fn_name, *args, module=(tq, jq), **kw):
    t = getattr(module[0], fn_name)(*(torch.as_tensor(a) for a in args), **kw)
    j = getattr(module[1], fn_name)(*(jnp.asarray(a) for a in args), **kw)
    return t, j


@pytest.mark.parametrize("name", ["mul", "inv_mul", "mul_inv"])
def test_quat_products(name):
    rng = _rng(0)
    a, b = _quats(rng, 8, 25), _quats(rng, 8, 25)
    t, j = _both(name, a, b)
    _same(t, j)


@pytest.mark.parametrize("name", ["mul_vec", "inv_mul_vec"])
def test_quat_vector_rotation(name):
    rng = _rng(1)
    q, v = _quats(rng, 8, 25), rng.randn(8, 25, 3).astype(np.float32)
    t, j = _both(name, q, v)
    _same(t, j)


@pytest.mark.parametrize("name", ["abs_", "normalize", "inv",
                                  "to_xform_xy", "to_scaled_angle_axis"])
def test_quat_unary(name):
    rng = _rng(2)
    q = rng.randn(64, 4).astype(np.float32)
    if name == "to_scaled_angle_axis":
        q = _quats(rng, 64)
        q[0] = [1.0, 0.0, 0.0, 0.0]           # the identity edge
    t, j = _both(name, q)
    _same(t, j)


def test_from_xform_xy_and_scaled_angle_axis():
    rng = _rng(3)
    xy = rng.randn(64, 3, 2).astype(np.float32)
    t, j = _both("from_xform_xy", xy)
    _same(t, j)
    v = rng.randn(64, 3).astype(np.float32)
    v[0] = 0.0
    t, j = _both("from_scaled_angle_axis", v)
    _same(t, j)
    q = _quats(rng, 64)
    t, j = _both("log", q)
    _same(t, j)
    t, j = _both("exp", v * 0.3)
    _same(t, j)


@pytest.mark.parametrize("order", ["zyx", "xyz", "yzx"])
def test_from_euler(order):
    e = _rng(4).uniform(-3, 3, (32, 24, 3)).astype(np.float32)
    t, j = _both("from_euler", e, order=order)
    _same(t, j)


def test_unroll_and_between():
    rng = _rng(5)
    q = _quats(rng, 40, 6)
    q[::3] *= -1.0
    _same(tq.unroll(torch.as_tensor(q), dim=0),
          jq.unroll(jnp.asarray(q), axis=0))
    u, v = rng.randn(16, 3).astype(np.float32), rng.randn(16, 3).astype(
        np.float32)
    t, j = _both("between", u, v)
    _same(t, j)


def _pose(seed, lead=(6,)):
    rng = _rng(seed)
    J = len(PARENTS)
    return (_quats(rng, *lead, J), rng.randn(*lead, J, 3).astype(np.float32)
            * 0.3, rng.randn(*lead, J, 3).astype(np.float32),
            rng.randn(*lead, J, 3).astype(np.float32))


def test_fk_ik_fk_vel():
    rot, pos, vel, ang = _pose(6, (4, 5))
    t = tq.fk(torch.as_tensor(rot), torch.as_tensor(pos), PARENTS)
    j = jq.fk(jnp.asarray(rot), jnp.asarray(pos), PARENTS)
    for a, b in zip(t, j):
        _same(a, b)
    t_ik = tq.ik(*t, PARENTS)
    j_ik = jq.ik(*j, PARENTS)
    for a, b in zip(t_ik, j_ik):
        _same(a, b)
    args = [rot, pos, vel, ang]
    t = tq.fk_vel(*(torch.as_tensor(a) for a in args), PARENTS)
    j = jq.fk_vel(*(jnp.asarray(a) for a in args), PARENTS)
    for a, b in zip(t, j):
        _same(a, b, atol=5e-5 * max(1.0, float(np.abs(np.asarray(b)).max())))


@pytest.mark.parametrize("bone", [5, 24, 16])
def test_fk_vel_bone(bone):
    args = _pose(7)
    t = tq.fk_vel_bone(*(torch.as_tensor(a) for a in args), PARENTS, bone)
    j = jq.fk_vel_bone(*(jnp.asarray(a) for a in args), PARENTS, bone)
    for a, b in zip(t, j):
        _same(a, b)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_eye(shape):
    t = tq.eye(shape)
    j = jq.eye(shape)
    assert t.shape == j.shape and t.dtype == torch.float32
    _same(t, j, atol=0)


def test_fk_chain_all_matches_jax_and_fk():
    rot, pos, _, _ = _pose(9, (3, 4))
    t = tq.fk_chain_all(torch.as_tensor(rot), torch.as_tensor(pos), PARENTS)
    j = jq.fk_chain_all(jnp.asarray(rot), jnp.asarray(pos), PARENTS)
    for a, b, c in zip(t, j, tq.fk(torch.as_tensor(rot),
                                   torch.as_tensor(pos), PARENTS)):
        _same(a, b)
        _same(a, c)


@pytest.mark.parametrize("bone", [0, 5, 17, 24])
def test_fk_chain(bone):
    rot, pos, _, _ = _pose(10, (6,))
    t = tq.fk_chain(torch.as_tensor(rot), torch.as_tensor(pos), PARENTS,
                    bone)
    j = jq.fk_chain(jnp.asarray(rot), jnp.asarray(pos), PARENTS, bone)
    assert list(t) == list(j)
    for joint in j:
        for a, b in zip(t[joint], j[joint]):
            _same(a, b)


def test_ik_two_bone():
    """A leg chain (hip, knee, heel) with reachable and out-of-reach
    targets, as the stream step's foot fixup gives it."""
    rng = _rng(8)
    n = 32
    root = rng.randn(n, 3).astype(np.float32) * 0.1
    mid = root + np.array([0.0, -0.42, 0.05], np.float32) \
        + rng.randn(n, 3).astype(np.float32) * 0.02
    end = mid + np.array([0.0, -0.40, -0.03], np.float32) \
        + rng.randn(n, 3).astype(np.float32) * 0.02
    target = end + rng.randn(n, 3).astype(np.float32) * 0.1
    target[::4] = root[::4] + np.array([0.0, -1.2, 0.0], np.float32)
    fwd = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    rots = [_quats(rng, n) for _ in range(5)]
    args = rots[:2] + [root, mid, end, target, fwd] + rots[2:]
    t = tq.ik_two_bone(*(torch.as_tensor(a) for a in args), 0.015)
    j = jq.ik_two_bone(*(jnp.asarray(a) for a in args), 0.015)
    for a, b in zip(t, j):
        _same(a, b, atol=2e-5)


def test_contact_update_trajectory():
    """80 ticks of the lock/unlock machine for 3 streams x 2 feet, with
    contacts that switch and positions that drift past the unlock radius."""
    rng = _rng(9)
    S, F, T = 3, 2, 80
    p0 = rng.randn(S, F, 3).astype(np.float32) * 0.1
    cs_t = tin.ContactState.init(torch.as_tensor(p0))
    cs_j = jin.ContactState.init(jnp.asarray(p0))
    pos = p0
    for i in range(T):
        pos = pos + rng.randn(S, F, 3).astype(np.float32) * 0.03
        state = rng.rand(S, F) < (0.7 if (i // 10) % 2 else 0.2)
        cs_t = tin.contact_update(cs_t, torch.as_tensor(pos),
                                  torch.as_tensor(state), 0.2, 0.02, 0.1,
                                  1.0 / 60.0)
        cs_j = jin.contact_update(cs_j, jnp.asarray(pos), jnp.asarray(state),
                                  0.2, 0.02, 0.1, 1.0 / 60.0)
        for a, b in zip(cs_t, cs_j):
            if a.dtype == torch.bool:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _same(a, b, atol=1e-4)


def test_spring_helpers():
    rng = _rng(10)
    x, v = rng.randn(8, 3).astype(np.float32), rng.randn(8, 3).astype(
        np.float32)
    t = tin.decay_spring_damper_pos(torch.as_tensor(x), torch.as_tensor(v),
                                    0.1, 1.0 / 60.0)
    j = jin.decay_spring_damper_pos(jnp.asarray(x), jnp.asarray(v), 0.1,
                                    1.0 / 60.0)
    for a, b in zip(t, j):
        _same(a, b)
    q = _quats(rng, 8)
    t = tin.decay_spring_damper_rot(torch.as_tensor(q), torch.as_tensor(v),
                                    0.1, 1.0 / 60.0)
    j = jin.decay_spring_damper_rot(jnp.asarray(q), jnp.asarray(v), 0.1,
                                    1.0 / 60.0)
    for a, b in zip(t, j):
        _same(a, b)


def test_ik_look_at():
    """A joint aimed at targets around it, with a quarter of the targets
    already on the child's line (the rotation is then kept)."""
    rng = _rng(11)
    n = 32
    bone, parent_g, glob = (_quats(rng, n) for _ in range(3))
    pos = rng.randn(n, 3).astype(np.float32)
    child = pos + rng.randn(n, 3).astype(np.float32) * 0.3
    target = pos + rng.randn(n, 3).astype(np.float32)
    target[::4] = pos[::4] + 2.0 * (child[::4] - pos[::4])
    t, j = _both("ik_look_at", bone, parent_g, glob, pos, child, target)
    _same(t, j, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(t)[::4], bone[::4])


def _pose_offsets(rng, lead, J):
    return [rng.randn(*lead, J, 3).astype(np.float32) * 0.1,
            rng.randn(*lead, J, 3).astype(np.float32) * 0.1,
            _quats(rng, *lead, J),
            rng.randn(*lead, J, 3).astype(np.float32) * 0.1]


@pytest.mark.parametrize("shape_j", [25, (3, 25)])
def test_pose_offsets_zeros(shape_j):
    t = tin.PoseOffsets.zeros(shape_j)
    j = jin.PoseOffsets.zeros(shape_j)
    for a, b in zip(t, j):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _same(a, b, atol=0)


def test_pose_transition_and_update():
    """A transition between two seeded poses of the 25-bone rig for 4
    streams, then 5 ticks of the inertializer toward a third, from seeded
    offsets."""
    rng = _rng(12)
    lead, J = (4,), len(PARENTS)
    off = _pose_offsets(rng, lead, J)
    root = [rng.randn(*lead, 3).astype(np.float32), rng.randn(*lead, 3)
            .astype(np.float32), _quats(rng, *lead),
            rng.randn(*lead, 3).astype(np.float32)]
    src = _pose_offsets(rng, lead, J)
    dst = _pose_offsets(rng, lead, J)
    args = root + src + dst

    t_off, t_tr = tin.pose_transition(
        tin.PoseOffsets(*map(torch.as_tensor, off)),
        *map(torch.as_tensor, args))
    j_off, j_tr = jin.pose_transition(
        jin.PoseOffsets(*map(jnp.asarray, off)), *map(jnp.asarray, args))
    for a, b in zip((*t_off, *t_tr), (*j_off, *j_tr)):
        _same(a, b, atol=2e-5)

    for tick in range(5):
        pose = _pose_offsets(rng, lead, J)
        t_out = tin.pose_update(t_off, *map(torch.as_tensor, pose), t_tr,
                                0.1, 1.0 / 60.0)
        j_out = jin.pose_update(j_off, *map(jnp.asarray, pose), j_tr, 0.1,
                                1.0 / 60.0)
        for a, b in zip((*t_out[:4], *t_out[4]), (*j_out[:4], *j_out[4])):
            _same(a, b, atol=2e-5)
        t_off, j_off = t_out[4], j_out[4]


def test_rotation_spring_transition_and_update():
    rng = _rng(13)
    q = [_quats(rng, 8) for _ in range(3)]
    v = [rng.randn(8, 3).astype(np.float32) for _ in range(3)]
    t, j = _both("transition_rot", q[0], v[0], q[1], v[1], q[2], v[2],
                 module=(tin, jin))
    for a, b in zip(t, j):
        _same(a, b)
    t = tin.update_rot(*(torch.as_tensor(a) for a in (q[0], v[0], q[1],
                                                      v[1])), 0.1, 1 / 60.0)
    j = jin.update_rot(*(jnp.asarray(a) for a in (q[0], v[0], q[1], v[1])),
                       0.1, 1 / 60.0)
    for a, b in zip(t, j):
        _same(a, b)
