"""The frame step's pose math as two CUDA kernels (``csrc/pose.cu``).

``runtime/stream.make_stream_step`` runs its step's pose math either
eagerly (``_roots_eager`` and ``_ik_eager`` there: about 1,300 PyTorch
launches a step) or through these two launches, one under each of the
step's ``stream.roots`` and ``stream.ik`` spans:

* :func:`pose_roots`: the source, CVAE-stream and NN-stream root
  integrations (with the two guarded hip-speed ratios) in the carry's
  dtype, and the poses with the root row cast to float32 at row 0;
* :func:`pose_ik`: both blends, and with the IK on, the FK of each leg,
  the contact state machine of both contact bones and the two-bone IK.

They do the eager code's arithmetic operation by operation (the source
says how), so the two routes agree to float32's rounding.  :func:`plan`
takes what the kernels need of the skeleton once, when the step is built,
or returns None for a skeleton they do not take (the step then stays
eager).  Each wrapper makes one call into the library, whose
``cudaGetLastError()`` it checks; :func:`outputs` allocates a step's
outputs of both, one buffer a dtype, carved into views.
``pose_roots.launches`` and ``pose_ik.launches`` count the launches (CPU
tensors never reach them), and ``eager_steps`` the steps on a card that
took the eager pose math instead.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Sequence

import torch

from ..kinematics.inertial import fast_negexpf, halflife_to_damping
from ..kinematics.quat import chain_to_root
from . import build

SOURCE = "pose.cu"
ROOTS_ENTRY = "mocha_pose_roots"
IK_ENTRY = "mocha_pose_ik"
MAX_CHAIN = 32       # joints from a root to a toe, at most (csrc kMaxChain)
ROOT_DTYPES = (torch.float32, torch.float64)

# What each C entry takes, in its order: the inputs as views (address and
# stream, joint and element strides), then the outputs' addresses, then the
# Python floats.  tests/test_torch_pose_kernels.py checks them against the
# source.
ROOTS_INPUTS = ("src_pos0", "src_rot0", "trans_pos0", "trans_rot0",
                "cm_pos0", "cm_rot0", "rvel", "rang", "pos_last",
                "rot_last", "vel_last", "ang_last", "hips_speed", "t_pos",
                "t_rot", "t_vel", "t_speed", "c_pos", "c_rot", "c_speed")
ROOTS_OUTPUTS = ("src_pos", "src_rot", "src_vel", "src_ang", "trans_pos",
                 "trans_rot", "trans_vel", "cm_pos", "cm_rot",
                 "new_src_pos0", "new_src_rot0", "new_trans_pos0",
                 "new_trans_rot0", "new_cm_pos0", "new_cm_rot0")
ROOTS_SCALARS = ("dt",)
IK_INPUTS = ("ik_prev_pos", "trans_prev_pos", "trans_pos", "trans_vel",
             "trans_rot", "contact_last", "state", "lock", "position",
             "velocity", "point", "target", "offset_position",
             "offset_velocity")
IK_OUTPUTS = ("ik_pos", "trans_blended", "ik_rot", "new_state", "new_lock",
              "new_position", "new_velocity", "new_point", "new_target",
              "new_offset_position", "new_offset_velocity")
IK_SCALARS = ("dt", "max_length_buffer", "foot_height", "unlock_radius",
              "damping", "eydt", "dt_eps")
# contact_update's eps, and its spring's constants as decay_spring_damper_pos
# works them out on the host
CONTACT_EPS = 1e-8


class Plan(NamedTuple):
    """What the kernels take of one step's constants, made once."""

    chains: ctypes.Array        # both chains' lengths, then their joints
    roots_scalars: ctypes.Array
    ik_scalars: ctypes.Array
    ik: int                     # 0: the IK kernel only blends
    joints: int


def leg_chains(parents: Sequence[int], contact_bones: Sequence[int]):
    """Each contact bone's chain from its root, or None where the kernels
    cannot take the skeleton: two contact bones, every joint after its
    parent (``parents[j] < j``), chains of 5 to MAX_CHAIN joints (root ..
    hip's parent, hip, knee, heel, toe) and four distinct hips and knees."""
    parents = tuple(int(p) for p in parents)
    if len(contact_bones) != 2 or any(p >= j for j, p in
                                      enumerate(parents)):
        return None
    chains = []
    for toe in contact_bones:
        if not 0 <= int(toe) < len(parents):
            return None
        chain = chain_to_root(parents, int(toe))
        if not 5 <= len(chain) <= MAX_CHAIN:
            return None
        chains.append(chain)
    if len({c[-4] for c in chains} | {c[-3] for c in chains}) != 4:
        return None
    return chains


def plan(parents, contact_bones, *, dt, ik_enabled, max_length_buffer,
         foot_height, unlock_radius, blending_halflife) -> Optional[Plan]:
    """The kernels' constants for a step, or None (see :func:`leg_chains`)."""
    chains = leg_chains(parents, contact_bones)
    if chains is None:
        return None
    ints = [len(c) for c in chains] + [j for c in chains for j in c]
    damping = halflife_to_damping(blending_halflife) / 2.0
    ik_scalars = (dt, max_length_buffer, foot_height, unlock_radius, damping,
                  fast_negexpf(damping * dt), dt + CONTACT_EPS)
    return Plan((ctypes.c_int * len(ints))(*ints),
                (ctypes.c_double * 1)(dt),
                (ctypes.c_double * len(ik_scalars))(*ik_scalars),
                int(bool(ik_enabled)), len(parents))


# each entry's views and output addresses, packed as int64s
_ROOTS_ARGS = struct.Struct(f"{4 * len(ROOTS_INPUTS) + len(ROOTS_OUTPUTS)}q")
_IK_ARGS = struct.Struct(f"{4 * len(IK_INPUTS) + len(IK_OUTPUTS)}q")


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load ``csrc/pose.cu``; (roots, ik) entries."""
    lib = build.load(SOURCE)
    roots, ik = getattr(lib, ROOTS_ENTRY), getattr(lib, IK_ENTRY)
    # the packed views go in as bytes
    roots.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    ik.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    roots.restype = ik.restype = ctypes.c_int
    return roots, ik


def _views(tensors, out):
    """Append each tensor's address and its (stream, joint, element)
    strides (0 for a dimension it lacks)."""
    for t in tensors:
        st = t.stride()
        n = len(st)
        out += (t.data_ptr(), st[0], st[1] if n == 3 else 0,
                st[-1] if n > 1 else 0)
    return out


class Outputs(NamedTuple):
    """A step's outputs of both kernels, carved from one buffer a dtype
    (float32, the roots' dtype, bool): the tensors of ROOTS_OUTPUTS and of
    IK_OUTPUTS (with the IK off, ik_pos and trans_blended alone), each
    contiguous, and their addresses in each entry's order."""

    roots: tuple
    ik: tuple
    roots_ptrs: list
    ik_ptrs: list


_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


@functools.lru_cache(maxsize=64)
def _layout(S, J, ik, root_size):
    """Each buffer's size in elements, and each output's (buffer, byte
    offset) in entry order.  float32: 8 (S, J, 3) rows (src_pos, src_vel,
    src_ang, trans_pos, trans_vel, cm_pos, ik_pos, trans_blended) then 3 or
    4 (S, J, 4) (src_rot, trans_rot, cm_rot, ik_rot); roots' dtype: 3 (S, 3)
    (the src, trans and cm positions), 3 (S, 4) (their rotations), then
    with the IK on the contact state's 6 (S, 2, 3) vectors; bool: its 2
    (S, 2) flags."""
    vec = [(0, i * S * J * 3 * 4) for i in range(8)]
    rot = [(0, 8 * S * J * 3 * 4 + i * S * J * 4 * 4) for i in range(4)]
    pos0 = [(1, i * S * 3 * root_size) for i in range(3)]
    rot0 = [(1, (9 + i * 4) * S * root_size) for i in range(3)]
    vecs = [(1, (21 + i * 6) * S * root_size) for i in range(6)]
    flags = [(2, i * S * 2) for i in range(2)]
    roots_at = [vec[0], rot[0], vec[1], vec[2], vec[3], rot[1], vec[4],
                vec[5], rot[2], pos0[0], rot0[0], pos0[1], rot0[1], pos0[2],
                rot0[2]]
    ik_at = [vec[6], vec[7]] + ([rot[3]] + flags + vecs if ik else [])
    sizes = (S * J * (8 * 3 + (4 if ik else 3) * 4),
             S * (21 + (36 if ik else 0)), 4 * S if ik else 0)
    return sizes, roots_at, ik_at


def outputs(p: Plan, S: int, root_dtype, device) -> Outputs:
    """One step's outputs of :func:`pose_roots` and :func:`pose_ik`: a
    buffer a dtype, carved into views."""
    J = p.joints
    sizes, roots_at, ik_at = _layout(S, J, p.ik, _ITEMSIZE[root_dtype])
    f = torch.empty(sizes[0], dtype=torch.float32, device=device)
    r = torch.empty(sizes[1], dtype=root_dtype, device=device)
    split = 8 * S * J * 3
    vec = f[:split].view(8, S, J, 3).unbind(0)
    rot = f[split:].view(-1, S, J, 4).unbind(0)
    pos0 = r[:9 * S].view(3, S, 3).unbind(0)
    rot0 = r[9 * S:21 * S].view(3, S, 4).unbind(0)
    roots = (vec[0], rot[0], vec[1], vec[2], vec[3], rot[1], vec[4],
             vec[5], rot[2], pos0[0], rot0[0], pos0[1], rot0[1], pos0[2],
             rot0[2])
    ik = (vec[6], vec[7])
    bases = [f.data_ptr(), r.data_ptr(), 0]
    if p.ik:
        b = torch.empty(sizes[2], dtype=torch.bool, device=device)
        bases[2] = b.data_ptr()
        ik += ((rot[3],) + b.view(2, S, 2).unbind(0)
               + r[21 * S:].view(6, S, 2, 3).unbind(0))
    return Outputs(roots, ik, [bases[i] + o for i, o in roots_at],
                   [bases[i] + o for i, o in ik_at]
                   + [0] * (len(IK_OUTPUTS) - len(ik_at)))


def _call(name, fn, index, *args):
    """One call into the library on device ``index``'s current stream."""
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return _call(name, fn, index, *args)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def pose_roots(p: Plan, inputs, out: Outputs):
    """The three root integrations and the assembled poses, into ``out``
    (:func:`outputs`).  ``inputs``: the tensors of ROOTS_INPUTS, in order
    (roots in the carry's dtype, poses float32, the decoded rows J - 1 of
    them).  Returns the ROOTS_OUTPUTS: src_pos, src_rot, src_vel, src_ang,
    trans_pos, trans_rot, trans_vel, cm_pos, cm_rot (S, J, 3|4) float32,
    then the six new root carries (S, 3|4) in the carry's dtype."""
    roots_fn, _ = load_library()
    r = inputs[0]
    args = _views(inputs, [])
    args += out.roots_ptrs
    _call("pose_roots", roots_fn, r.get_device(),
          int(r.dtype == torch.float64), _ROOTS_ARGS.pack(*args),
          p.roots_scalars, r.shape[0], p.joints)
    pose_roots.launches += 1
    return out.roots


def pose_ik(p: Plan, inputs, out: Outputs):
    """Both blends and, with the IK on, the contact state machine and the
    two-bone IK of both legs, into ``out`` (:func:`outputs`).  ``inputs``:
    the tensors of IK_INPUTS, in order (blends and the assembled
    CVAE-stream pose float32, the contact state's flags bool and vectors in
    the carry's dtype).  Returns (ik_pos, trans_blended, ik_rot, contact
    fields: state, lock, position, velocity, point, target,
    offset_position, offset_velocity); with the IK off, ik_rot and the
    contact fields are None (the eager step then passes ``trans_rot`` and
    the carried state on)."""
    _, ik_fn = load_library()
    prev, cs = inputs[0], inputs[8]
    args = _views(inputs, [])
    args += out.ik_ptrs
    _call("pose_ik", ik_fn, prev.get_device(), int(cs.dtype == torch.float64),
          _IK_ARGS.pack(*args), p.ik_scalars, p.chains, prev.shape[0],
          p.joints, p.ik)
    pose_ik.launches += 1
    if not p.ik:
        return out.ik[0], out.ik[1], None, None
    return out.ik[0], out.ik[1], out.ik[2], out.ik[3:]


pose_roots.launches = 0
pose_ik.launches = 0
# steps on a card whose pose math went eager (runtime/stream._pose_route):
# a skeleton or tensors the kernels do not take
eager_steps = 0
