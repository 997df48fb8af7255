"""The frame step's pose kernels (``ops/pose``, ``csrc/pose.cu``).

On the CPU: the route the step takes (every CPU step, bf16 poses, a
skeleton the kernels do not take and tensors to differentiate go eager,
and the launch counters do not move), the wrappers' argument order
against the C entries (by a scan of the source), the plan's chains and
the wrappers' buffers.

On a card (``card`` tests, skipped on a host without one): the kernel
route held to the eager route over 240 steps, each route carrying its own
state, at S = 1, 64 and 256 streams, float32 and float64 roots, with and
without the NN stream's own decode and with the IK on and off, on inputs
that drive every contact transition, both sides of the hip-speed guard
(a non-finite ratio too) and legs asked past their reach; and the two
facts of PyTorch's CUDA arithmetic that the kernels copy.  Run them on the
card with ``python -m pytest --noconftest tests/test_torch_pose_kernels.py``
(the suite's conftest imports JAX, which that machine lacks).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mocha_sigasia2023_torch.kinematics import quat  # noqa: E402
from mocha_sigasia2023_torch.kinematics.inertial import (  # noqa: E402
    ContactState)
from mocha_sigasia2023_torch.ops import build, pose  # noqa: E402
from mocha_sigasia2023_torch.runtime import stream  # noqa: E402
from mocha_sigasia2023_torch.runtime.pose_frames import (  # noqa: E402
    CONTACT_BONES, DT, PARENTS, Frames, J, make_plan, pose_step)

STEPS = 240


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _cpu_step_inputs(S=3, root_dtype=torch.float64, seed=1):
    f = Frames(S, seed, torch.device("cpu"))
    t = f.decoded()
    return f.carry(root_dtype), f.x(), t, f.decoded()


def test_plan_takes_the_featurized_skeleton_and_its_foot_chains():
    p = make_plan()
    assert p is not None and p.joints == J and p.ik == 1
    chains = pose.leg_chains(PARENTS, CONTACT_BONES)
    assert chains == [(0, 1, 2, 3, 4, 5), (0, 1, 21, 22, 23, 24)]
    assert list(p.chains) == [6, 6, 0, 1, 2, 3, 4, 5, 0, 1, 21, 22, 23, 24]
    # the eager IK's chains: toes, heels, knees, hips, the hips' parents
    toes, heels, knees, hips, roots = stream._foot_chains(PARENTS,
                                                          CONTACT_BONES)
    for leg, c in enumerate(chains):
        assert c[-5:] == (roots[leg], hips[leg], knees[leg], heels[leg],
                          toes[leg])
    assert make_plan(stream.IKConfig(enabled=False)).ik == 0


@pytest.mark.parametrize("parents,bones", [
    ((-1, 0, 3, 1, 2, 4, 5, 6), (6, 7)),           # a child before its parent
    (PARENTS, (5,)),                               # one contact bone
    (PARENTS, (5, 24, 13)),                        # three
    (PARENTS, (3, 24)),                            # a chain of 4 joints
    (PARENTS, (5, 5)),                             # one leg twice
    (PARENTS, (5, 25)),                            # no such joint
])
def test_plan_refuses_what_the_kernels_do_not_take(parents, bones):
    assert make_plan(parents=parents, bones=bones) is None


def test_the_route_takes_only_what_the_kernels_take():
    p = make_plan()
    carry, x, t, c = _cpu_step_inputs()
    assert stream._pose_kernels_take(p, carry, x, t, c)
    # a CPU step, or no plan, goes eager, and is no eager step on a card
    eager = pose.eager_steps
    assert stream._pose_route(p, carry, x, t, c) == "eager"
    assert stream._pose_route(None, carry, x, t, c) == "eager"
    assert pose.eager_steps == eager
    bf16 = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                 for a in t)
    assert not stream._pose_kernels_take(p, carry, x, bf16, c)
    assert not stream._pose_kernels_take(p, carry, x, t, bf16)
    assert not stream._pose_kernels_take(
        p, carry, dict(x, pos_last=x["pos_last"].bfloat16()), t, c)
    half = carry._replace(**{k: getattr(carry, k).half() for k in (
        "src_pos0", "src_rot0", "trans_pos0", "trans_rot0", "cm_pos0",
        "cm_rot0")})
    assert not stream._pose_kernels_take(p, half, x, t, c)
    mixed = carry._replace(cm_pos0=carry.cm_pos0.float())
    assert not stream._pose_kernels_take(p, mixed, x, t, c)
    fewer = dict(x, hips_speed_mean=x["hips_speed_mean"][:2])
    assert not stream._pose_kernels_take(p, carry, fewer, t, c)
    joints = carry._replace(ik_prev_pos=carry.ik_prev_pos[:, :-1])
    assert not stream._pose_kernels_take(p, joints, x, t, c)
    grad = (t[0].clone().requires_grad_(),) + t[1:]
    assert not stream._pose_kernels_take(p, carry, x, grad, c)
    with torch.no_grad():
        assert stream._pose_kernels_take(p, carry, x, grad, c)


def _entry(text, name):
    start = text.index(f'extern "C" int {name}(')
    end = text.find('extern "C"', start + 1)
    return text[start:end if end > 0 else None]


def test_the_wrappers_hand_the_c_entries_their_arguments_in_order():
    """The views, outputs and Python floats each wrapper builds are what
    each C entry takes, in its order; the ctypes signatures have as many
    arguments as the entries."""
    path = os.path.join(build.CSRC_DIR, pose.SOURCE)
    assert build.local_files(pose.SOURCE) == [path]   # no local header
    with open(path) as f:
        text = f.read()
    for entry, inputs, outputs, scalars, nargs in (
            (pose.ROOTS_ENTRY, pose.ROOTS_INPUTS, pose.ROOTS_OUTPUTS,
             pose.ROOTS_SCALARS, 6),
            (pose.IK_ENTRY, pose.IK_INPUTS, pose.IK_OUTPUTS,
             pose.IK_SCALARS, 8)):
        body = _entry(text, entry)
        assert tuple(re.findall(r"a\.(\w+) = take_view\(c\);", body)) \
            == inputs
        assert tuple(re.findall(r"a\.(\w+) = take_out\(c\);", body)) \
            == outputs
        read = re.findall(r"a\.(\w+) = scalars\[(\d+)\];", body)
        assert tuple(n for n, _ in read) == scalars
        assert [int(i) for _, i in read] == list(range(len(scalars)))
        params = body[body.index("(") + 1:body.index(")")]
        assert len(params.split(",")) == nargs
    # the views the step hands each wrapper, in the same order
    src = open(stream.__file__).read()
    roots = src[src.index("def _roots_kernel("):src.index("def _ik_kernel(")]
    assert re.findall(r'x\["(\w+)"\]', roots) == [
        "rvel_last", "rang_last", "pos_last", "rot_last", "vel_last",
        "ang_last", "hips_speed_mean"]
    assert list(stream.StreamCarry._fields[:2]) == ["src_pos0", "src_rot0"]
    assert list(stream.PoseRoots._fields) == [
        n.replace("new_", "") for n in pose.ROOTS_OUTPUTS]
    assert list(ContactState._fields) == list(pose.IK_INPUTS[6:])
    assert [f"new_{n}" for n in ContactState._fields] \
        == list(pose.IK_OUTPUTS[3:])


def test_the_source_rounds_every_operation_and_builds_without_fast_math():
    """Every arithmetic operation goes through a rounding intrinsic, which
    nvcc never contracts into an FMA, and the source builds with the
    default flags (no fast math), under a library name of its own."""
    with open(os.path.join(build.CSRC_DIR, pose.SOURCE)) as f:
        text = f.read()
    for fn in ("__fadd_rn", "__dadd_rn", "__fsub_rn", "__dsub_rn",
               "__fmul_rn", "__dmul_rn", "__fdiv_rn", "__ddiv_rn",
               "__fsqrt_rn", "__dsqrt_rn"):
        assert fn in text, fn
    assert "fast_math" not in text and "fmaf" not in text
    assert build.flags(pose.SOURCE) == build.NVCC_FLAGS
    assert not any("fast" in f or "fmad" in f for f in build.NVCC_FLAGS)
    assert os.path.basename(build.library_path(pose.SOURCE)).startswith(
        "libpose_")


@pytest.mark.parametrize("ik_on", [True, False], ids=["ik", "no_ik"])
@pytest.mark.parametrize("root_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_carve_and_view_lay_out_what_the_entries_read(root_dtype, ik_on):
    """A step's outputs: one buffer a dtype, every output a contiguous view
    of its shape and dtype, the addresses handed to each entry its views',
    in the entry's order, and no two outputs overlapping."""
    S = 3
    p = make_plan(stream.IKConfig(enabled=ik_on))
    out = pose.outputs(p, S, root_dtype, "cpu")
    vec, rot = (S, J, 3), (S, J, 4)
    want_roots = [(vec, torch.float32), (rot, torch.float32)] + [
        (vec, torch.float32)] * 3 + [(rot, torch.float32)] + [
        (vec, torch.float32)] * 2 + [(rot, torch.float32)] + [
        ((S, 3), root_dtype), ((S, 4), root_dtype)] * 3
    want_ik = [(vec, torch.float32)] * 2 + ([(rot, torch.float32)] + [
        ((S, 2), torch.bool)] * 2 + [((S, 2, 3), root_dtype)] * 6
        if ik_on else [])
    for tensors, ptrs, want, n in (
            (out.roots, out.roots_ptrs, want_roots, len(pose.ROOTS_OUTPUTS)),
            (out.ik, out.ik_ptrs, want_ik, len(pose.IK_OUTPUTS))):
        assert [(tuple(t.shape), t.dtype) for t in tensors] == want
        assert all(t.is_contiguous() for t in tensors)
        assert len(ptrs) == n
        assert ptrs[:len(tensors)] == [t.data_ptr() for t in tensors]
        assert ptrs[len(tensors):] == [0] * (n - len(tensors))
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in out.roots + out.ik)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert len({t.untyped_storage().data_ptr() for t in out.roots + out.ik}) \
        == (3 if ik_on else 2)
    block = torch.zeros(4, J - 1, 15)
    views = pose._views((block[..., 9:12], torch.zeros(4, 3)[:, 1:],
                         torch.zeros(4)), [])
    assert views[1:4] == [(J - 1) * 15, 15, 1]
    assert views[5:8] == [3, 0, 1]
    assert views[9:12] == [1, 0, 0]


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the pose kernels run on a CUDA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    """max |a - b| over the larger of 1 and max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _world(rot, pos):
    return quat.fk(rot.double(), pos.double(), PARENTS)[1]


@pytest.mark.card
@pytest.mark.parametrize("ik_on", [True, False], ids=["ik", "no_ik"])
@pytest.mark.parametrize("compute_cm", [True, False], ids=["cm", "no_cm"])
@pytest.mark.parametrize("root_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("S", [1, 64, 256])
def test_card_kernels_hold_to_the_eager_step(card, S, root_dtype, compute_cm,
                                             ik_on):
    """240 steps by each route, each carrying its own state: positions,
    velocities, roots and the contact state within 1e-6 of the eager
    route's scale, the contact flags equal, and the IK's rotations through
    the world joint positions they give (mean |d| <= 2e-6 m)."""
    ik = stream.IKConfig(enabled=ik_on)
    p = make_plan(ik)
    f = Frames(S, 1000 + S, card)
    carry = dict.fromkeys(("kernel", "eager"), f.carry(root_dtype))
    worst = {}
    launches = pose.pose_roots.launches, pose.pose_ik.launches
    with torch.no_grad():
        for step in range(STEPS):
            x, t = f.x(), f.decoded()
            c = f.decoded() if compute_cm else t
            assert stream._pose_route(p, carry["kernel"], x, t, c) \
                == "kernel"
            out = {}
            for route in ("kernel", "eager"):
                carry[route], out[route] = pose_step(
                    route, p, ik, carry[route], x, t, c)
            k, e = out["kernel"], out["eager"]
            for name in k:
                if name == "ik_rot":
                    continue
                worst[name] = max(worst.get(name, 0.0),
                                  _rel(k[name], e[name]))
            d = (_world(k["ik_rot"], k["ik_pos"])
                 - _world(e["ik_rot"], e["ik_pos"])).abs()
            worst["ik_world_mean_m"] = max(worst.get("ik_world_mean_m", 0.0),
                                           float(d.mean()))
            kc, ec = carry["kernel"], carry["eager"]
            for name in ("src_pos0", "src_rot0", "trans_pos0", "trans_rot0",
                         "cm_pos0", "cm_rot0"):
                worst[name] = max(worst.get(name, 0.0),
                                  _rel(getattr(kc, name), getattr(ec, name)))
            for name in ContactState._fields:
                a, b = getattr(kc.contacts, name), getattr(ec.contacts, name)
                if a.dtype == torch.bool:
                    assert torch.equal(a, b), (step, name)
                else:
                    assert a.dtype == root_dtype
                    worst["contact." + name] = max(
                        worst.get("contact." + name, 0.0), _rel(a, b))
            for r in carry.values():
                assert r.src_pos0.dtype == root_dtype
    assert (pose.pose_roots.launches - launches[0],
            pose.pose_ik.launches - launches[1]) == (STEPS, STEPS)
    print(f"[pose] S={S} {root_dtype} cm={compute_cm} ik={ik_on}: "
          + " ".join(f"{n}={v:.3g}" for n, v in worst.items()))
    for name, v in worst.items():
        assert v <= (2e-6 if name == "ik_world_mean_m" else 1e-6), \
            (name, v)


@pytest.mark.card
def test_card_frames_drive_every_branch(card):
    """The frames of the test above (S = 256) take every contact
    transition (a lock, an unlock when the contact ends, an unlock when the
    foot slides past the unlock radius), both sides of the hip-speed guard
    and a non-finite ratio, and legs asked past their reach, counted on
    the eager route."""
    ik = stream.IKConfig()
    f = Frames(256, 1256, card)
    carry = f.carry(torch.float64)
    seen = dict.fromkeys(("lock", "unlock_contact", "unlock_radius",
                          "ratio_high", "ratio_low", "ratio_nonfinite",
                          "too_far", "within_reach"), 0)
    with torch.no_grad():
        for _ in range(STEPS):
            x, t = f.x(), f.decoded()
            ratio = t[4] / x["hips_speed_mean"]
            seen["ratio_high"] += int((ratio > 3.0).sum())
            seen["ratio_low"] += int((ratio < 0.33).sum())
            seen["ratio_nonfinite"] += int((~torch.isfinite(ratio)).sum())
            old = carry.contacts
            carry, out = pose_step("eager", None, ik, carry, x, t, t)
            new = carry.contacts
            inp = x["contact_last"] > 0.5
            seen["lock"] += int((new.lock & ~old.lock).sum())
            gone = old.lock & ~new.lock
            seen["unlock_contact"] += int((gone & old.state & ~inp).sum())
            seen["unlock_radius"] += int((gone & ~(old.state & ~inp)).sum())
            # the IK's reach, as ik_two_bone works it out
            grot, gpos = quat.fk(out["trans_rot"], out["ik_pos"], PARENTS)
            toes, heels, knees, hips, _ = stream._foot_chains(
                PARENTS, CONTACT_BONES)
            p = new.position
            target = torch.cat([p[..., :1], p[..., 1:2].clamp_min(
                ik.foot_height), p[..., 2:]], -1) + (gpos[:, heels]
                                                    - gpos[:, toes])
            reach = (quat.length(gpos[:, hips] - gpos[:, knees])
                     + quat.length(gpos[:, knees] - gpos[:, heels])
                     - ik.max_length_buffer)
            far = quat.length(target - gpos[:, hips]) > reach
            seen["too_far"] += int(far.sum())
            seen["within_reach"] += int((~far).sum())
    print("[pose] branches:", seen)
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.card
def test_card_torch_arithmetic_is_what_the_kernels_copy(card):
    """PyTorch's CUDA sum over a last axis of 3 adds (x0 + x2) + x1, a
    tensor times a Python float multiplies by the float rounded to the
    tensor's dtype, and a tensor over a Python float multiplies by the
    float's reciprocal taken in double and then rounded: pose.cu copies
    all three."""
    g = torch.Generator().manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        v = (torch.randn(4096, 3, generator=g, dtype=torch.float64)
             * torch.logspace(-6, 6, 4096, dtype=torch.float64)[:, None]
             ).to(dtype)
        got = v.to(card).sum(dim=-1).cpu()
        assert torch.equal(got, (v[:, 0] + v[:, 2]) + v[:, 1]), dtype
        x = torch.rand(4096, generator=g, dtype=torch.float64).to(dtype)
        for s in (np.pi, DT, DT + 1e-8, 0.33):
            assert torch.equal((x.to(card) * s).cpu(),
                               x * torch.tensor(s, dtype=dtype)), (dtype, s)
            assert torch.equal((x.to(card) / s).cpu(),
                               x * torch.tensor(1.0 / s, dtype=dtype)), \
                (dtype, s)


@pytest.mark.card
def test_card_steps_take_the_kernel_route_and_say_so(card):
    """A batch runner and a live session on the card (tiny widths): each
    step launches each pose kernel once, every stream.roots and stream.ik
    span carries route "kernel" (each session records them at its first
    step, which runs eagerly, and at the capture of its CUDA graph; the
    replays record no child spans), and the poses are finite."""
    from torch.profiler import ProfilerActivity, profile

    from mocha_sigasia2023_torch.cli.characterize import derive_norm
    from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
    from mocha_sigasia2023_torch.models.cvae import CVAEConfig, init_cvae
    from mocha_sigasia2023_torch.models.generator import (GeneratorConfig,
                                                          init_generator)
    from mocha_sigasia2023_torch.runtime import features
    from mocha_sigasia2023_torch.runtime.live import LiveCharacterizer
    from mocha_sigasia2023_torch.utils import profiling

    cfg = GeneratorConfig(encoder_dim=64, encoder_heads=2,
                          encoder_dim_head=64, encoder_mlp_dim=64,
                          decoder_dim=64, decoder_heads=2,
                          decoder_dim_head=64, decoder_mlp_dim=64)
    gen = init_generator(cfg, seed=1, device=card)
    cvae = init_cvae(CVAEConfig(output_seq=cfg.num_tokens, latent_dim=64,
                                feedforward_dim=32), seed=2, device=card)
    cha = make_mocha_bvh_data(T=110, seed=3)
    norm = derive_norm(cha, cfg.nframes, card)
    feats = features.clip_stream_features_device(cha, gen, norm, device=card)
    consts = stream.build_consts(
        norm, features.compute_cnt_norm(feats["encoded"], feats["cnt"]),
        None, feats, device=card)
    parents = feats["bone_parents"]
    frames = 16
    clips = [make_mocha_bvh_data(T=frames + cfg.nframes // 4, seed=10 + i)
             for i in range(3)]
    runner = stream.make_batch_runner(gen, cvae, consts, parents,
                                      compute_cm=False,
                                      root_dtype=torch.float64, device=card)
    frame0, xs = features.batch_stream_features_device(
        clips, gen, norm, window=cfg.nframes, emit_cnt=False, device=card)
    src = features.clip_stream_features_device(clips[0], gen, norm,
                                               device=card)
    rows = [{k: src[k][i].cpu().numpy()
             for k in LiveCharacterizer.FEAT_KEYS} for i in range(5)]
    live = LiveCharacterizer(gen, cvae, consts, parents, device=card,
                             generator=torch.Generator(card).manual_seed(6))
    profiling.clear()
    before = pose.pose_roots.launches, pose.pose_ik.launches
    eager = pose.eager_steps
    with profile(activities=[ProfilerActivity.CPU]):
        out = runner(frame0, xs, torch.Generator(card).manual_seed(5))
        poses = [live.push_frame(r) for r in rows]
    steps = (frames - 1) + (len(rows) - 1)
    assert (pose.pose_roots.launches - before[0],
            pose.pose_ik.launches - before[1]) == (steps, steps)
    assert pose.eager_steps == eager
    routes = [s.attrs["route"] for s in profiling.spans()
              if s.name == "stream.step"]
    assert sorted(routes) == ["eager"] * 2 + ["graph"] * (steps - 2)
    for name in ("stream.roots", "stream.ik"):
        got = [s for s in profiling.spans() if s.name == name]
        assert len(got) == 2 * 2          # a warm-up and a capture each
        assert all(s.attrs == {"route": "kernel"} for s in got), name
    profiling.clear()
    for k, v in out.items():
        assert torch.isfinite(v.double()).all(), k
    for p in poses:
        assert all(np.isfinite(v).all() for v in p.values())


@pytest.mark.card
def test_card_steps_the_kernels_do_not_take_go_eager_and_are_counted(card):
    """On a card, a step with bf16 poses, another skeleton or tensors to
    differentiate takes the eager pose math, and ``pose.eager_steps``
    counts each such step; a step the kernels take counts nothing."""
    p = make_plan()
    f = Frames(4, 11, card)
    carry, x, t = f.carry(torch.float32), f.x(), f.decoded()
    eager = pose.eager_steps
    assert stream._pose_route(p, carry, x, t, t) == "kernel"
    assert pose.eager_steps == eager
    bf16 = tuple(a.bfloat16() if a.is_floating_point() else a for a in t)
    assert stream._pose_route(p, carry, x, bf16, bf16) == "eager"
    assert stream._pose_route(None, carry, x, t, t) == "eager"
    grad = (t[0].clone().requires_grad_(),) + t[1:]
    with torch.enable_grad():
        assert stream._pose_route(p, carry, x, grad, t) == "eager"
    assert pose.eager_steps == eager + 3
