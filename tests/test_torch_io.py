"""The port's BVH I/O and characterized-motion export against JAX.

Hand-written BVH texts (3-, 6- and 9-channel layouts, namespaced joint
names, a root-only file) must load to the same dict in both packages; the
same dict must save to byte-identical text; ``to_euler`` agrees within
1e-6; the export's re-rooting and written files agree with the JAX
package's.  The JAX side runs without jax_enable_x64, so its FK and Euler
conversion are float32: exported positions are held to 1e-5 and angles to
1e-3 degrees.
"""

import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.io import bvh as jbvh  # noqa: E402
from mocha_sigasia2023_tpu.kinematics import quat as jquat  # noqa: E402
from mocha_sigasia2023_tpu.runtime import export as jexport  # noqa: E402

from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    MOCHA_JOINTS, MOCHA_PARENTS, make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.kinematics import quat as tquat  # noqa: E402
from mocha_sigasia2023_torch.runtime import export as texport  # noqa: E402

torch.set_num_threads(2)
POS_TOL = 1e-5
DEG_TOL = 1e-3

# a 5-joint tree with a branch and namespaced names
NAMES = ["rig:Hips", "rig:Spine", "rig:Head", "rig:LeftLeg", "rig:LeftFoot"]
PARENTS = [-1, 0, 1, 0, 3]
ROT = "Zrotation Xrotation Yrotation"
POS = "Xposition Yposition Zposition"
SCALE = "Xscale Yscale Zscale"


def _channels(layout, j):
    if layout == "root6" or layout == 6:
        return f"CHANNELS 6 {POS} {ROT}", 6
    if layout == 3:
        return ((f"CHANNELS 6 {POS} {ROT}", 6) if j == 0
                else (f"CHANNELS 3 {ROT}", 3))
    return ((f"CHANNELS 3 {POS}", 3) if j == 0
            else (f"CHANNELS 9 {POS} {ROT} {SCALE}", 9))


def _bvh_text(layout, seed=0, T=6):
    """A BVH text in the given layout with 6-decimal random channels."""
    names = NAMES[:1] if layout == "root6" else NAMES
    parents = PARENTS[:len(names)]
    rng = np.random.RandomState(seed)
    lines, n_ch = ["HIERARCHY"], []

    def emit(j, depth):
        ind = "  " * depth
        kw = "ROOT" if j == 0 else "JOINT"
        lines.append(f"{ind}{kw} {names[j]}")
        lines.append(f"{ind}{{")
        off = rng.uniform(-20, 20, 3)
        lines.append(f"{ind}  OFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        text, n = _channels(layout, j)
        lines.append(f"{ind}  {text}")
        n_ch.append(n)
        kids = [c for c, p in enumerate(parents) if p == j]
        for c in kids:
            emit(c, depth + 1)
        if not kids:
            lines.extend([f"{ind}  End Site", f"{ind}  {{",
                          f"{ind}    OFFSET 0.000000 1.500000 0.000000",
                          f"{ind}  }}"])
        lines.append(f"{ind}}}")

    emit(0, 0)
    lines += ["MOTION", f"Frames: {T}", "Frame Time: 0.033333"]
    for _ in range(T):
        vals = rng.uniform(-90, 90, sum(n_ch))
        lines.append(" ".join(f"{v:.6f}" for v in vals))
    return "\n".join(lines) + "\n"


def _assert_same_dict(a, b):
    assert set(a) == set(b)
    assert list(a["names"]) == list(b["names"])
    assert a["order"] == b["order"]
    assert a["frametime"] == b["frametime"]
    np.testing.assert_array_equal(a["parents"], b["parents"])
    for k in ("rotations", "positions", "offsets"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _perm(order):
    """``save`` writes rotation columns permuted by the order; ``load``
    returns them as written."""
    return ["xyz".index(a) for a in order]


LAYOUTS = [3, 6, 9, "root6"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_matches_jax(layout):
    text = _bvh_text(layout)
    got = tbvh.load(io.StringIO(text))
    want = jbvh.load(io.StringIO(text))
    _assert_same_dict(got, want)
    assert got["names"][0].startswith("rig:")
    assert got["rotations"].shape == (6, len(got["names"]), 3)
    assert got["order"] == "zxy"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("save_positions", [False, True])
def test_save_is_byte_identical_and_round_trips(layout, save_positions):
    data = jbvh.load(io.StringIO(_bvh_text(layout, seed=1)))
    got, want = io.StringIO(), io.StringIO()
    tbvh.save(got, data, frametime=data["frametime"],
              save_positions=save_positions)
    jbvh.save(want, data, frametime=data["frametime"],
              save_positions=save_positions)
    assert got.getvalue() == want.getvalue()
    back = tbvh.load(io.StringIO(got.getvalue()))
    assert back["names"] == data["names"] and back["order"] == data["order"]
    np.testing.assert_array_equal(back["parents"], data["parents"])
    np.testing.assert_allclose(back["rotations"],
                               data["rotations"][..., _perm(data["order"])],
                               atol=1e-6)
    np.testing.assert_allclose(back["offsets"], data["offsets"], atol=1e-6)
    # without save_positions only the root's position channels are written
    moved = slice(None) if save_positions else slice(0, 1)
    np.testing.assert_allclose(back["positions"][:, moved],
                               data["positions"][:, moved], atol=1e-6)
    if not save_positions:
        np.testing.assert_allclose(
            back["positions"][:, 1:],
            np.broadcast_to(data["offsets"][1:], back["positions"][:, 1:].shape),
            atol=1e-6)


def test_save_to_a_file_and_load_the_synthetic_clip(tmp_path):
    clip = make_mocha_bvh_data(T=30, seed=4)
    path = tmp_path / "clip.bvh"
    tbvh.save(str(path), clip)
    jpath = tmp_path / "clip_jax.bvh"
    jbvh.save(str(jpath), clip)
    assert path.read_bytes() == jpath.read_bytes()
    back = tbvh.load(str(path))
    assert back["names"] == MOCHA_JOINTS
    np.testing.assert_array_equal(back["parents"], MOCHA_PARENTS)
    np.testing.assert_allclose(back["rotations"],
                               clip["rotations"][..., _perm("zyx")], atol=1e-6)
    np.testing.assert_allclose(back["positions"], clip["positions"],
                               atol=1e-6)


def test_load_without_channels_raises():
    with pytest.raises(tbvh.BVHError):
        tbvh.load(io.StringIO("HIERARCHY\nROOT a\n{\nOFFSET 0 0 0\n}\n"))


def _unit_quats(shape, seed, dtype=np.float32):
    q = np.random.RandomState(seed).standard_normal(shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)


@pytest.mark.parametrize("order", ["xyz", "yzx"])
def test_to_euler_matches_jax(order):
    q = _unit_quats((64, 5), seed=2)
    got = tquat.to_euler(torch.as_tensor(q), order).numpy()
    want = np.asarray(jquat.to_euler(jnp.asarray(q), order))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tquat.to_euler(torch.as_tensor(q)).shape == (64, 5, 3)
    with pytest.raises(NotImplementedError):
        tquat.to_euler(torch.as_tensor(q), "zyx")


def _pose(T, seed, pos_dtype, rot_dtype):
    rng = np.random.RandomState(seed)
    J = len(MOCHA_JOINTS) + 1
    Ypos = rng.uniform(-1, 1, (T, J, 3)).astype(pos_dtype)
    Yrot = _unit_quats((T, J), seed + 1, rot_dtype)
    parents = np.concatenate([[-1], MOCHA_PARENTS + 1])
    return Ypos, Yrot, parents


DTYPES = [(np.float32, np.float32), (np.float64, np.float32),
          (np.float32, np.float64)]


@pytest.mark.parametrize("pos_dtype,rot_dtype", DTYPES)
def test_reroot_to_hips_matches_jax(pos_dtype, rot_dtype):
    Ypos, Yrot, parents = _pose(8, 5, pos_dtype, rot_dtype)
    pos, rot = texport.reroot_to_hips(Ypos, Yrot, parents)
    jpos, jrot = jexport.reroot_to_hips(Ypos, Yrot, parents)
    assert pos.dtype == jpos.dtype == pos_dtype
    assert rot.dtype == jrot.dtype == rot_dtype
    assert pos.shape == (8, 24, 3) and rot.shape == (8, 24, 4)
    np.testing.assert_allclose(pos, jpos, atol=POS_TOL)
    np.testing.assert_allclose(rot, jrot, atol=POS_TOL)
    # only the hips row changes; the others are copies
    np.testing.assert_array_equal(pos[:, 1:], Ypos[:, 2:])


@pytest.mark.parametrize("pos_dtype,rot_dtype", DTYPES)
def test_save_characterized_bvh_matches_jax(tmp_path, pos_dtype, rot_dtype):
    Ypos, Yrot, parents = _pose(8, 9, pos_dtype, rot_dtype)
    texport.save_characterized_bvh(str(tmp_path / "t.bvh"), Ypos, Yrot,
                                   parents, MOCHA_JOINTS)
    jexport.save_characterized_bvh(str(tmp_path / "j.bvh"), Ypos, Yrot,
                                   parents, MOCHA_JOINTS)
    got = tbvh.load(str(tmp_path / "t.bvh"))
    want = tbvh.load(str(tmp_path / "j.bvh"))
    assert got["names"] == want["names"] == MOCHA_JOINTS
    assert got["order"] == want["order"] == "zyx"
    np.testing.assert_array_equal(got["parents"], want["parents"])
    np.testing.assert_allclose(got["positions"], want["positions"],
                               atol=POS_TOL)
    np.testing.assert_allclose(got["offsets"], want["offsets"], atol=POS_TOL)
    np.testing.assert_allclose(got["rotations"], want["rotations"],
                               atol=DEG_TOL)
    # the header is the same text
    head_t = (tmp_path / "t.bvh").read_text().split("MOTION")[0]
    head_j = (tmp_path / "j.bvh").read_text().split("MOTION")[0]
    assert head_t.count("JOINT") == head_j.count("JOINT") == 23
