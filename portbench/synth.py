"""Synthetic mocha-skeleton motion clips (NumPy).

The port's own copy of mocha_sigasia2023_tpu/data/synthetic.py: smooth
random motion on the 24-joint mocha rig, in the BVH-loader output format,
used as the clip source of ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

import numpy as np

MOCHA_JOINTS = [
    "Hips",
    "LeftUpLeg", "LeftLeg", "LeftFoot", "LeftToeBase",
    "Spine", "Spine1", "Spine2", "Spine3",
    "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
    "Neck", "Neck1", "Head",
    "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "RightUpLeg", "RightLeg", "RightFoot", "RightToeBase",
]

MOCHA_PARENTS = np.array(
    [-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13, 14, 8, 16, 17, 18,
     0, 20, 21, 22]
)

# Roughly humanoid offsets in centimeters (symmetric left/right).
_OFFSETS_CM = {
    "Hips": (0, 95, 0),
    "LeftUpLeg": (9, -5, 0), "LeftLeg": (0, -42, 0),
    "LeftFoot": (0, -40, 0), "LeftToeBase": (0, -8, 14),
    "Spine": (0, 10, 0), "Spine1": (0, 11, 0), "Spine2": (0, 11, 0),
    "Spine3": (0, 11, 0),
    "LeftShoulder": (6, 8, 0), "LeftArm": (12, 0, 0),
    "LeftForeArm": (26, 0, 0), "LeftHand": (25, 0, 0),
    "Neck": (0, 10, 0), "Neck1": (0, 6, 0), "Head": (0, 12, 0),
    "RightShoulder": (-6, 8, 0), "RightArm": (-12, 0, 0),
    "RightForeArm": (-26, 0, 0), "RightHand": (-25, 0, 0),
    "RightUpLeg": (-9, -5, 0), "RightLeg": (0, -42, 0),
    "RightFoot": (0, -40, 0), "RightToeBase": (0, -8, 14),
}


def make_mocha_bvh_data(T=120, seed=0, order="zyx", walk_speed=80.0):
    """Smooth synthetic clip in the bvh.load output format.

    Rotations are small smooth sinusoids (degrees); the root translates
    forward at ``walk_speed`` cm/s with a little sway so the synthesized
    root bone and foot contacts get realistic signal.
    """
    rng = np.random.RandomState(seed)
    J = len(MOCHA_JOINTS)
    t = np.arange(T)[:, None, None] / 60.0

    amp = rng.uniform(3.0, 25.0, size=(1, J, 3))
    freq = rng.uniform(0.5, 2.5, size=(1, J, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, J, 3))
    base = rng.uniform(-20, 20, size=(1, J, 3))
    rotations = base + amp * np.sin(2 * np.pi * freq * t + phase)

    offsets = np.array([_OFFSETS_CM[n] for n in MOCHA_JOINTS], dtype=np.float64)
    positions = np.repeat(offsets[None], T, axis=0)
    # root trajectory: forward walk + sway + bob
    tt = np.arange(T) / 60.0
    positions[:, 0, 0] = 10.0 * np.sin(tt * 1.3)
    positions[:, 0, 1] = 95.0 + 3.0 * np.sin(tt * 5.1)
    positions[:, 0, 2] = walk_speed * tt

    return {
        "rotations": rotations,
        "positions": positions,
        "offsets": offsets,
        "parents": MOCHA_PARENTS.copy(),
        "names": list(MOCHA_JOINTS),
        "order": order,
        "frametime": 1.0 / 60.0,
    }
