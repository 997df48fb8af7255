"""BVH (Biovision Hierarchy) motion-capture file reader/writer.

Counterpart of mocha_sigasia2023_tpu/io/bvh.py, with the same contract:
``load`` returns a dict with ``rotations`` (frames, J, 3 Euler degrees in
file channel order), ``positions`` (frames, J, 3; root driven by the file,
children from offsets), ``offsets`` (J, 3), ``parents`` (J,), ``names``
(list[str]), ``order`` (the rotation-channel order, e.g. ``'zyx'``) and
``frametime``.  The frame block is decoded and formatted by the port's
C++ host codec (``io/native.py``), as the JAX package's native library
does it: strtod's reading of every token, C's ``%f`` on export.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List

import numpy as np

from . import native

_CHANNEL_TO_AXIS = {"Xrotation": "x", "Yrotation": "y", "Zrotation": "z"}
_AXIS_TO_CHANNEL = {v: k for k, v in _CHANNEL_TO_AXIS.items()}
_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


class BVHError(ValueError):
    pass


def load(filename_or_buffer, order: str | None = None) -> Dict:
    """Parse a BVH file or text buffer.

    Reads 3-channel (rotation only), 6-channel (position + rotation) and
    9-channel (position + rotation + scale) layouts.  The last ``CHANNELS``
    line decides the layout and, unless ``order`` is given, the rotation
    order.  End Sites are skipped; joint names may contain colons.
    """
    if hasattr(filename_or_buffer, "read"):
        text = filename_or_buffer.read()
    else:
        with open(filename_or_buffer, "r") as f:
            text = f.read()

    lines = text.splitlines()
    n_lines = len(lines)

    names: List[str] = []
    offsets: List[List[float]] = []
    parents: List[int] = []

    i = 0
    stack: List[int] = []
    in_end_site = False
    channels = None

    # --- hierarchy ---------------------------------------------------------
    while i < n_lines:
        tok = lines[i].split()
        i += 1
        if not tok:
            continue
        head = tok[0]
        if head in ("ROOT", "JOINT"):
            names.append(" ".join(tok[1:]))
            offsets.append([0.0, 0.0, 0.0])
            parents.append(stack[-1] if stack else -1)
            stack.append(len(names) - 1)
        elif head == "End" and len(tok) > 1 and tok[1] == "Site":
            in_end_site = True
        elif head == "}":
            if in_end_site:
                in_end_site = False
            else:
                stack.pop()
        elif head == "OFFSET":
            if not in_end_site:
                offsets[stack[-1]] = [float(v) for v in tok[1:4]]
        elif head == "CHANNELS":
            n = int(tok[1])
            # the last CHANNELS line decides the layout (a file whose root
            # alone has 6 channels reads as 3)
            channels = n
            if order is None:
                rot_parts = tok[2:5] if n == 3 else tok[5:8]
                if all(p in _CHANNEL_TO_AXIS for p in rot_parts):
                    order = "".join(_CHANNEL_TO_AXIS[p] for p in rot_parts)
        elif head == "MOTION":
            break
        # HIERARCHY, "{" and unknown directives carry nothing

    if channels is None or order is None:
        raise BVHError("no CHANNELS declaration found")

    J = len(names)
    offsets_np = np.asarray(offsets, dtype=np.float64)
    parents_np = np.asarray(parents, dtype=int)

    # --- motion ------------------------------------------------------------
    fnum = 0
    frametime = 1.0 / 60.0
    while i < n_lines:
        tok = lines[i].split()
        i += 1
        if not tok:
            continue
        if tok[0] == "Frames:":
            fnum = int(tok[1])
        elif tok[0] == "Frame" and len(tok) > 1 and tok[1] == "Time:":
            frametime = float(tok[2])
            break

    data = native.parse_floats(" ".join(lines[i:]))
    positions = np.repeat(offsets_np[None], fnum, axis=0)
    rotations = np.zeros((fnum, J, 3), dtype=np.float64)

    if channels == 3:
        per_frame = 3 + 3 * J
        data = data[: fnum * per_frame].reshape(fnum, per_frame)
        positions[:, 0] = data[:, 0:3]
        rotations[:] = data[:, 3:].reshape(fnum, J, 3)
    elif channels == 6:
        data = data[: fnum * 6 * J].reshape(fnum, J, 6)
        positions[:] = data[..., 0:3]
        rotations[:] = data[..., 3:6]
    elif channels == 9:
        per_frame = 3 + 9 * (J - 1)
        data = data[: fnum * per_frame].reshape(fnum, per_frame)
        positions[:, 0] = data[:, 0:3]
        rest = data[:, 3:].reshape(fnum, J - 1, 9)
        rotations[:, 1:] = rest[..., 3:6]
        positions[:, 1:] += rest[..., 0:3] * rest[..., 6:9]
    else:
        raise BVHError(f"unsupported channel count {channels}")

    return {
        "rotations": rotations,
        "positions": positions,
        "offsets": offsets_np,
        "parents": parents_np,
        "names": names,
        "order": order,
        "frametime": frametime,
    }


def _children_of(parents: np.ndarray) -> Dict[int, List[int]]:
    ch: Dict[int, List[int]] = {j: [] for j in range(len(parents))}
    for j, p in enumerate(parents):
        if p >= 0:
            ch[int(p)].append(j)
    return ch


def save(filename, data: Dict, frametime: float = 1.0 / 60.0,
         save_positions: bool = False) -> None:
    """Write a BVH file or text buffer.

    The root always gets 6 channels; other joints 3 unless
    ``save_positions``.  Joints are emitted depth-first in ascending child
    order, and frame rows follow that emission order with rotation channels
    permuted by ``data['order']``.
    """
    order = data["order"]
    names = data["names"]
    parents = np.asarray(data["parents"])
    offsets = np.asarray(data["offsets"])
    rots = np.asarray(data["rotations"])
    poss = np.asarray(data["positions"])
    children = _children_of(parents)
    chan_str = " ".join(_AXIS_TO_CHANNEL[a] for a in order)

    buf = io.StringIO()
    save_order: List[int] = []

    def emit_joint(j: int, depth: int, is_root: bool):
        save_order.append(j)
        ind = "\t" * depth
        kw = "ROOT" if is_root else "JOINT"
        buf.write(f"{ind}{kw} {names[j]}\n{ind}{{\n")
        ind2 = "\t" * (depth + 1)
        buf.write(
            f"{ind2}OFFSET {offsets[j, 0]:f} {offsets[j, 1]:f} {offsets[j, 2]:f}\n"
        )
        if is_root or save_positions:
            buf.write(
                f"{ind2}CHANNELS 6 Xposition Yposition Zposition {chan_str} \n"
            )
        else:
            buf.write(f"{ind2}CHANNELS 3 {chan_str}\n")
        if children[j]:
            for c in children[j]:
                emit_joint(c, depth + 1, False)
        else:
            ind3 = "\t" * (depth + 2)
            buf.write(f"{ind2}End Site\n{ind2}{{\n")
            buf.write(f"{ind3}OFFSET {0.0:f} {0.0:f} {0.0:f}\n")
            buf.write(f"{ind2}}}\n")
        buf.write(f"{ind}}}\n")

    buf.write("HIERARCHY\n")
    emit_joint(0, 0, True)

    buf.write("MOTION\n")
    buf.write(f"Frames: {len(rots)}\n")
    buf.write(f"Frame Time: {frametime:f}\n")

    perm = [_AXIS_INDEX[a] for a in order]
    blocks = []
    for j in save_order:
        if save_positions or j == 0:
            blocks.append(poss[:, j, :3])
        blocks.append(rots[:, j][:, perm])
    buf.write(native.format_frames(np.concatenate(blocks, axis=1)))

    out = buf.getvalue()
    if hasattr(filename, "write"):
        filename.write(out)
    else:
        tmp = f"{filename}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(out)
        os.replace(tmp, filename)
