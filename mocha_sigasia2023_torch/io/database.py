"""Packed motion-database codec (``database.bin``), NumPy.

Counterpart of mocha_sigasia2023_tpu/io/database.py:32-155, the port's own
copy: the same little-endian layout, so either package reads the other's
files byte for byte.

    u32 nframes, u32 nbones, f32[nframes*nbones*3]   bone_positions
    u32 nframes, u32 nbones, f32[nframes*nbones*3]   bone_velocities
    u32 nframes, u32 nbones, f32[nframes*nbones*4]   bone_rotations
    u32 nframes, u32 nbones, f32[nframes*nbones*3]   bone_angular_velocities
    u32 nbones,  i32[nbones]                         bone_parents
    u32 nranges, i32[nranges]                        range_starts
    u32 nranges, i32[nranges]                        range_stops
    u32 nranges, i32[nranges]                        style_labels
    u32 nranges, i32[nranges]                        action_labels
    u32 nframes, u32 ncontacts, u8[nframes*ncontacts] contact_states

The JAX package's native C++ reader (``io/native.py``) is host text and
block I/O, not a TPU kernel; NumPy does its work here.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_HEADER2 = struct.Struct("<II")
_HEADER1 = struct.Struct("<I")


def save_database(filename, db: Dict[str, np.ndarray]) -> None:
    """Serialize a database dict (keys as returned by ``load_database``)."""
    pos = np.ascontiguousarray(db["bone_positions"], dtype=np.float32)
    vel = np.ascontiguousarray(db["bone_velocities"], dtype=np.float32)
    rot = np.ascontiguousarray(db["bone_rotations"], dtype=np.float32)
    ang = np.ascontiguousarray(db["bone_angular_velocities"], dtype=np.float32)
    parents = np.ascontiguousarray(db["bone_parents"], dtype=np.int32)
    starts = np.ascontiguousarray(db["range_starts"], dtype=np.int32)
    stops = np.ascontiguousarray(db["range_stops"], dtype=np.int32)
    styles = np.ascontiguousarray(db["style_labels"], dtype=np.int32)
    actions = np.ascontiguousarray(
        db.get("action_labels", db.get("content_labels")), dtype=np.int32
    )
    contacts = np.ascontiguousarray(db["contact_states"], dtype=np.uint8)

    nframes, nbones = pos.shape[0], pos.shape[1]
    nranges = starts.shape[0]
    ncontacts = contacts.shape[1]

    with open(filename, "wb") as f:
        f.write(_HEADER2.pack(nframes, nbones) + pos.tobytes())
        f.write(_HEADER2.pack(nframes, nbones) + vel.tobytes())
        f.write(_HEADER2.pack(nframes, nbones) + rot.tobytes())
        f.write(_HEADER2.pack(nframes, nbones) + ang.tobytes())
        f.write(_HEADER1.pack(nbones) + parents.tobytes())
        f.write(_HEADER1.pack(nranges) + starts.tobytes())
        f.write(_HEADER1.pack(nranges) + stops.tobytes())
        f.write(_HEADER1.pack(nranges) + styles.tobytes())
        f.write(_HEADER1.pack(nranges) + actions.tobytes())
        f.write(_HEADER2.pack(nframes, ncontacts) + contacts.tobytes())


def load_database(filename) -> Dict[str, np.ndarray]:
    """Deserialize a database.bin (format above).

    Returns both ``action_labels`` and the legacy alias ``content_labels``
    (the reference reader's name for the same block).
    """
    with open(filename, "rb") as f:
        buf = f.read()

    off = 0

    def block2(ncomp, dtype=np.float32):
        nonlocal off
        n0, n1 = _HEADER2.unpack_from(buf, off)
        off += _HEADER2.size
        shape = (n0, n1, ncomp) if ncomp > 1 else (n0, n1)
        arr = np.frombuffer(buf, dtype=dtype, count=n0 * n1 * ncomp,
                            offset=off).reshape(shape)
        off += arr.nbytes
        return arr

    def block1(dtype=np.int32):
        nonlocal off
        (n,) = _HEADER1.unpack_from(buf, off)
        off += _HEADER1.size
        arr = np.frombuffer(buf, dtype=dtype, count=n, offset=off)
        off += n * arr.dtype.itemsize
        return arr

    positions = block2(3)
    velocities = block2(3)
    rotations = block2(4)
    angular = block2(3)
    parents = block1()
    starts = block1()
    stops = block1()
    styles = block1()
    actions = block1()
    contacts = block2(1, dtype=np.uint8)

    return {
        "bone_positions": positions,
        "bone_velocities": velocities,
        "bone_rotations": rotations,
        "bone_angular_velocities": angular,
        "bone_parents": parents,
        "range_starts": starts,
        "range_stops": stops,
        "style_labels": styles,
        "action_labels": actions,
        "content_labels": actions,
        "contact_states": contacts,
    }


def save_features(filename, features, offset, scale) -> None:
    """Feature-matrix sidecar: (nframes, nfeat) float32 features, then the
    offset and scale vectors, each behind its u32 counts."""
    features = np.ascontiguousarray(features, dtype=np.float32)
    offset_a = np.ascontiguousarray(offset, dtype=np.float32)
    scale_a = np.ascontiguousarray(scale, dtype=np.float32)
    with open(filename, "wb") as f:
        f.write(_HEADER2.pack(*features.shape) + features.tobytes())
        f.write(_HEADER1.pack(offset_a.shape[0]) + offset_a.tobytes())
        f.write(_HEADER1.pack(scale_a.shape[0]) + scale_a.tobytes())


def load_features(filename) -> Dict[str, np.ndarray]:
    with open(filename, "rb") as f:
        buf = f.read()
    off = 0
    nframes, nfeat = _HEADER2.unpack_from(buf, off)
    off += _HEADER2.size
    features = np.frombuffer(buf, np.float32, nframes * nfeat, off).reshape(
        nframes, nfeat
    )
    off += nframes * nfeat * 4
    (n,) = _HEADER1.unpack_from(buf, off)
    off += _HEADER1.size
    features_offset = np.frombuffer(buf, np.float32, n, off)
    off += n * 4
    (n,) = _HEADER1.unpack_from(buf, off)
    off += _HEADER1.size
    features_scale = np.frombuffer(buf, np.float32, n, off)
    return {
        "features": features,
        "features_offset": features_offset,
        "features_scale": features_scale,
    }
