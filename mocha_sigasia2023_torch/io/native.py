"""The host codec of the port's BVH I/O: ctypes bindings for
``io/csrc/mocha_native.cpp``, and the plain versions they are held to.

Counterpart of mocha_sigasia2023_tpu/io/native.py, with its public names
and results.  The library is built with g++ into
``mocha_sigasia2023_torch/_build/`` at first use (``ops/build.py``); it is
host code and runs wherever the port runs, the CPU included.  Where the
JAX package falls back to Python (no compiler, a full buffer), this module
raises: every buffer is sized so that the library cannot run out of room,
and a build or load that fails raises with the compiler's or loader's
message.

``parse_floats_plain``, ``format_frames_plain`` and
``read_db_block_f32_plain`` are Python and NumPy versions of the three
entry points, with the same results bit for bit; the tests and
chip_smoke.py hold the library to them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import re
import struct
import threading
from typing import Tuple

import numpy as np

from ..ops import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "mocha_native.cpp")

_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mocha_parse_floats.restype = ctypes.c_int64
    lib.mocha_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64]
    lib.mocha_format_frames.restype = ctypes.c_int64
    lib.mocha_format_frames.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.mocha_db_block_f32.restype = ctypes.c_int64
    lib.mocha_db_block_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The codec's library, built and loaded at first use; raises if it
    cannot be built or loaded."""
    with _LOCK:
        return _load()


def parse_capacity(nbytes: int) -> int:
    """The most values ``nbytes`` bytes of text can hold, plus one.

    Every value holds a decimal digit or is ``inf`` / ``nan`` (3 bytes or
    more), and strtod takes a digit run whole, so the digits of two values
    are parted by at least one other byte (``1..2`` reads as ``1.`` and
    ``.2``, ``1-2`` as ``1`` and ``-2``): n bytes hold at most
    (n + 1) // 2 values."""
    return (nbytes + 1) // 2 + 1


def parse_floats(text: str) -> np.ndarray:
    """The floats of ``text`` (a BVH MOTION block), as C's strtod reads
    them token by token: a float64 array."""
    raw = text.encode()
    cap = parse_capacity(len(raw))
    out = np.empty(cap, dtype=np.float64)
    n = get_lib().mocha_parse_floats(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap)
    if n < 0:
        raise RuntimeError(f"mocha_parse_floats ran out of room for "
                           f"{cap} values in {len(raw)} bytes")
    return out[:n].copy()


def format_capacity(values: np.ndarray) -> int:
    """Bytes enough for ``format_frames(values)``.

    ``%f`` writes |v| < 2**e (``np.frexp``) with at most 1 + e * log10(2)
    integer digits, rounding included; with a sign, the point, six places
    and the space a value takes at most 10 + 0.30103 e bytes.  Add a
    newline a row and snprintf's terminator."""
    _, exp = np.frexp(values)
    return (10 * values.size
            + math.ceil(0.30103 * float(np.maximum(exp, 0).sum()))
            + values.shape[0] + 1)


def _matrix(values) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.float64)
    if values.ndim != 2:
        raise ValueError(f"format_frames: want a (rows, cols) matrix, got "
                         f"shape {values.shape}")
    return values


def format_frames(values: np.ndarray) -> str:
    """(rows, cols) matrix -> the BVH MOTION block: each value as C's
    ``%f`` followed by a space, one row a line."""
    values = _matrix(values)
    nrows, ncols = values.shape
    cap = format_capacity(values)
    buf = ctypes.create_string_buffer(cap)
    w = get_lib().mocha_format_frames(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nrows, ncols,
        buf, cap)
    if w < 0:
        raise RuntimeError(f"mocha_format_frames ran out of room: {cap} "
                           f"bytes for a {nrows} x {ncols} block")
    return buf.raw[:w].decode("ascii")


_HEADER = struct.Struct("<II")


def _block_header(buf, offset: int, ncomp: int) -> Tuple[int, int, int]:
    """(n0, n1, float count) of the block at ``offset``; raises ValueError
    if the block does not lie whole in ``buf``."""
    if ncomp < 0:
        raise ValueError(f"read_db_block_f32: ncomp {ncomp} < 0")
    if offset < 0 or offset + _HEADER.size > len(buf):
        raise ValueError(f"read_db_block_f32: no block header at offset "
                         f"{offset} of a {len(buf)}-byte buffer")
    n0, n1 = _HEADER.unpack_from(buf, offset)
    count = n0 * n1 * ncomp
    if offset + _HEADER.size + 4 * count > len(buf):
        raise ValueError(f"read_db_block_f32: the block at offset {offset} "
                         f"({n0} x {n1} x {ncomp} floats) runs past the "
                         f"{len(buf)}-byte buffer")
    return n0, n1, count


def read_db_block_f32(buf: bytes, offset: int, ncomp: int):
    """One ``(u32 n0, u32 n1) + f32[n0 * n1 * ncomp]`` block of a
    database.bin at ``offset`` of ``buf``: (array (n0, n1, ncomp),
    offset of the next block).  A short or truncated block raises
    ValueError naming the offset."""
    n0, n1, count = _block_header(buf, offset, ncomp)
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(count, dtype=np.float32)
    shape = np.zeros(2, dtype=np.int64)
    nxt = get_lib().mocha_db_block_f32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr),
        offset, ncomp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        count, shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if nxt < 0:
        raise RuntimeError(f"mocha_db_block_f32 refused the block at offset "
                           f"{offset} that its header admits")
    return out.reshape(int(shape[0]), int(shape[1]), ncomp), int(nxt)


# --- plain versions ---------------------------------------------------------

# one match a step: a run of spaces, a float strtod accepts (group 1), or a
# token strtod cannot start, up to ' ', '\t', '\n' or '\r'
_TOKEN = re.compile(rb"""
    [ \t\n\r\f\v]+
  | ( [+-]?
      (?: 0x (?: [0-9a-f]+ \.? [0-9a-f]* | \. [0-9a-f]+ ) (?: p [+-]? [0-9]+ )?
        | (?: [0-9]+ \.? [0-9]* | \. [0-9]+ ) (?: e [+-]? [0-9]+ )?
        | inf (?: inity )?
        | nan (?: \( [0-9a-z_]* \) )? ) )
  | [^ \t\n\r]+
""", re.X | re.I)
_NAN_CHARS = re.compile(rb"([+-]?)nan\(([0-9a-z_]*)\)", re.I)
_NAN_PAYLOAD = re.compile(rb"0x[0-9a-f]+|0[0-7]*|[1-9][0-9]*|", re.I)
_QUIET_NAN = 0x7FF8000000000000
_PAYLOAD_BITS = (1 << 51) - 1


def _nan_with_payload(sign: bytes, chars: bytes) -> float:
    """glibc's strtod on ``nan(chars)``: ``chars`` read as strtoull does
    with base 0 (hex, octal or decimal, saturating at 2**64 - 1), if all of
    it is a number, goes into the low 51 bits of a quiet NaN."""
    bits = _QUIET_NAN
    if _NAN_PAYLOAD.fullmatch(chars):
        digits, base = chars, 10
        if chars[:2].lower() == b"0x":
            digits, base = chars[2:], 16
        elif chars.startswith(b"0"):
            base = 8
        mant = min(int(digits or b"0", base), (1 << 64) - 1)
        bits |= mant & _PAYLOAD_BITS
    value = struct.unpack("<d", struct.pack("<Q", bits))[0]
    return -value if sign == b"-" else value


def _strtod(token: bytes) -> float:
    """One float token of ``_TOKEN`` (group 1) as strtod converts it.
    Python's float() and float.fromhex() round correctly, as glibc does."""
    try:
        return float(token)    # decimal, inf, infinity, nan
    except ValueError:
        pass
    nan = _NAN_CHARS.fullmatch(token)
    if nan:
        return _nan_with_payload(*nan.groups())
    try:
        return float.fromhex(token.decode("ascii"))
    except OverflowError:
        return -math.inf if token.startswith(b"-") else math.inf


def parse_floats_plain(text: str) -> np.ndarray:
    """``parse_floats`` in Python: the same values, bit for bit."""
    return np.array([_strtod(t) for t in _TOKEN.findall(text.encode()) if t],
                    dtype=np.float64)


def format_frames_plain(values: np.ndarray) -> str:
    """``format_frames`` in Python: Python's ``%f`` is C's, except that it
    writes ``nan`` for a NaN whose sign bit is set, where C writes
    ``-nan``."""
    values = _matrix(values)
    neg_nan = np.isnan(values) & np.signbit(values)
    cells = np.where(neg_nan, "-nan ", "%f ")
    template = "".join("".join(row) + "\n" for row in cells.tolist())
    return template % tuple(values[~neg_nan].tolist())


def read_db_block_f32_plain(buf: bytes, offset: int, ncomp: int):
    """``read_db_block_f32`` in NumPy."""
    n0, n1, count = _block_header(buf, offset, ncomp)
    start = offset + _HEADER.size
    arr = np.frombuffer(buf, dtype="<f4", count=count, offset=start)
    return (arr.astype(np.float32).reshape(n0, n1, ncomp),
            start + 4 * count)
