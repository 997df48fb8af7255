"""The port's host codec (io/native.py on io/csrc/mocha_native.cpp) held to
the JAX package's built native library.

``parse_floats`` must read what the JAX library reads, bit for bit, three
ways (the JAX library, the port's library, the port's plain Python): on
every row of the probe table below (glued signs, stray points, commas,
hex floats, exponents with no digits, junk tokens, ``infinit``, NaN
payloads, ``\\f`` inside a junk token), on every short string over an
adversarial alphabet, on a real MOTION block and on token soups that
hypothesis glues with every whitespace byte.  ``format_frames`` must write
the JAX library's bytes wherever the JAX wrapper formats natively (every
value under 32 bytes): ``-nan`` for a NaN whose sign bit is set.  Also:
``read_db_block_f32`` on a database.bin written by the JAX package,
``bvh.load`` on BVH texts that carry the probe's tokens, the two buffer
bounds, and a build that fails or a library that does not load raising
with the compiler's or loader's message, with nothing under ``native/``
opened by the port.
"""

import io
import itertools
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from mocha_sigasia2023_tpu.io import bvh as jbvh  # noqa: E402
from mocha_sigasia2023_tpu.io import database as jdatabase  # noqa: E402
from mocha_sigasia2023_tpu.io import native as jnative  # noqa: E402

from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_torch.io import bvh as tbvh  # noqa: E402
from mocha_sigasia2023_torch.io import native  # noqa: E402
from mocha_sigasia2023_torch.ops import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "mocha_sigasia2023_torch")
SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])
INF, NAN = float("inf"), float("nan")

# MOTION text -> what glibc's strtod loop reads (NaNs as their bits)
PROBES = [
    ("1.0-2.0 3", [1.0, -2.0, 3.0]),
    ("1..2 9", [1.0, 0.2, 9.0]),
    ("1,5 2", [1.0, 2.0]),
    ("0x1p3 4", [8.0, 4.0]),
    ("0x 5", [0.0, 5.0]),
    ("1.5e 2", [1.5, 2.0]),
    ("1e+ 6", [1.0, 6.0]),
    ("abc 1 2", [1.0, 2.0]),
    ("+-1 7", [7.0]),
    (".e1 8", [8.0]),
    ("infinit 3", [INF, 3.0]),
    ("nan(0x1) 1", [0x7FF8000000000001, 1.0]),
    ("abc\f1 2", [2.0]),
    ("inf -inf nan", [INF, -INF, 0x7FF8000000000000]),
    ("INF NaN -Infinity", [INF, 0x7FF8000000000000, -INF]),
    ("1e400 -1e-400", [INF, -0.0]),
    ("1\v2", [1.0, 2.0]),
    ("0x1.8p1x 0xp1 0x1p 0x1p+ 0x.8 -0x1p-1080", [3.0, 0.0, 1.0, 1.0, 0.5,
                                                 -0.0]),
    ("0x1.fffffffffffff8p1023 -0x1p99999999999999999999",
     [INF, -INF]),
    ("4.9e-324 2.4703282292062328e-324 2.4703282292062327e-324",
     [5e-324, 5e-324, 0.0]),
    ("infinity1 nanx 1e e5 - . +.5 -.e", [INF, 1.0, 0x7FF8000000000000,
                                          1.0, 0.5]),
    ("1é2 3 é 4 \x00 5 6\x007", [1.0, 3.0, 4.0, 5.0, 6.0]),
]

# nan(chars): glibc reads chars as strtoull does with base 0 and, when all
# of them are a number, puts its low 51 bits under the quiet bit.  Every
# path gives these bits.
NAN_PAYLOADS = [
    ("nan(0x1)", 0x7FF8000000000001),
    ("-nan(0x7)", 0xFFF8000000000007),
    ("nan(12)", 0x7FF800000000000C),
    ("NAN(0X10)", 0x7FF8000000000010),
    ("nan(017)", 0x7FF800000000000F),
    ("nan(018)", 0x7FF8000000000000),
    ("nan(abc)", 0x7FF8000000000000),
    ("nan()", 0x7FF8000000000000),
    ("nan(0x)", 0x7FF8000000000000),
    ("-nan(18446744073709551615)", 0xFFFFFFFFFFFFFFFF),
    ("nan(99999999999999999999999)", 0x7FFFFFFFFFFFFFFF),
]


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library, built by its own get_lib.  Another test
    process may be writing it when this one first looks, and the JAX
    get_lib then remembers None: wait and ask again."""
    for _ in range(5):
        lib = jnative.get_lib()
        if lib is not None:
            return lib
        time.sleep(1.0)
        jnative._tried = False
    assert jnative.get_lib() is not None


def bits(values):
    return np.asarray(values, dtype=np.float64).view(np.uint64).tolist()


def want_bits(values):
    return [v if isinstance(v, int) else bits([v])[0] for v in values]


def three_ways(text):
    """The JAX library's, the port library's and the port's plain reading
    of ``text``, as lists of bits."""
    return (bits(jnative.parse_floats(text)), bits(native.parse_floats(text)),
            bits(native.parse_floats_plain(text)))


@pytest.mark.parametrize("text,want", PROBES, ids=[repr(t) for t, _ in PROBES])
def test_parse_probe_table(jax_lib, text, want):
    j, t, p = three_ways(text)
    assert j == want_bits(want)
    assert t == j and p == j


@pytest.mark.parametrize("text,want", NAN_PAYLOADS,
                         ids=[t for t, _ in NAN_PAYLOADS])
def test_parse_nan_payloads(jax_lib, text, want):
    assert three_ways(text + " 1") == ([want, bits([1.0])[0]],) * 3


def test_parse_every_short_string(jax_lib):
    """Every string of up to 4 bytes over the bytes where strtod's
    prefixes turn (digits, point, sign, exponent, hex marker, both kinds
    of space), each read alike three ways and within the value bound."""
    alphabet = "1.-ex0p \f"
    n = 0
    for size in range(1, 5):
        for chars in itertools.product(alphabet, repeat=size):
            text = "".join(chars)
            j, t, p = three_ways(text)
            assert t == j and p == j, repr(text)
            assert len(j) < native.parse_capacity(size), repr(text)
            n += 1
    assert n == sum(len(alphabet) ** k for k in range(1, 5))


def test_parse_real_motion_block(jax_lib):
    data = make_mocha_bvh_data(T=40, seed=3)
    buf = io.StringIO()
    jbvh.save(buf, data)
    motion = buf.getvalue().split("Frame Time:")[1].split("\n", 1)[1]
    j, t, p = three_ways(motion)
    assert len(j) == 40 * (3 + 3 * len(data["names"]))   # root 6, 3 a joint
    assert t == j and p == j


SPACES = [" ", "\t", "\n", "\r", "\f", "\v", ""]
digits = st.text("0123456789", max_size=4)
decimals = st.builds(
    lambda sign, a, point, b, exp, e: sign + a + point + b + exp + e,
    st.sampled_from(["", "+", "-"]), digits, st.sampled_from(["", "."]),
    digits, st.sampled_from(["", "e", "E", "e+", "e-", "E-"]),
    st.text("0123456789", max_size=3))
hexes = st.builds(
    lambda sign, x, a, point, b, exp, e: sign + x + a + point + b + exp + e,
    st.sampled_from(["", "-"]), st.sampled_from(["0x", "0X"]),
    st.text("0123456789abcdefABCDEF", max_size=4), st.sampled_from(["", "."]),
    st.text("0123456789abcdef", max_size=3),
    st.sampled_from(["", "p", "P+", "p-"]), st.text("0123456789", max_size=3))
specials = st.sampled_from(["inf", "-INF", "infinit", "Infinity", "nan",
                            "-NaN", "nan(", "nan()", "nan(0x1f)", "nan(12)",
                            "nan(x y)", "nan(017)"])
junk = st.text(",;:abcxyz_()é+-.#\x00", min_size=1, max_size=4)
soups = st.lists(st.tuples(st.one_of(decimals, hexes, specials, junk),
                           st.sampled_from(SPACES)),
                 max_size=24).map(lambda parts: "".join(a + b
                                                        for a, b in parts))


@SETTINGS
@given(text=soups)
def test_parse_token_soups(jax_lib, text):
    j, t, p = three_ways(text)
    assert t == j and p == j
    assert len(j) < native.parse_capacity(len(text.encode()))


def test_parse_capacity_is_tight():
    """The densest texts reach the bound: one value per two bytes."""
    for text in ("1-" * 50, "1 1 1 1 1", "1-1-1", ".1.1.1"):
        n = len(native.parse_floats(text))
        assert n == (len(text) + 1) // 2 == native.parse_capacity(
            len(text)) - 1


# (rows, cols) blocks: signed zeros, signed NaNs, infinities, 1e20, and
# values around the rounding of the sixth place
FORMAT_BLOCKS = [
    [[0.0, -0.0, NAN, -NAN, INF, -INF, 1e20, -1e20]],
    [[1.0, -NAN], [-NAN, 2.5], [0.0000005, 0.0000015]],
    [[999999.9999995, -999999.9999995, 5e-324, -123.4567895]],
    np.random.default_rng(0).standard_normal((30, 7)) * 100,
    np.zeros((3, 0)),
    np.zeros((0, 4)),
]


@pytest.mark.parametrize("block", FORMAT_BLOCKS,
                         ids=[f"block{i}" for i in range(len(FORMAT_BLOCKS))])
def test_format_matches_jax(jax_lib, block):
    values = np.asarray(block, dtype=np.float64)
    # the JAX wrapper's capacity holds 32 bytes a value: with every value
    # under that it formats natively
    assert all(len("%f " % v) < 32 for v in values.ravel())
    got = native.format_frames(values)
    assert got == jnative.format_frames(values)
    assert got == native.format_frames_plain(values)
    if (np.isnan(values) & np.signbit(values)).any():
        assert "-nan " in got


def test_format_where_the_jax_wrapper_falls_back():
    """The one case where the JAX package itself writes ``nan`` for a NaN
    with its sign bit: a block whose text passes its wrapper's capacity
    (nrows * ncols * 32 + nrows + 16 bytes) goes to Python's ``%f``.  The
    port writes ``-nan`` at every size."""
    small = np.array([[-NAN, 1e300, 1e300]])
    wide = np.array([[-NAN, 1e300] + [1.0] * 28])
    assert jnative.format_frames(small).startswith("nan ")
    assert jnative.format_frames(wide).startswith("-nan ")
    for values in (small, wide):
        got = native.format_frames(values)
        assert got.startswith("-nan ") and got == native.format_frames_plain(
            values)


EXTREMES = np.array([1.7976931348623157e308, -1.7976931348623157e308,
                     2.0 ** 53 - 1, 2.0 ** 63, 9.9999999999999e14,
                     999999999.9999999, 9999999.9999995, 0.9999996, -0.0,
                     5e-324, INF, -NAN] + [10.0 ** k for k in range(0, 308,
                                                                   7)])


@SETTINGS
@given(values=st.lists(st.floats(allow_nan=True, allow_infinity=True,
                                 width=64), min_size=1, max_size=40))
def test_format_capacity_bounds_the_text(values):
    block = np.array(values).reshape(1, -1)
    text = native.format_frames(block)
    assert len(text) < native.format_capacity(block)
    assert text == native.format_frames_plain(block)


def test_format_capacity_on_extremes():
    for block in (EXTREMES.reshape(1, -1), EXTREMES.reshape(-1, 1)):
        text = native.format_frames_plain(block)
        assert len(text) < native.format_capacity(block)
        assert native.format_frames(block) == text


@pytest.fixture(scope="module")
def database_bin(tmp_path_factory):
    rng = np.random.default_rng(5)
    F, J, R = 23, 4, 3
    db = {"bone_positions": rng.standard_normal((F, J, 3)),
          "bone_velocities": rng.standard_normal((F, J, 3)),
          "bone_rotations": rng.standard_normal((F, J, 4)),
          "bone_angular_velocities": rng.standard_normal((F, J, 3)),
          "bone_parents": np.arange(-1, J - 1),
          "range_starts": np.array([0, 8, 15]),
          "range_stops": np.array([8, 15, 23]),
          "style_labels": np.arange(R), "action_labels": np.arange(R),
          "contact_states": rng.integers(0, 2, (F, 2))}
    path = tmp_path_factory.mktemp("db") / "database.bin"
    jdatabase.save_database(str(path), db)
    return path.read_bytes(), db


def test_read_db_blocks_match_jax(jax_lib, database_bin):
    buf, db = database_bin
    offset = 0
    for key, ncomp in (("bone_positions", 3), ("bone_velocities", 3),
                       ("bone_rotations", 4),
                       ("bone_angular_velocities", 3)):
        want, want_next = jnative.read_db_block_f32(buf, offset, ncomp)
        for read in (native.read_db_block_f32,
                     native.read_db_block_f32_plain):
            got, nxt = read(buf, offset, ncomp)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert got.tobytes() == want.tobytes() and nxt == want_next
        np.testing.assert_array_equal(want, db[key].astype(np.float32))
        offset = want_next


@pytest.mark.parametrize("read", [native.read_db_block_f32,
                                  native.read_db_block_f32_plain],
                         ids=["native", "plain"])
def test_read_db_block_refuses_short_blocks(jax_lib, database_bin, read):
    buf, _ = database_bin
    block = 8 + 23 * 4 * 3 * 4
    truncated = buf[:block - 1]
    assert jnative.read_db_block_f32(truncated, 0, 3) is None
    with pytest.raises(ValueError, match="offset 0 "):
        read(truncated, 0, 3)
    with pytest.raises(ValueError, match=f"offset {len(buf) - 4} "):
        read(buf, len(buf) - 4, 3)
    with pytest.raises(ValueError, match="offset -8 "):
        read(buf, -8, 3)
    # the next block after the first is whole: no refusal
    assert read(buf, block, 3)[1] == 2 * block


def _probe_bvh(seed):
    """A BVH text whose MOTION block mixes the probe table's texts into a
    real block, with enough values for its frame count."""
    data = make_mocha_bvh_data(T=12, seed=seed)
    buf = io.StringIO()
    jbvh.save(buf, data)
    head, motion = buf.getvalue().split("Frame Time:")
    frame_time, rows = motion.split("\n", 1)
    rng = np.random.default_rng(seed)
    lines = []
    for row in rows.splitlines():
        tokens = row.split()
        at = sorted(rng.choice(len(tokens), 4, replace=False))
        for k in reversed(at):
            tokens.insert(int(k), PROBES[rng.integers(len(PROBES))][0])
        # a sign glued to the value before it
        lines.append(" ".join(tokens).replace(" -", "-"))
    return head + "Frame Time:" + frame_time + "\n" + "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bvh_load_reads_the_probe_tokens_as_jax_does(jax_lib, seed):
    text = _probe_bvh(seed)
    want = jbvh.load(io.StringIO(text))
    got = tbvh.load(io.StringIO(text))
    assert got.keys() == want.keys()
    assert got["names"] == want["names"] and got["order"] == want["order"]
    assert got["frametime"] == want["frametime"]
    np.testing.assert_array_equal(got["parents"], want["parents"])
    for key in ("rotations", "positions", "offsets"):
        assert got[key].shape == want[key].shape, key
        assert bits(got[key]) == bits(want[key]), key
    assert np.isinf(got["rotations"]).any() or np.isnan(
        got["rotations"]).any()


def test_bvh_save_writes_signed_nans_as_jax_does(jax_lib):
    data = make_mocha_bvh_data(T=5, seed=4)
    data["rotations"][2, 3, 1] = -NAN
    data["rotations"][1, 0, 0] = NAN
    got, want = io.StringIO(), io.StringIO()
    tbvh.save(got, data)
    jbvh.save(want, data)
    assert got.getvalue() == want.getvalue()
    assert "-nan " in got.getvalue()


def test_library_lives_in_the_port_build_dir():
    path = build.library_path(native.SOURCE)
    assert os.path.dirname(path) == os.path.join(PORT_DIR, "_build")
    assert native.SOURCE == os.path.join(PORT_DIR, "io", "csrc",
                                         "mocha_native.cpp")
    assert build.flags(native.SOURCE) == build.HOST_FLAGS
    assert "-march=native" not in build.HOST_FLAGS
    assert os.path.basename(native.get_lib()._name) == os.path.basename(path)


def test_nothing_under_native_is_opened(tmp_path):
    """A fresh process builds the codec into an empty build directory and
    reads and writes BVH text with it; no file it opens, no library it
    loads and no command it starts names the JAX package's native/
    directory."""
    code = f"""
import os, sys
seen = []
sys.addaudithook(lambda event, args: seen.append((event, repr(args)))
                 if event in ("open", "ctypes.dlopen", "subprocess.Popen",
                              "os.listdir", "os.scandir") else None)
import io
from mocha_sigasia2023_torch.ops import build
build.BUILD_DIR = {str(tmp_path)!r}
from mocha_sigasia2023_torch.io import bvh, native
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
buf = io.StringIO()
bvh.save(buf, make_mocha_bvh_data(T=4, seed=0))
bvh.load(io.StringIO(buf.getvalue()))
native.read_db_block_f32(bytes(8), 0, 3)
built = [a for e, a in seen if e == "subprocess.Popen"]
assert len(built) == 1 and "mocha_native.cpp" in built[0], built
bad = [s for s in seen if {os.path.join(REPO, "native")!r} in s[1]]
assert not bad, bad
print(len(seen))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


@pytest.fixture
def fresh_lib(tmp_path, monkeypatch):
    """get_lib with nothing loaded yet and an empty build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    native._load.cache_clear()
    yield tmp_path
    native._load.cache_clear()


def test_failed_build_raises_with_the_compiler_output(fresh_lib, monkeypatch):
    cc = fresh_lib / "cc"
    cc.write_text("#!/bin/sh\necho 'mocha_native.cpp:1: error: no good' "
                  ">&2\nexit 1\n")
    cc.chmod(0o755)
    monkeypatch.setattr(build, "find_cxx", lambda: str(cc))
    with pytest.raises(RuntimeError, match="(?s)cc failed on .*no good"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="no good"):
        tbvh.load(io.StringIO("HIERARCHY\nROOT a\n{\nOFFSET 0 0 0\n"
                              "CHANNELS 6 Xposition Yposition Zposition "
                              "Zrotation Xrotation Yrotation\n}\nMOTION\n"
                              "Frames: 1\nFrame Time: 0.1\n1 2 3 4 5 6\n"))
    assert not [f for f in os.listdir(fresh_lib) if f.endswith(".so")]


def test_unloadable_library_raises(fresh_lib):
    with open(build.library_path(native.SOURCE), "w") as f:
        f.write("not a library")
    with pytest.raises(RuntimeError, match="cannot load .*libmocha_native_"):
        native.get_lib()


def test_library_refusal_raises(monkeypatch):
    """A -1 from the library is a bug of the wrapper's sizing: it raises,
    and nothing falls back to Python."""
    lib = native.get_lib()
    for name in ("mocha_parse_floats", "mocha_format_frames",
                 "mocha_db_block_f32"):
        monkeypatch.setattr(lib, name, lambda *a: -1)
    with pytest.raises(RuntimeError, match="mocha_parse_floats"):
        native.parse_floats("1 2 3")
    with pytest.raises(RuntimeError, match="mocha_format_frames"):
        native.format_frames(np.ones((2, 2)))
    with pytest.raises(RuntimeError, match="mocha_db_block_f32"):
        native.read_db_block_f32(struct.pack("<II", 1, 1) + bytes(4), 0, 1)
