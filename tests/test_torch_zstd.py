"""The port's zstd decoder and raw-block encoder (io/zstd.py) against the
``zstandard`` package.

Frames that ``zstandard`` writes at levels 1, 3, 9 and 19, with and
without the content checksum and the content size, single- and
multi-block, alone and concatenated, over random, repetitive and
float32-array inputs (hypothesis, derandomized), must decode byte for
byte.  Hand-built raw, RLE and skippable frames decode; a truncated or
corrupted frame raises ``ValueError`` naming an offset.  ``zstandard``
must read the encoder's frames.
"""

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from mocha_sigasia2023_torch.io import zstd  # noqa: E402

LEVELS = (1, 3, 9, 19)
SETTINGS = settings(max_examples=12, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _frame(data, level, checksum=False, content_size=True):
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)


def _floats(seed, n, decimals):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return (np.round(x, decimals) if decimals >= 0 else x).tobytes()


random_bytes = st.binary(max_size=4096)
repetitive = st.lists(
    st.tuples(st.binary(min_size=1, max_size=24), st.integers(1, 600)),
    min_size=1, max_size=6).map(lambda parts: b"".join(p * n for p, n in
                                                        parts))
float_arrays = st.builds(_floats, st.integers(0, 2**16), st.integers(1, 6000),
                         st.integers(-1, 3))
inputs = st.one_of(random_bytes, repetitive, float_arrays)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [False, True])
@SETTINGS
@given(data=inputs)
def test_decodes_zstandard_frames(level, checksum, data):
    assert zstd.decompress(_frame(data, level, checksum)) == data


@pytest.mark.parametrize("level", LEVELS)
def test_decodes_multi_block_frames_with_and_without_content_size(level):
    """Inputs past one 128 KiB block: the Huffman table and the sequence
    tables carried across blocks (treeless literals, repeat modes)."""
    rng = np.random.default_rng(level)
    data = (_floats(level, 90_000, -1) + bytes(50_000)
            + _floats(level + 1, 40_000, 2)
            + b"".join(rng.integers(0, 4, 3000).astype(np.uint8).tobytes()
                       * 20 for _ in range(3)))
    for size in (True, False):
        frame = _frame(data, level, checksum=True, content_size=size)
        assert zstd.decompress(frame) == data


@SETTINGS
@given(parts=st.lists(inputs, min_size=2, max_size=4),
       level=st.sampled_from(LEVELS))
def test_decodes_concatenated_and_skippable_frames(parts, level):
    skip = (zstd.SKIPPABLE_MAGIC + 3).to_bytes(4, "little") + \
        (5).to_bytes(4, "little") + b"12345"
    stream = skip.join(_frame(p, level, i % 2 == 0)
                       for i, p in enumerate(parts))
    assert zstd.decompress(stream) == b"".join(parts)


def test_decompress_many_equals_one_at_a_time():
    items = [_frame(_floats(s, 40_000, -1), LEVELS[s % 4]) for s in range(6)]
    items.append(_frame(b"abc" * 1000, 19))
    assert zstd.decompress_many(items) == [zstd.decompress(i)
                                           for i in items]


def _hand_frame(blocks, size=None):
    """A frame of hand-built blocks: (type, payload, regenerated size)."""
    head = zstd.MAGIC.to_bytes(4, "little")
    if size is None:
        head += bytes([0x00, 0x00])            # window descriptor: 1 KiB
    else:
        head += bytes([0x20, size])            # single segment, 1-byte FCS
    out = [head]
    for i, (kind, payload, n) in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        out.append((n << 3 | kind << 1 | last).to_bytes(3, "little"))
        out.append(payload)
    return b"".join(out)


def test_hand_built_raw_and_rle_blocks():
    frame = _hand_frame([(0, b"hello ", 6), (1, b"z", 5), (0, b"!", 1)])
    assert zstd.decompress(frame) == b"hello zzzzz!"
    assert zstandard.ZstdDecompressor().decompress(
        _hand_frame([(0, b"abc", 3), (1, b"-", 4)], size=7)) == b"abc----"
    assert zstd.decompress(_hand_frame([(0, b"abc", 3), (1, b"-", 4)],
                                       size=7)) == b"abc----"


def test_truncated_and_corrupt_frames_raise_naming_an_offset():
    data = _floats(7, 20_000, -1) + b"tail" * 500
    frame = _frame(data, 3, checksum=True)
    for cut in (3, 5, 9, len(frame) // 2, len(frame) - 2):
        with pytest.raises(ValueError, match="offset"):
            zstd.decompress(frame[:cut])
    bad = bytearray(frame)
    bad[-1] ^= 0xFF                            # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" * 8)
    # a frame that names a dictionary is refused
    with_dict = bytearray(_hand_frame([(0, b"x", 1)]))
    with_dict[4] |= 0x01
    with_dict[6:6] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(with_dict))


@SETTINGS
@given(data=st.one_of(random_bytes, repetitive, float_arrays))
def test_raw_block_encoder_is_read_by_zstandard(data):
    frame = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data


def test_raw_block_encoder_splits_blocks_and_sets_the_content_size():
    for n in (0, 255, 256, 65_791, 65_792, 3 * zstd.BLOCK_MAX + 5):
        data = bytes(range(256)) * (n // 256) + bytes(n % 256)
        frame = zstd.compress(data)
        params = zstandard.get_frame_parameters(frame)
        assert params.content_size == n
        assert zstandard.ZstdDecompressor().decompress(frame) == data


def test_xxh64_published_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = bytes(range(256)) * 3 + b"tail"
    frame = _frame(data, 3, checksum=True)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:],
                                                           "little")
