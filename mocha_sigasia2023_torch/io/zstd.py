"""A zstd frame decoder (RFC 8878) and a raw-block encoder, in Python and
NumPy.

orbax writes each zarr chunk of a checkpoint as a zstd frame, and the
OCDBT store that holds them compresses its manifests and B-tree nodes with
zstd too.  The card's machine has no zstd module, so the port reads them
here:

- frames: the header (window descriptor, frame content size, the
  single-segment flag; a dictionary ID other than 0 is refused), skippable
  frames, frames concatenated, and the XXH64 content checksum, verified
  when the frame sets its flag;
- blocks: raw, RLE and compressed;
- literals: raw, RLE, Huffman-coded in 1 or 4 streams, and treeless (the
  previous block's Huffman table);
- sequences: FSE tables in predefined, RLE, compressed and repeat modes,
  and the three repeat offsets.

A corrupt or truncated input raises ``ValueError`` naming the byte offset
in that input.

Speed: a checkpoint's value frames are mostly Huffman-coded literals (the
mantissas of float weights).  ``decompress_many`` therefore parses every
frame first and then decodes every Huffman stream of all of them together,
one NumPy step a symbol for all streams at once, from tables that take a
whole 11-bit code window at a lookup.  Literal runs and match copies move
as byte slices; a match that overlaps its own output is built by tiling.

``compress`` writes frames of raw blocks only (no entropy coding), with
the content size set: a legal zstd stream that any decoder reads.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50     # low 4 bits free: 0x184D2A50..0x184D2A5F
BLOCK_MAX = 128 * 1024
HUF_MAX_BITS = 11                 # RFC 8878 §4.2.1: longest Huffman code
_M64 = (1 << 64) - 1

# RFC 8878 §3.1.1.3.2.1: literal-length and match-length codes as
# (baseline, extra bits), and the predefined FSE distributions
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
LL_DEFAULT = ([4, 3] + [2] * 11 + [1] * 3 + [2] * 9 + [3, 2] + [1] * 5
              + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of each sequence table
LL_LIMITS, ML_LIMITS, OF_LIMITS = (35, 9), (52, 9), (31, 8)


def _fail(what: str, at: int):
    raise ValueError(f"zstd: {what} at offset {at}")


# ---------------------------------------------------------------------------
# XXH64 (the content checksum's hash)
# ---------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    data = bytes(data)
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        end = n - n % 32
        for a, b, c, d in struct.iter_unpack("<4Q", data[:end]):
            v = [_round(v[0], a), _round(v[1], b), _round(v[2], c),
                 _round(v[3], d)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        i = end
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, i)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    for b in data[i:]:
        h = _rotl(h ^ (b * _P5 & _M64), 11) * _P1 & _M64
    h = (h ^ (h >> 33)) * _P2 & _M64
    h = (h ^ (h >> 29)) * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bitstreams
# ---------------------------------------------------------------------------

_PAD = 16   # zero bytes below bit 0 of a backward stream


class _Backward:
    """A bitstream read from its end toward its start (RFC 8878 §4.1): the
    last byte's highest set bit marks where the bits begin.  Bits below the
    stream's start read as 0 (up to ``_PAD`` bytes of them), and ``left``
    goes negative: the FSE decoders stop on that."""

    def __init__(self, data, start: int, end: int):
        if end <= start:
            _fail("an empty bitstream", start)
        last = data[end - 1]
        if last == 0:
            _fail("a bitstream with no end mark", end - 1)
        self.buf = bytes(_PAD) + bytes(data[start:end]) + bytes(8)
        self.pos = 8 * (end - start - 1 + _PAD) + last.bit_length() - 1
        self.start = start

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo < 0:
            _fail("a bitstream read past its start", self.start)
        word = int.from_bytes(self.buf[lo >> 3:(lo >> 3) + 9], "little")
        return (word >> (lo & 7)) & ((1 << n) - 1)

    @property
    def left(self) -> int:
        """Bits not yet read (negative once reads passed the start)."""
        return self.pos - 8 * _PAD


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------


def _read_fse_counts(data, at: int, end: int, limits):
    """An FSE table description (RFC 8878 §4.1.1) at ``data[at:]``:
    returns (normalized counts, accuracy log, bytes used)."""
    max_symbol, max_log = limits
    avail = bytes(data[at:min(end, at + 512)])   # a description is shorter
    bits = int.from_bytes(avail, "little")
    nbits = 8 * len(avail)
    if nbits < 4:
        _fail("a truncated FSE table description", at)
    log = (bits & 0xF) + 5
    if log > max_log:
        _fail(f"an FSE accuracy log {log} over {max_log}", at)
    pos = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    width = log + 1
    counts: List[int] = []
    zero_run = False
    while remaining > 1 and len(counts) <= max_symbol:
        if zero_run:
            while True:
                rep = (bits >> pos) & 3
                pos += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                _fail("an FSE zero run past the last symbol", at)
        top = (2 * threshold - 1) - remaining
        low = (bits >> pos) & (threshold - 1)
        if low < top:
            value, pos = low, pos + width - 1
        else:
            value = (bits >> pos) & (2 * threshold - 1)
            if value >= threshold:
                value -= top
            pos += width
        count = value - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        zero_run = count == 0
        while remaining < threshold:
            width -= 1
            threshold >>= 1
        if pos > nbits:
            _fail("a truncated FSE table description", at)
    if remaining != 1 or len(counts) > max_symbol + 1 or pos > nbits:
        _fail("a corrupt FSE table description", at)
    return counts, log, (pos + 7) >> 3


def _fse_table(counts, log):
    """Decoding table of normalized ``counts`` (RFC 8878 §4.1.1): a list of
    (symbol, bits to read, baseline) per state."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ValueError("zstd: FSE counts do not fill the table")
    table = []
    for s in symbols:
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table, log


# the predefined tables (RFC 8878 §3.1.1.3.2.2)
LL_TABLE = _fse_table(*LL_DEFAULT)
ML_TABLE = _fse_table(*ML_DEFAULT)
OF_TABLE = _fse_table(*OF_DEFAULT)


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------




def _huffman_weights(data, at: int, end: int):
    """The Huffman tree description (RFC 8878 §4.2.1.1): the weights of
    every symbol but the last, and the bytes used."""
    if at >= end:
        _fail("a truncated Huffman tree description", at)
    head = data[at]
    if head >= 128:   # 4-bit weights, two a byte
        n = head - 127
        size = (n + 1) // 2
        if at + 1 + size > end:
            _fail("a truncated Huffman tree description", at)
        weights = []
        for b in data[at + 1:at + 1 + size]:
            weights += [b >> 4, b & 15]
        return weights[:n], 1 + size
    if head == 0 or at + 1 + head > end:
        _fail("a truncated Huffman tree description", at)
    counts, log, used = _read_fse_counts(data, at + 1, at + 1 + head, (255, 6))
    table, _ = _fse_table(counts, log)
    bits = _Backward(data, at + 1 + used, at + 1 + head)
    states = [bits.read(log), bits.read(log)]
    weights = []
    # two states over one stream, in turn, until a state update reads past
    # the stream's start; then the other state's symbol is the last
    while True:
        for k in (0, 1):
            sym, nb, base = table[states[k]]
            weights.append(sym)
            states[k] = base + bits.read(nb)
            if bits.left < 0:
                weights.append(table[states[1 - k]][0])
                return weights, 1 + head
            if len(weights) > 255:
                _fail("more than 255 Huffman weights", at)


def _huffman_table(weights, at: int) -> np.ndarray:
    """The decoding table of ``weights`` (the last weight implied), over
    every 11-bit window: entry = symbol | code length << 8."""
    if max(weights, default=0) > HUF_MAX_BITS:
        _fail("a Huffman weight over 11", at)
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("Huffman weights that are all 0", at)
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > HUF_MAX_BITS or rest & (rest - 1):
        _fail("Huffman weights that do not complete a code", at)
    w = np.array(list(weights) + [rest.bit_length()], np.int64)
    syms = np.flatnonzero(w)
    syms = syms[np.lexsort((syms, w[syms]))]   # by weight, then symbol
    entry = (syms | (max_bits + 1 - w[syms]) << 8).astype(np.uint16)
    table = np.repeat(entry, 1 << (w[syms] - 1))
    return np.repeat(table, 1 << (HUF_MAX_BITS - max_bits))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _Frame:
    """What one frame's blocks carry to the next: the Huffman table, the
    sequence tables (repeat mode) and the repeat offsets."""

    def __init__(self):
        self.huffman = None        # index into the decode's table list
        self.tables = {}           # "ll" / "of" / "ml" -> (table, log)
        self.reps = [1, 4, 8]
        self.blocks = []           # ("bytes", b) | ("seq", lits, seqs, at)


_GROUP_BYTES = 64 << 20


def _huffman_steps(words, tables, lo, toff, cnt):
    """Decode streams in lockstep, one symbol of each a step; ``lo`` (bit
    positions of each stream's 11-bit window, updated in place), ``cnt``
    descending.  Returns the symbols as (steps, streams)."""
    n = len(lo)
    rows = np.zeros((int(cnt[0]), n), np.uint8)
    mask = (1 << HUF_MAX_BITS) - 1
    k = n
    for step in range(int(cnt[0])):
        while cnt[k - 1] <= step:
            k -= 1
        b = lo[:k]
        win = (words.take(b >> 3, mode="clip")
               >> (b & 7).astype(np.uint32)).astype(lo.dtype) & mask
        e = tables.take(toff[:k] + win)
        rows[step, :k] = e
        lo[:k] -= e >> 8
    return rows


class _Decode:
    """One ``decompress_many`` call: the Huffman tables and streams of
    every frame, decoded together."""

    def __init__(self):
        self.tables: List[np.ndarray] = []
        self.streams = []          # (data, start, end, symbols, table)

    def literals(self, data, at: int, end: int, frame: _Frame):
        """A literals section: returns (literals, where the section ends);
        Huffman literals come back as ("huffman", first stream, count) and
        are filled in by ``run``."""
        b0 = data[at]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind < 2:   # raw or RLE
            hdr = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
            if at + hdr > end:
                _fail("a truncated literals header", at)
            head = int.from_bytes(data[at:at + hdr], "little")
            size = head >> 3 if hdr == 1 else head >> 4
            if size > BLOCK_MAX:
                _fail("literals over the block size", at)
            at += hdr
            if kind == 0:
                if at + size > end:
                    _fail("truncated raw literals", at)
                return bytes(data[at:at + size]), at + size
            if at >= end:
                _fail("truncated RLE literals", at)
            return bytes(data[at:at + 1]) * size, at + 1
        hdr, width = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
        if at + hdr > end:
            _fail("a truncated literals header", at)
        head = int.from_bytes(data[at:at + hdr], "little") >> 4
        size, csize = head & ((1 << width) - 1), head >> width
        if size > BLOCK_MAX:
            _fail("literals over the block size", at)
        pos, stop = at + hdr, at + hdr + csize
        if stop > end:
            _fail("truncated Huffman literals", at)
        if kind == 2:
            weights, used = _huffman_weights(data, pos, stop)
            self.tables.append(_huffman_table(weights, pos))
            frame.huffman = len(self.tables) - 1
            pos += used
        elif frame.huffman is None:
            _fail("treeless literals with no earlier Huffman table", at)
        if fmt == 0:
            bounds, counts = [pos, stop], [size]
        else:
            if stop - pos < 6:
                _fail("a truncated jump table", pos)
            s1, s2, s3 = struct.unpack_from("<3H", data, pos)
            pos += 6
            bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
            seg = (size + 3) // 4
            counts = [seg, seg, seg, size - 3 * seg]
            if bounds[3] > stop or counts[3] < 0:
                _fail("a jump table past the literals", pos - 6)
        first = len(self.streams)
        for lo, hi, n in zip(bounds, bounds[1:], counts):
            if hi <= lo:
                _fail("an empty Huffman stream", lo)
            self.streams.append((data, lo, hi, n, frame.huffman))
        return ("huffman", first, size), stop

    def run(self):
        """Every Huffman stream decoded: returns (out, starts), stream i's
        symbols at ``out[starts[i]:starts[i + 1]]``."""
        n = len(self.streams)
        counts = np.array([s[3] for s in self.streams], np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)])
        out = np.zeros(int(starts[-1]), np.uint8)
        if n == 0 or starts[-1] == 0:
            return out, starts
        # every stream behind 4 zero bytes (bits below a stream read as 0)
        parts, base = [], np.zeros(n, np.int64)
        at = 0
        for i, (data, lo, hi, _, _) in enumerate(self.streams):
            parts += [bytes(4), data[lo:hi]]
            base[i] = at + 4
            at += 4 + hi - lo
        buf = np.frombuffer(b"".join(parts) + bytes(4), np.uint8)
        words = np.ndarray((len(buf) - 3,), "<u4", buf, 0, (1,)).copy()
        last = np.array([s[0][s[2] - 1] for s in self.streams], np.int64)
        if (last == 0).any():
            i = int(np.flatnonzero(last == 0)[0])
            _fail("a Huffman stream with no end mark", self.streams[i][2] - 1)
        size = np.array([s[2] - s[1] for s in self.streams], np.int64)
        top = 8 * (base + size - 1) + np.floor(np.log2(last)).astype(np.int64)
        # bit positions in int32 (faster) unless the streams pass 256 MB
        pos = np.int32 if top.max() < (1 << 31) - 64 else np.int64
        tables = np.concatenate(self.tables).astype(pos)
        toff = np.array([s[4] for s in self.streams], pos) << HUF_MAX_BITS
        order = np.argsort(-counts, kind="stable")
        lo = (top - HUF_MAX_BITS).astype(pos)[order]
        toff, cnt = toff[order], counts[order]
        # streams in groups, longest first, each group's symbols in a
        # (steps, streams) array of at most _GROUP_BYTES
        first = 0
        while first < n:
            width = max(1, min(n - first,
                               _GROUP_BYTES // max(int(cnt[first]), 1)))
            group = slice(first, first + width)
            rows = _huffman_steps(words, tables, lo[group], toff[group],
                                  cnt[group])
            for j, lane in enumerate(order[group]):
                out[starts[lane]:starts[lane + 1]] = rows[:cnt[first + j], j]
            first += width
        bad = lo != 8 * base[order] - HUF_MAX_BITS
        if bad.any():
            i = int(order[np.flatnonzero(bad)[0]])
            _fail("a Huffman stream that does not end at its start",
                  self.streams[i][1])
        return out, starts


def _sequence_table(data, at: int, end: int, mode: int, kind: str,
                    frame: _Frame):
    """One of a block's three sequence tables: returns ((table, log),
    bytes used)."""
    limits = {"ll": LL_LIMITS, "of": OF_LIMITS, "ml": ML_LIMITS}[kind]
    if mode == 0:
        table = {"ll": LL_TABLE, "of": OF_TABLE, "ml": ML_TABLE}[kind]
        used = 0
    elif mode == 1:
        if at >= end:
            _fail("a truncated RLE sequence table", at)
        if data[at] > limits[0]:
            _fail(f"an RLE {kind} symbol over {limits[0]}", at)
        table, used = ([(data[at], 0, 0)], 0), 1
    elif mode == 2:
        counts, log, used = _read_fse_counts(data, at, end, limits)
        table = _fse_table(counts, log)
    else:
        table = frame.tables.get(kind)
        if table is None:
            _fail(f"a repeated {kind} table with none before it", at)
        used = 0
    frame.tables[kind] = table
    return table, used


def _sequences(data, at: int, end: int, frame: _Frame):
    """A block's sequences section: [(literal length, match length,
    offset)], repeat offsets resolved."""
    if at >= end:
        _fail("a truncated sequences section", at)
    b0 = data[at]
    if b0 == 0:
        if at + 1 != end:
            _fail("bytes after an empty sequences section", at + 1)
        return []
    if b0 < 128:
        n, at = b0, at + 1
    elif b0 < 255:
        if at + 2 > end:
            _fail("a truncated sequence count", at)
        n, at = ((b0 - 128) << 8) + data[at + 1], at + 2
    else:
        if at + 3 > end:
            _fail("a truncated sequence count", at)
        n, at = data[at + 1] + (data[at + 2] << 8) + 0x7F00, at + 3
    if at >= end:
        _fail("a truncated sequences section", at)
    modes = data[at]
    if modes & 3:
        _fail("reserved bits set in the sequence modes", at)
    at += 1
    tabs = {}
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        tabs[kind], used = _sequence_table(data, at, end, (modes >> shift) & 3,
                                           kind, frame)
        at += used
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = (tabs["ll"], tabs["of"],
                                                      tabs["ml"])
    bits = _Backward(data, at, end)
    ll_s, of_s, ml_s = bits.read(ll_log), bits.read(of_log), bits.read(ml_log)
    reps = frame.reps
    seqs = []
    read = bits.read
    for i in range(n):
        of_code, ml_code, ll_code = of_t[of_s][0], ml_t[ml_s][0], ll_t[ll_s][0]
        if of_code > 31:
            _fail(f"an offset code {of_code}", at)
        value = (1 << of_code) + read(of_code)
        base, nb = ML_CODES[ml_code]
        ml = base + read(nb)
        base, nb = LL_CODES[ll_code]
        ll = base + read(nb)
        if value > 3:
            off = value - 3
            reps = [off, reps[0], reps[1]]
        else:
            r = value - 1 + (ll == 0)
            if r == 0:
                off = reps[0]
            elif r == 3:
                off = reps[0] - 1
                reps = [off, reps[0], reps[1]]
            else:
                off = reps[r]
                reps = [off, reps[0], reps[3 - r]]
            if off <= 0:
                _fail("a repeat offset of 0", at)
        seqs.append((ll, ml, off))
        if i + 1 < n:
            _, nb, base = ll_t[ll_s]
            ll_s = base + read(nb)
            _, nb, base = ml_t[ml_s]
            ml_s = base + read(nb)
            _, nb, base = of_t[of_s]
            of_s = base + read(nb)
        if bits.left < 0:
            _fail("a sequence bitstream read past its start", at)
    if bits.left != 0:
        _fail(f"{bits.left} bits left after the last sequence", at)
    frame.reps = reps
    return seqs


def _parse(data, decode: _Decode):
    """The frames of one input, parsed: [(_Frame, checksum or None,
    content size or None, offset)]."""
    frames = []
    pos, n = 0, len(data)
    while pos < n:
        if pos + 4 > n:
            _fail("a truncated frame magic", pos)
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
            if pos + 8 > n:
                _fail("a truncated skippable frame", pos)
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos + 8 + size > n:
                _fail("a truncated skippable frame", pos)
            pos += 8 + size
            continue
        if magic != MAGIC:
            _fail(f"an unknown frame magic 0x{magic:08x}", pos)
        start = pos
        if pos + 5 > n:
            _fail("a truncated frame header", pos)
        fhd = data[pos + 4]
        pos += 5
        if fhd & 0x08:
            _fail("the reserved frame header bit set", pos - 1)
        single = bool(fhd & 0x20)
        has_sum = bool(fhd & 0x04)
        did_size = (0, 1, 2, 4)[fhd & 3]
        fcs_size = ((1 if single else 0), 2, 4, 8)[fhd >> 6]
        need = (0 if single else 1) + did_size + fcs_size
        if pos + need > n:
            _fail("a truncated frame header", start)
        window = None
        if not single:
            wd = data[pos]
            pos += 1
            base = 1 << (10 + (wd >> 3))
            window = base + (base >> 3) * (wd & 7)
        if int.from_bytes(data[pos:pos + did_size], "little"):
            _fail("a frame that needs a dictionary", pos)
        pos += did_size
        size = None
        if fcs_size:
            size = int.from_bytes(data[pos:pos + fcs_size], "little")
            size += 256 if fcs_size == 2 else 0
            pos += fcs_size
        block_max = min(size if single else window, BLOCK_MAX)
        frame = _Frame()
        while True:
            if pos + 3 > n:
                _fail("a truncated block header", pos)
            head = int.from_bytes(data[pos:pos + 3], "little")
            last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
            pos += 3
            if kind == 3:
                _fail("a reserved block type", pos - 3)
            if bsize > block_max:
                _fail(f"a block of {bsize} bytes over {block_max}", pos - 3)
            if kind == 0:
                if pos + bsize > n:
                    _fail("a truncated raw block", pos)
                frame.blocks.append(("bytes", bytes(data[pos:pos + bsize])))
                pos += bsize
            elif kind == 1:
                if pos >= n:
                    _fail("a truncated RLE block", pos)
                frame.blocks.append(("bytes",
                                     bytes(data[pos:pos + 1]) * bsize))
                pos += 1
            else:
                end = pos + bsize
                if end > n:
                    _fail("a truncated compressed block", pos)
                lits, at = decode.literals(data, pos, end, frame)
                frame.blocks.append(("seq", lits, _sequences(data, at, end,
                                                             frame), pos))
                pos = end
            if last:
                break
        checksum = None
        if has_sum:
            if pos + 4 > n:
                _fail("a truncated content checksum", pos)
            checksum = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        frames.append((frame, checksum, size, start, block_max))
    return frames


def _execute(frame: _Frame, huffman, block_max: int, start: int) -> bytes:
    """A parsed frame's content: literals and matches in sequence order."""
    out = bytearray()
    sym, starts = huffman
    for block in frame.blocks:
        if block[0] == "bytes":
            out += block[1]
            continue
        _, lits, seqs, at = block
        if isinstance(lits, tuple):
            _, first, size = lits
            lo = int(starts[first])
            lits = memoryview(sym)[lo:lo + size]
        before = len(out)
        lp = 0
        for ll, ml, off in seqs:
            if ll:
                if lp + ll > len(lits):
                    _fail("sequences past the block's literals", at)
                out += lits[lp:lp + ll]
                lp += ll
            here = len(out)
            if off > here:
                _fail(f"a match offset {off} before the frame's start", at)
            src = here - off
            if ml <= off:
                out += out[src:src + ml]
            else:   # the match overlaps its own output: repeat the period
                period = bytes(out[src:here])
                out += (period * (ml // off + 1))[:ml]
        out += lits[lp:]
        if len(out) - before > block_max:
            _fail("a block that decodes past the block size", at)
    return bytes(out)


def decompress_many(items: Sequence) -> List[bytes]:
    """Each input (one or more concatenated zstd frames, skippable frames
    allowed) decompressed; the Huffman streams of all of them are decoded
    together."""
    decode = _Decode()
    parsed = [_parse(data, decode) for data in items]
    huffman = decode.run()
    outs = []
    for frames in parsed:
        parts = []
        for frame, checksum, size, start, block_max in frames:
            content = _execute(frame, huffman, block_max, start)
            if size is not None and len(content) != size:
                _fail(f"{len(content)} bytes where the frame header says "
                      f"{size}", start)
            if checksum is not None and \
                    xxh64(content) & 0xFFFFFFFF != checksum:
                _fail("a content checksum mismatch", start)
            parts.append(content)
        outs.append(b"".join(parts))
    return outs


def decompress(data) -> bytes:
    """The content of ``data``: one or more zstd frames."""
    return decompress_many([data])[0]


def compress(data) -> bytes:
    """One zstd frame of raw blocks holding ``data``, its content size in
    the header (single segment, no checksum)."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        flag, fcs = 0, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        flag, fcs = 1, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        flag, fcs = 2, n.to_bytes(4, "little")
    else:
        flag, fcs = 3, n.to_bytes(8, "little")
    parts = [MAGIC.to_bytes(4, "little"), bytes([flag << 6 | 0x20]), fcs]
    offsets = list(range(0, n, BLOCK_MAX)) or [0]
    for i, lo in enumerate(offsets):
        chunk = data[lo:lo + BLOCK_MAX]
        last = i == len(offsets) - 1
        parts += [(len(chunk) << 3 | int(last)).to_bytes(3, "little"), chunk]
    return b"".join(parts)
