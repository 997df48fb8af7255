"""The OCDBT key-value store that orbax checkpoints live in, read and
written in Python.

tensorstore's OCDBT format (the "Optionally-cooperative distributed B+tree"
driver that orbax's ``StandardCheckpointer`` writes through) keeps a
directory:

- ``manifest.ocdbt``: the store's config and its version tree, whose
  newest version names the root of a B+tree;
- ``d/<id>``: data files holding B+tree nodes and the values too large to
  sit inline in a leaf.

Every manifest and node file is framed the same way: a 4-byte magic
(big-endian), the file's length (uint64, little-endian), a format version
and a compression (varints: 0 none, 1 zstd), the body, and a CRC-32C of
everything before it (little-endian).  Inside a body, lists are stored by
column: all key-prefix lengths, then all suffix lengths, and so on.  Data
files are named through a table of paths, each sharing a prefix with the
previous one.  Interior nodes store each child's keys without the prefix
that all keys under the child share.

Orbax writes one store a process under ``ocdbt.process_<i>/`` and a root
manifest whose B+tree covers all of their keys.  ``Store`` reads the
root manifest, or, where a directory has none, merges the per-process
stores; it indexes the keys and reads values on demand, ``read_store``
all at once.  A numbered manifest (``manifest.<n>``), a manifest with no
inline version and a corrupt or truncated file are refused with
``ValueError``.
"""

from __future__ import annotations

import glob
import os
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
NO_ROOT = (1 << 64) - 1           # a version's offset and length when empty
# the config orbax 0.11.32 gives its stores
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected 0x82F63B78) of ``data``."""
    crc ^= 0xFFFFFFFF
    table = _CRC
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads a decoded body; errors name the file and the offset."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def fail(self, what: str, at: Optional[int] = None):
        at = self.pos if at is None else at
        raise ValueError(f"ocdbt: {what} at offset {at} of {self.name}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted, "
                      f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("a varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _unframe(raw: bytes, magic: int, name: str) -> bytes:
    """A manifest's or node's body, its frame and checksum verified."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: a truncated file at offset 0 of {name}")
    cur = _Cursor(raw, name)
    found = int.from_bytes(cur.take(4), "big")
    if found != magic:
        cur.fail(f"magic 0x{found:08x} where 0x{magic:08x} belongs", 0)
    length = cur.u64()
    if length != len(raw):
        cur.fail(f"a length of {length} in a file of {len(raw)} bytes", 4)
    want = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want:
        cur.fail("a CRC-32C mismatch", len(raw) - 4)
    version = cur.varint()
    if version != 0:
        cur.fail(f"format version {version}")
    method = cur.varint()
    body = raw[cur.pos:-4]
    if method == 1:
        return zstd.decompress(body)
    if method != 0:
        cur.fail(f"compression {method}")
    return body


def _frame(body: bytes, magic: int) -> bytes:
    """The file holding ``body`` uncompressed."""
    head = magic.to_bytes(4, "big")
    tail = _varint(0) + _varint(0)
    length = len(head) + 8 + len(tail) + len(body) + 4
    raw = head + length.to_bytes(8, "little") + tail + body
    return raw + crc32c(raw).to_bytes(4, "little")


def _read_files(cur: _Cursor) -> List[str]:
    """The data-file table: paths relative to the store's directory."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        if p > len(prev):
            cur.fail("a path prefix longer than the path before it")
        path = prev[:p] + cur.take(s)
        if b > len(path):
            cur.fail("a base path longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


def _write_files(paths: List[str]) -> bytes:
    out = [_varint(len(paths))]
    enc = [p.encode() for p in paths]
    shared = []
    for a, b in zip(enc, enc[1:]):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        shared.append(n)
    out += [_varint(n) for n in shared]
    out += [_varint(len(p) - n) for p, n in zip(enc, [0] + shared)]
    out += [_varint(0) for _ in enc]
    out += [p[n:] for p, n in zip(enc, [0] + shared)]
    return b"".join(out)


def _read_keys(cur: _Cursor, n: int, interior: bool):
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail("a key prefix longer than the key before it")
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, common


class Store:
    """An OCDBT store opened for reading: its keys, and each value read
    from its data file on demand."""

    def __init__(self, path: str):
        self.path = path
        self.refs: Dict[bytes, Tuple] = {}   # key -> ("inline", bytes) |
        # ("file", path, offset, length)
        manifest = os.path.join(path, MANIFEST)
        if os.path.exists(manifest):
            self._add_tree(path)
        else:
            subs = sorted(glob.glob(os.path.join(path, "ocdbt.process_*",
                                                 MANIFEST)))
            if not subs:
                raise ValueError(f"ocdbt: no {MANIFEST} under {path}")
            for sub in subs:
                self._add_tree(os.path.dirname(sub))

    def _read(self, root: str, rel: str, offset: int, length: int) -> bytes:
        name = os.path.join(root, rel)
        with open(name, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {length} bytes wanted at offset "
                             f"{offset} of {name}, {len(data)} there")
        return data

    def _add_tree(self, root: str):
        name = os.path.join(root, MANIFEST)
        with open(name, "rb") as f:
            raw = f.read()
        cur = _Cursor(_unframe(raw, MANIFEST_MAGIC, name), name)
        cur.take(16)                                   # uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind} (numbered manifests)")
        cur.varint(), cur.varint(), cur.byte()         # config limits
        if cur.varint() == 1:
            cur.take(4)                                # zstd level
        files = _read_files(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("a manifest with no inline version")
        gens = cur.varints(n)
        heights = list(cur.take(n))
        fids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        nkeys = cur.varints(n)
        cur.varints(n), cur.varints(n)                 # tree / value bytes
        for _ in range(n):
            cur.u64()                                  # commit times
        i = max(range(n), key=gens.__getitem__)
        if nkeys[i] == 0 or offsets[i] == NO_ROOT:
            return
        if fids[i] >= len(files):
            cur.fail(f"data file {fids[i]} of {len(files)}")
        self._add_node(root, files[fids[i]], offsets[i], lengths[i],
                       heights[i], b"")

    def _add_node(self, root: str, rel: str, offset: int, length: int,
                  height: int, prefix: bytes):
        name = f"{os.path.join(root, rel)}@{offset}"
        raw = self._read(root, rel, offset, length)
        cur = _Cursor(_unframe(raw, NODE_MAGIC, name), name)
        if cur.byte() != height:
            cur.fail(f"a node whose height is not {height}", 0)
        files = _read_files(cur)
        n = cur.varint()
        keys, common = _read_keys(cur, n, height > 0)

        def file_of(fid):
            if fid >= len(files):
                cur.fail(f"data file {fid} of {len(files)}")
            return files[fid]

        if height > 0:
            fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            for k, c, fid, off, ln in zip(keys, common, fids, offs, lens):
                if c > len(k):
                    cur.fail("a subtree prefix longer than its key")
                self._add_node(root, file_of(fid), off, ln, height - 1,
                               prefix + k[:c])
            return
        lens = cur.varints(n)
        kinds = list(cur.take(n))
        if any(k > 1 for k in kinds):
            cur.fail("a value kind other than inline or indirect")
        indirect = sum(kinds)
        fids, offs = cur.varints(indirect), cur.varints(indirect)
        refs = iter(zip(fids, offs))
        for key, ln, kind in zip(keys, lens, kinds):
            if kind:
                fid, off = next(refs)
                self.refs[prefix + key] = ("file", os.path.join(
                    root, file_of(fid)), off, ln)
            else:
                self.refs[prefix + key] = ("inline", cur.take(ln))

    def keys(self) -> List[bytes]:
        return sorted(self.refs)

    def __contains__(self, key: bytes) -> bool:
        return key in self.refs

    def read_many(self, keys: Iterable[bytes]) -> List[bytes]:
        """The values of ``keys``; each data file is read once."""
        keys = list(keys)
        whole: Dict[str, bytes] = {}
        out = []
        for key in keys:
            if key not in self.refs:
                raise KeyError(key)
            ref = self.refs[key]
            if ref[0] == "inline":
                out.append(ref[1])
                continue
            _, name, off, ln = ref
            if name not in whole:
                with open(name, "rb") as f:
                    whole[name] = f.read()
            data = whole[name][off:off + ln]
            if len(data) != ln:
                raise ValueError(f"ocdbt: {ln} bytes wanted at offset {off} "
                                 f"of {name}, {len(data)} there")
            out.append(data)
        return out


def read_store(path: str) -> Dict[bytes, bytes]:
    """Every key and value of the store in directory ``path``."""
    store = Store(path)
    keys = store.keys()
    return dict(zip(keys, store.read_many(keys)))


def write_store(path: str, items: Dict[bytes, bytes]) -> None:
    """A new store in directory ``path`` holding ``items``: values over
    ``MAX_INLINE_VALUE_BYTES`` in one data file, one B+tree leaf after
    them in the same file, and a manifest with one version.  Files are
    uncompressed."""
    keys = sorted(items)
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    rel = f"d/{uuid.uuid4().hex}"
    values, inline, kinds, offs = [], [], [], []
    at = 0
    for k in keys:
        v = bytes(items[k])
        if len(v) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            offs.append(at)
            values.append(v)
            at += len(v)
        else:
            kinds.append(0)
            inline.append(v)
    shared = []
    for a, b in zip(keys, keys[1:]):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        shared.append(n)
    body = b"".join(
        [bytes([0]), _write_files([rel]), _varint(len(keys))]
        + [_varint(n) for n in shared]
        + [_varint(len(k) - n) for k, n in zip(keys, [0] + shared)]
        + [k[n:] for k, n in zip(keys, [0] + shared)]
        + [_varint(len(items[k])) for k in keys]
        + [bytes(kinds)] + [_varint(0) for _ in offs]
        + [_varint(o) for o in offs] + inline)
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"ocdbt: {len(keys)} keys make a leaf of "
                         f"{len(body)} bytes, over one node's "
                         f"{MAX_DECODED_NODE_BYTES}")
    node = _frame(body, NODE_MAGIC)
    with open(os.path.join(path, rel), "wb") as f:
        f.writelines(values)
        f.write(node)
    manifest = b"".join([
        uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
        _varint(1), bytes(4),                          # zstd, level 0
        _write_files([rel]), _varint(1),               # one version
        _varint(1), bytes([0]), _varint(0), _varint(at), _varint(len(node)),
        _varint(len(keys)), _varint(len(node)), _varint(at),
        time.time_ns().to_bytes(8, "little"), _varint(0)])
    with open(os.path.join(path, MANIFEST), "wb") as f:
        f.write(_frame(manifest, MANIFEST_MAGIC))
