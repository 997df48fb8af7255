"""orbax checkpoint directories (``StandardCheckpointer``, zarr v2 on
OCDBT), read and written without orbax, tensorstore or zstandard.

A directory that the JAX package's ``save_checkpoint_orbax`` writes
(mocha_sigasia2023_tpu/train/checkpoint.py:75-82) holds:

- ``_METADATA``: JSON; ``tree_metadata`` lists every leaf by its key path
  (``key_metadata``: each key with its ``key_type``, 1 a sequence index,
  2 a mapping key) and its ``value_type``;
- ``_CHECKPOINT_METADATA``: JSON naming the handler;
- an OCDBT store (``io/ocdbt.py``) in which each leaf is a zarr v2 array
  under its keys joined by ``.``: ``<name>/.zarray`` (JSON: shape, chunks,
  dtype, order, fill value, compressor) and one value a chunk,
  ``<name>/0.0``-style keys, each chunk a zstd frame (``io/zstd.py``).

Readable: zarr v2 arrays of the dtypes NumPy holds and ``bfloat16``, C or
F order, compressor ``zstd`` or none, any chunking (a missing chunk takes
the fill value, edge chunks are cropped), 0-d arrays; empty containers
and ``None`` leaves.  Refused with ``ValueError``: zarr v3
(``use_zarr3``), filters, other compressors (blosc, zlib, ...), zstd
dictionaries, string leaves.

The tree comes back as ``io/msgpack.py`` returns a flax checkpoint:
nested dicts, maps keyed "0".."n-1" as lists, ``bfloat16`` leaves as
``torch.bfloat16`` tensors and every other leaf as a NumPy array.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import msgpack, ocdbt, zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
KEY_SEQUENCE, KEY_MAPPING = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array")
EMPTY_TYPES = {"Dict": dict, "List": list, "Tuple": tuple,
               "None": lambda: None}


def _fail(what: str, where: str):
    raise ValueError(f"orbax: {what} in {where}")


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------


def parse_zarray(text: bytes, name: str) -> Dict[str, Any]:
    """A ``.zarray`` document, checked: shape, chunks, dtype ("bfloat16"
    kept as that name), order, fill value, compressor and separator."""
    try:
        meta = json.loads(text)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        _fail(f"unreadable JSON ({e})", name)
    if meta.get("zarr_format") != 2:
        _fail(f"zarr_format {meta.get('zarr_format')!r}", name)
    if meta.get("filters"):
        _fail(f"filters {meta['filters']!r}", name)
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        _fail(f"compressor {comp.get('id')!r} (only zstd or none)", name)
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        _fail(f"chunks {chunks} for shape {shape}", name)
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        _fail(f"order {order!r}", name)
    name_ = meta["dtype"]
    if not isinstance(name_, str):
        _fail(f"structured dtype {name_!r}", name)
    if name_ == "bfloat16":
        dtype = np.dtype("<u2")
    else:
        try:
            dtype = np.dtype(name_)
        except TypeError:
            _fail(f"dtype {name_!r}", name)
    return {"shape": shape, "chunks": chunks, "dtype": dtype,
            "bfloat16": name_ == "bfloat16", "order": order,
            "fill_value": meta.get("fill_value"),
            "compressed": comp is not None,
            "separator": meta.get("dimension_separator", ".")}


def _fill(meta) -> Any:
    """The fill value as the array's dtype takes it (null: 0)."""
    value = meta["fill_value"]
    if value is None:
        return 0
    if meta["bfloat16"]:
        return np.frombuffer(torch.tensor([float(value)], dtype=torch.bfloat16)
                             .view(torch.uint16).numpy().tobytes(), "<u2")[0]
    if isinstance(value, str) and meta["dtype"].kind in "fc":
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def chunk_keys(meta) -> List[Tuple[Tuple[int, ...], str]]:
    """Every chunk's grid index and key ("0" for a 0-d array)."""
    grid = [math.ceil(s / c) for s, c in zip(meta["shape"], meta["chunks"])]
    if not grid:
        return [((), "0")]
    sep = meta["separator"]
    return [(idx, sep.join(map(str, idx))) for idx in np.ndindex(*grid)]


def assemble(meta, chunks: Dict[Tuple[int, ...], bytes], name: str):
    """The array from its decoded chunks (grid index -> bytes); absent
    chunks take the fill value, edge chunks are cropped."""
    shape, cshape, dtype = meta["shape"], meta["chunks"], meta["dtype"]
    out = np.full(shape, _fill(meta), dtype)
    want = int(np.prod(cshape, dtype=np.int64)) * dtype.itemsize
    for idx, data in chunks.items():
        if len(data) != want:
            _fail(f"chunk {idx} of {len(data)} bytes, {want} expected", name)
        block = np.frombuffer(data, dtype).reshape(cshape, order=meta["order"])
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, cshape, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta["bfloat16"]:
        return torch.from_numpy(out.astype("<u2")).view(torch.bfloat16)
    return out


def _zarray(arr) -> Tuple[Dict[str, Any], bytes]:
    """A leaf as one zarr chunk: (.zarray document, chunk bytes)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, data = "bfloat16", t.view(torch.uint16).numpy().astype("<u2")
        else:
            data = t.numpy()
            name = data.dtype.str
    else:
        data = np.asarray(arr)
        name = data.dtype.str
    if data.dtype.byteorder == ">":
        data = data.astype(data.dtype.newbyteorder("<"))
        name = data.dtype.str
    shape = list(data.shape)
    meta = {"chunks": [max(s, 1) for s in shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": name, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    return meta, data.tobytes(order="C")


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def _insert(tree: dict, path, value):
    node = tree
    for key, _ in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1][0]] = value


def read_tree(path: str) -> Any:
    """The checkpoint directory ``path`` as nested dicts and lists of
    arrays."""
    meta_path = os.path.join(path, METADATA)
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        _fail("zarr v3 arrays (use_zarr3)", meta_path)
    store = ocdbt.Store(path)
    leaves, arrays = [], []
    for entry, info in meta["tree_metadata"].items():
        keys = info["key_metadata"]
        if not keys:
            _fail(f"a leaf with no key path ({entry})", meta_path)
        kpath = [(str(k["key"]), k["key_type"]) for k in keys]
        for k in keys:
            if k["key_type"] not in (KEY_SEQUENCE, KEY_MAPPING):
                _fail(f"key_type {k['key_type']} at {entry}", meta_path)
        vtype = info["value_metadata"]["value_type"]
        if vtype in EMPTY_TYPES:
            leaves.append((kpath, EMPTY_TYPES[vtype]()))
        elif vtype in ARRAY_TYPES:
            arrays.append((kpath, ".".join(k for k, _ in kpath)))
        else:
            _fail(f"a leaf of type {vtype!r} at {entry}", meta_path)
    docs = store.read_many(f"{name}/.zarray".encode() for _, name in arrays)
    plans = []
    for (kpath, name), doc in zip(arrays, docs):
        zmeta = parse_zarray(doc, f"{path}:{name}")
        present = [(idx, f"{name}/{key}".encode())
                   for idx, key in chunk_keys(zmeta)]
        present = [(idx, key) for idx, key in present if key in store]
        plans.append((kpath, name, zmeta, present))
    raw = store.read_many(key for plan in plans for _, key in plan[3])
    packed = [(p, i) for p, plan in enumerate(plans)
              for i in range(len(plan[3])) if plan[2]["compressed"]]
    it = iter(raw)
    chunks = [[next(it) for _ in plan[3]] for plan in plans]
    decoded = zstd.decompress_many([chunks[p][i] for p, i in packed])
    for (p, i), data in zip(packed, decoded):
        chunks[p][i] = data
    for (kpath, name, zmeta, present), datas in zip(plans, chunks):
        arr = assemble(zmeta, {idx: d for (idx, _), d in zip(present, datas)},
                       f"{path}:{name}")
        leaves.append((kpath, arr))
    tree: dict = {}
    for kpath, value in leaves:
        _insert(tree, kpath, value)
    # key_type 1 entries are index maps too
    return msgpack.listify(tree)


def _flatten(tree, prefix=()):
    """(key path, leaf) pairs as flax's state dict gives them to orbax:
    NamedTuples keyed by their fields, lists and tuples by their indices
    as strings."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, dict):
        if not tree:
            return [(prefix, {})]
        out = []
        for k, v in tree.items():
            out += _flatten(v, prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        return _flatten({str(i): v for i, v in enumerate(tree)}, prefix)
    return [(prefix, tree)]


def write_tree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of NumPy arrays,
    torch tensors and numbers) as orbax 0.11.32's ``StandardCheckpointer``
    lays it out, into the new directory ``path``."""
    items: Dict[bytes, bytes] = {}
    tree_metadata = {}
    for kpath, leaf in _flatten(tree):
        if not kpath:
            raise ValueError("orbax: the tree is a bare leaf, not a mapping")
        value = {"value_type": "np.ndarray", "skip_deserialize": False}
        if isinstance(leaf, dict):
            value = {"value_type": "Dict", "skip_deserialize": True}
        elif leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            name = ".".join(kpath)
            zmeta, data = _zarray(leaf)
            key = ".".join(["0"] * len(zmeta["shape"])) or "0"
            items[f"{name}/.zarray".encode()] = json.dumps(
                zmeta, sort_keys=True, separators=(",", ":")).encode()
            if data:
                items[f"{name}/{key}".encode()] = zstd.compress(data)
        tree_metadata[str(kpath)] = {
            "key_metadata": [{"key": k, "key_type": KEY_MAPPING}
                             for k in kpath],
            "value_metadata": value}
    os.makedirs(path)
    ocdbt.write_store(path, items)
    with open(os.path.join(path, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(path, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
