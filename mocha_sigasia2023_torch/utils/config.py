"""YAML config loading without PyYAML.

Counterpart of ``get_config``, ``ensure_dirs``, ``set_seed``,
``get_model_list``, ``print_composite`` and ``describe_params`` in
mocha_sigasia2023_tpu/utils/config.py.  The configs
use a small subset of
YAML, and the card's machine has no PyYAML, so this module reads that
subset itself:

- block mappings (``key: value``, nested by indentation) and block
  sequences (``- item``, also at the indentation of their parent key);
- flow sequences and mappings (``[a, b]``, ``{k: v}``), nested, spanning
  several lines, with a trailing comma allowed;
- plain, single- and double-quoted scalars, resolved as YAML 1.1 does
  (PyYAML's resolver): null (``~``, ``null``, empty), bool
  (``true``/``yes``/``on`` and their negatives), decimal int, float (a dot
  required, or ``.inf``/``.nan``), else str;
- ``#`` comments, at the start of a line or after whitespace.

Anchors, aliases, tags, block scalars (``|``, ``>``), multi-document
streams and complex keys are not read; they raise ``ConfigError``.
"""

from __future__ import annotations

import os
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
            "r": "\r"}


class ConfigError(ValueError):
    pass


def _resolve(text: str):
    """A plain scalar's value, as YAML 1.1 resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text[0] in "&*!|>%@`":
        raise ConfigError(f"unsupported YAML construct: {text!r}")
    return text


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, end)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = s[j + 1: j + 2]
            if esc not in _ESCAPES:
                raise ConfigError(f"unsupported escape \\{esc} in {s!r}")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ConfigError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (outside quotes)."""
    j = 0
    while j < len(line):
        c = line[j]
        if c in "'\"" and (j == 0 or line[j - 1] in " \t[{,:"):
            _, j = _quoted(line, j)
            continue
        if c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j].rstrip()
        j += 1
    return line.rstrip()


def _flow(s: str, i: int, closers: str):
    """Parse one flow node at ``s[i]`` (after blanks); returns (value, end).
    ``closers`` are the characters that end a plain scalar here."""
    while i < len(s) and s[i] in " \t":
        i += 1
    if i >= len(s):
        raise ConfigError(f"unexpected end of flow collection: {s!r}")
    c = s[i]
    if c == "[":
        items = []
        i += 1
        while True:
            while i < len(s) and s[i] in " \t":
                i += 1
            if i < len(s) and s[i] == "]":
                return items, i + 1
            item, i = _flow(s, i, ",]")
            items.append(item)
            while i < len(s) and s[i] in " \t":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i >= len(s) or s[i] != "]":
                raise ConfigError(f"bad flow sequence: {s!r}")
    if c == "{":
        out = {}
        i += 1
        while True:
            while i < len(s) and s[i] in " \t":
                i += 1
            if i < len(s) and s[i] == "}":
                return out, i + 1
            key, i = _flow(s, i, ":,}")
            if i >= len(s) or s[i] != ":":
                raise ConfigError(f"flow mapping entry without ':' in {s!r}")
            val, i = _flow(s, i + 1, ",}")
            out[key] = val
            while i < len(s) and s[i] in " \t":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i >= len(s) or s[i] != "}":
                raise ConfigError(f"bad flow mapping: {s!r}")
    if c in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in closers:
        j += 1
    return _resolve(s[i:j].strip()), j


def _scalar_or_flow(text: str):
    """A whole inline value: a flow collection, a quoted or a plain
    scalar."""
    if text[:1] in "[{'\"":
        val, end = _flow(text, 0, "")
        if text[end:].strip():
            raise ConfigError(f"trailing text after value: {text!r}")
        return val
    return _resolve(text)


def _split_key(text: str):
    """``key: rest`` -> (key, rest); None if the text is no mapping entry."""
    if text[:1] in "'\"":
        key, j = _quoted(text, 0)
    else:
        m = re.search(r":(\s|$)", text)
        if m is None or text[:1] in "[{":
            return None
        key, j = _resolve(text[: m.start()].strip()), m.start()
    rest = text[j:]
    if not rest.startswith(":") or (len(rest) > 1 and rest[1] not in " \t"):
        return None
    return key, rest[1:].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Lines:
    """(indent, text) of the non-blank, comment-free lines, with flow
    collections that span lines joined into one."""

    def __init__(self, source: str):
        self.rows: List[List] = []
        pending = None
        for raw in source.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ConfigError("tabs in indentation are not YAML")
            line = _strip_comment(raw)
            if pending is not None:
                pending[1] += " " + line.strip()
                if _balanced(pending[1]):
                    pending = None
                continue
            if not line.strip():
                continue
            if line.strip() in ("---", "..."):
                if self.rows:
                    raise ConfigError("multi-document YAML is not read")
                continue
            row = [len(line) - len(line.lstrip(" ")), line.strip()]
            self.rows.append(row)
            if not _balanced(row[1]):
                pending = row
        if pending is not None:
            raise ConfigError(f"unclosed flow collection: {pending[1]!r}")


def _balanced(text: str) -> bool:
    depth = 0
    j = 0
    while j < len(text):
        c = text[j]
        if c in "'\"" and (j == 0 or text[j - 1] in " \t[{,:"):
            _, j = _quoted(text, j)
            continue
        depth += (c in "[{") - (c in "]}")
        j += 1
    return depth <= 0


def _block(lines: _Lines, i: int, indent: int):
    """Parse the block node whose lines start at ``i`` with ``indent``;
    returns (value, next line)."""
    if _is_item(lines.rows[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _value_after(lines: _Lines, i: int, indent: int, rest: str,
                 seq_at_same_indent: bool):
    """The value of an entry whose inline part is ``rest``, ending at line
    ``i``; nested blocks are deeper than ``indent``."""
    if rest:
        return _scalar_or_flow(rest), i
    rows = lines.rows
    if i < len(rows) and rows[i][0] > indent:
        return _block(lines, i, rows[i][0])
    if seq_at_same_indent and i < len(rows) and rows[i][0] == indent \
            and _is_item(rows[i][1]):
        return _sequence(lines, i, indent)
    return None, i


def _mapping(lines: _Lines, i: int, indent: int):
    out: Dict = {}
    rows = lines.rows
    while i < len(rows) and rows[i][0] == indent and not _is_item(rows[i][1]):
        kv = _split_key(rows[i][1])
        if kv is None:
            raise ConfigError(f"expected 'key: value', got {rows[i][1]!r}")
        key, rest = kv
        out[key], i = _value_after(lines, i + 1, indent, rest, True)
    if i < len(rows) and rows[i][0] > indent:
        raise ConfigError(f"bad indentation at {rows[i][1]!r}")
    return out, i


def _sequence(lines: _Lines, i: int, indent: int):
    out = []
    rows = lines.rows
    while i < len(rows) and rows[i][0] == indent and _is_item(rows[i][1]):
        rest = rows[i][1][1:]
        inner = indent + 1 + len(rest) - len(rest.lstrip(" "))
        rest = rest.strip()
        if rest and (_is_item(rest) or _split_key(rest) is not None):
            # "- key: v" or "- - x": the item is a block starting in place
            rows[i] = [inner, rest]
            val, i = _block(lines, i, inner)
        else:
            val, i = _value_after(lines, i + 1, indent, rest, False)
        out.append(val)
    return out, i


def parse_yaml(source: str):
    """The value of one YAML document in the subset this module reads."""
    lines = _Lines(source)
    if not lines.rows:
        return None
    first_indent = lines.rows[0][0]
    if len(lines.rows) == 1 and _split_key(lines.rows[0][1]) is None \
            and not _is_item(lines.rows[0][1]):
        return _scalar_or_flow(lines.rows[0][1])
    val, i = _block(lines, 0, first_indent)
    if i != len(lines.rows):
        raise ConfigError(f"unparsed YAML from {lines.rows[i][1]!r}")
    return val


def get_config(path: str) -> Dict:
    with open(path, "r") as f:
        return parse_yaml(f.read())


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def ensure_dirs(paths) -> None:
    if isinstance(paths, (list, tuple)):
        for p in paths:
            ensure_dir(p)
    else:
        ensure_dir(paths)


def set_seed(seed: int = 1777) -> None:
    """Seed the host-side generators (Python, NumPy, torch's global one);
    the port's dropout and patch sampling take explicit generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def get_model_list(dirname: str, key: str) -> Optional[str]:
    """The lexicographically last checkpoint file in ``dirname`` whose name
    holds ``key`` (``.pt``, ``.msgpack`` or the port's ``.ckpt``)."""
    if not os.path.isdir(dirname):
        return None
    files = [os.path.join(dirname, f) for f in os.listdir(dirname)
             if os.path.isfile(os.path.join(dirname, f)) and key in f
             and f.endswith((".pt", ".msgpack", ".ckpt"))]
    return max(files) if files else None


def print_composite(data, beg: str = "") -> None:
    """Print the structure of nested dicts, lists and arrays or tensors:
    containers with their sizes, arrays with their shapes."""
    if isinstance(data, dict):
        print(f"{beg} dict, size = {len(data)}")
        for k, v in data.items():
            print(f"  {beg}{k}:")
            print_composite(v, beg + "    ")
    elif isinstance(data, (list, tuple)):
        print(f"{beg} list, len = {len(data)}")
        for i, item in enumerate(data):
            print(f"  {beg}item {i}")
            print_composite(item, beg + "    ")
    elif hasattr(data, "shape"):
        print(f"{beg} array of size {tuple(data.shape)}")
    else:
        print(f"{beg} {data}")


def describe_params(module: torch.nn.Module, title: str = "Generator") -> str:
    """Every parameter of ``module`` with its path, shape and size, and the
    total count, in the JAX package's ``info-network`` format: paths as JAX
    key strings (``['encoder']['layers'][0]...``), in the order JAX
    flattens its pytree (dict keys sorted, list items in order)."""
    def parts(name):
        return [int(c) if c.isdigit() else c for c in name.split(".")]

    lines, total = [title], 0
    for name, p in sorted(module.named_parameters(),
                          key=lambda kv: parts(kv[0])):
        shape = tuple(p.shape)
        n = int(np.prod(shape)) if shape else 1
        total += n
        path = "".join(f"[{c}]" if isinstance(c, int) else f"['{c}']"
                       for c in parts(name))
        lines.append(f"  {path}: {shape} [{n:,}]")
    lines.append(f"total parameters: {total:,}")
    return "\n".join(lines)
