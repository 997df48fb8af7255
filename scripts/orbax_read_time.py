"""Time the port's reader on an orbax checkpoint directory.

    python3 scripts/orbax_read_time.py DIR [--repeats 3]

Reads DIR (for example one that ``scripts/make_orbax_fixture.py
--full-width DIR`` wrote with the JAX package) with
``train.checkpoint.load_checkpoint_orbax`` ``--repeats`` times and prints
one JSON line: the host's CPU model, the leaves, their bytes, the bytes on
disk, each read's seconds and the seconds each spent in the zstd
decoder's Huffman stage.  Imports nothing of JAX or orbax.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mocha_sigasia2023_torch.io import zstd  # noqa: E402
from mocha_sigasia2023_torch.train import checkpoint  # noqa: E402


def cpu_model() -> str:
    """The first CPU's model name, vendor, family and model from
    /proc/cpuinfo (a host may hide the name), and the architecture."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{fields.get('model name', '?')} ({fields.get('vendor_id', '?')}"
            f" family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {platform.machine()})")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    huffman = []
    real = zstd._Decode.run

    def timed(self):
        t0 = time.perf_counter()
        out = real(self)
        huffman.append(time.perf_counter() - t0)
        return out

    zstd._Decode.run = timed
    seconds, in_huffman = [], []
    for _ in range(args.repeats):
        huffman.clear()
        t0 = time.perf_counter()
        tree = checkpoint.load_checkpoint_orbax(args.dir)
        seconds.append(time.perf_counter() - t0)
        in_huffman.append(sum(huffman))
    zstd._Decode.run = real
    arrays = leaves(tree)
    nbytes = sum(a.numel() * a.element_size() if torch.is_tensor(a)
                 else np.asarray(a).nbytes for a in arrays)
    disk = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(args.dir) for f in files)
    print(json.dumps({"cpu": cpu_model(), "cores": os.cpu_count(),
                      "leaves": len(arrays), "mb": nbytes / 1e6,
                      "disk_mb": disk / 1e6, "read_s": seconds,
                      "huffman_s": in_huffman}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
