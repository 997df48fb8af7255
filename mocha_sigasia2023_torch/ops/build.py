"""Build the CUDA sources under ``ops/csrc`` at first use.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``; ``build_all``
runs one ``nvcc`` per source at once.  Libraries land
in ``mocha_sigasia2023_torch/_build/`` (git-ignored), named by the hash of
the source and of every local header it includes, so an edited source or
header rebuilds and an unchanged one loads.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# per-source record of the last build in this process: seconds, log, path
BUILD_INFO: Dict[str, Dict] = {}


def find_nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand.append(os.path.join(root, "bin", "nvcc"))
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_files(source: str):
    """``csrc/<source>`` and the local headers it includes (``#include
    "..."``, followed through headers), in the order first reached."""
    seen, todo = [], [os.path.join(CSRC_DIR, source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        todo += [os.path.normpath(os.path.join(os.path.dirname(path),
                                               name.decode()))
                 for name in _LOCAL_INCLUDE.findall(text)]
    return seen


def library_path(source: str) -> str:
    """Where the library for ``csrc/<source>`` goes, keyed by the hash of
    the source, its local headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in local_files(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build_all(sources) -> Dict[str, str]:
    """Compile each ``csrc/<source>`` that has no library yet, one ``nvcc``
    per source, all started together; return {source: library path}.  A
    failed compile raises with the compiler's output."""
    paths, jobs = {}, {}
    for source in sources:
        out = paths[source] = library_path(source)
        if os.path.isfile(out):
            BUILD_INFO.setdefault(source, {"seconds": 0.0, "log": "(cached)",
                                           "path": out})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        jobs[source] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        for source, (cmd, tmp, t0, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, paths[source])
            BUILD_INFO[source] = {"seconds": time.perf_counter() - t0,
                                  "log": log.strip(), "path": paths[source]}
    finally:
        for cmd, tmp, t0, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return the
    library's path."""
    return build_all([source])[source]


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(source))
