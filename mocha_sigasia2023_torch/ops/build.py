"""Build the port's native sources at first use.

A CUDA source (``.cu``, under ``ops/csrc``) compiles on its own with
``nvcc`` for ``sm_90a``, and a host source (``.cpp``: the BVH codec,
``io/csrc/mocha_native.cpp``) with ``g++``, each into a shared library with
a plain C interface, loaded with ``ctypes``; ``build_all`` runs one
compiler per source at once.  Libraries land in
``mocha_sigasia2023_torch/_build/`` (git-ignored), written under a
temporary name and renamed into place, so processes that build at once
do not read each other's half-written files.  A library is named by the
hash of the source, of every local header it includes and of the
compiler's flags, so an edited source or header rebuilds and an unchanged
one loads.  Nothing here runs at import time.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# no -march=native: a library must not depend on the host that built it
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

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


def find_cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH; the host codec "
                           "(io/csrc/mocha_native.cpp) cannot be built")
    return path


def flags(source: str):
    """The compiler flags of ``source``: g++'s for a ``.cpp`` file, nvcc's
    otherwise."""
    return HOST_FLAGS if source.endswith(".cpp") else NVCC_FLAGS


def compile_command(source: str, out: str):
    compiler = find_cxx() if source.endswith(".cpp") else find_nvcc()
    return [compiler, *flags(source), "-o", out,
            os.path.join(CSRC_DIR, source)]


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_files(source: str):
    """``csrc/<source>`` (``source`` itself when it is an absolute path)
    and the local headers it includes (``#include
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
    digest = hashlib.sha256(" ".join(flags(source)).encode())
    for path in local_files(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def _finish(job):
    """Wait for one compiler: (its output, seconds since it started)."""
    _, _, t0, proc = job
    log = proc.communicate()[0]
    return log, time.perf_counter() - t0


def build_all(sources) -> Dict[str, str]:
    """Compile each ``csrc/<source>`` that has no library yet, one compiler
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
        cmd = compile_command(source, tmp)
        jobs[source] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        # one thread a compiler, so that each build's seconds stop when it
        # ends, not when the compilers started before it have ended
        with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
            done = list(pool.map(_finish, jobs.values()))
        for (source, (cmd, tmp, _, proc)), (log, seconds) in zip(
                jobs.items(), done):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed on {source} (exit "
                    f"{proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, paths[source])
            BUILD_INFO[source] = {"seconds": seconds, "log": log.strip(),
                                  "path": paths[source]}
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
    """Build ``source`` if needed and load its library; a library that
    does not load raises with the loader's message and its path."""
    path = build(source)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load {path} (built from {source}): "
                           f"{e}") from e
