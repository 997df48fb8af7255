"""The CUDA build's cache key: a library is named by the hash of its source,
every local header the source includes, and the compiler flags, so an
edited header rebuilds instead of loading a stale library.  Nothing here
needs nvcc."""

import importlib.util
import os

from mocha_sigasia2023_torch.ops import build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    (src / "sub").mkdir(parents=True)
    _write(src / "kern.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n'
           "int f() { return A; }\n")
    _write(src / "a.cuh", '#pragma once\n#  include "sub/b.cuh"\n'
           "#define A B\n")
    _write(src / "sub" / "b.cuh", "#define B 1\n")
    _write(src / "other.cuh", "#define C 1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(src))
    return src


def test_local_files_follow_includes(tmp_path, monkeypatch):
    src = _csrc(tmp_path, monkeypatch)
    assert build.local_files("kern.cu") == [
        str(src / "kern.cu"), str(src / "a.cuh"), str(src / "sub" / "b.cuh")]


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    src = _csrc(tmp_path, monkeypatch)
    first = build.library_path("kern.cu")
    assert build.library_path("kern.cu") == first
    _write(src / "other.cuh", "#define C 2\n")   # not included
    assert build.library_path("kern.cu") == first
    _write(src / "sub" / "b.cuh", "#define B 2\n")   # included by a.cuh
    second = build.library_path("kern.cu")
    assert second != first
    _write(src / "a.cuh", '#pragma once\n#include "sub/b.cuh"\n#define A 3\n')
    assert build.library_path("kern.cu") not in (first, second)
    assert os.path.dirname(second) == build.BUILD_DIR


def test_attention_source_hashes_its_header():
    files = build.local_files("attention.cu")
    assert [os.path.basename(f) for f in files] == ["attention.cu", "ptx.cuh"]


def test_ablation_patches_apply_to_the_kernel():
    """scripts/attention_ablation.py patches the kernel's source text; each
    patch still finds its text, so the script measures this kernel."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "attention_ablation.py")
    spec = importlib.util.spec_from_file_location("attention_ablation", path)
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    for variant, patches in ablation.PATCHES.items():
        for fname, old, _ in patches:
            with open(os.path.join(build.CSRC_DIR, fname)) as f:
                assert old in f.read(), (variant, fname, old)
