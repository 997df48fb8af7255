"""The CUDA build's cache key: a library is named by the hash of its source,
every local header the source includes, and the compiler flags, so an
edited header rebuilds instead of loading a stale library.  Nothing here
needs nvcc."""

import importlib.util
import os
import re

import pytest

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


@pytest.mark.parametrize("source", ["attention.cu", "attention_bf16.cu"])
def test_attention_source_hashes_its_header(source):
    files = build.local_files(source)
    assert [os.path.basename(f) for f in files] == [source, "ptx.cuh",
                                                    "tma.cuh"]


@pytest.mark.parametrize("source", ["attention.cu", "attention_bf16.cu"])
def test_attention_releases_stages_behind_a_proxy_fence(source):
    """Consumers hand a ring stage back only through mbar_release_stage,
    which fences their shared-memory reads against the producer's next TMA
    write: a bare arrive on an "empty" barrier let that write overtake an
    earlier bf16 kernel's ldmatrix reads on an H100.  Every arrive on an
    "empty" barrier in the source is a release; the source has no arrive
    of its own."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        text = f.read()
    arrivals = [name for name in re.findall(r"ptx::(\w+)\(&empty\[", text)
                if name not in ("mbar_init", "mbar_wait")]
    assert arrivals and set(arrivals) == {"mbar_release_stage"}
    assert "mbarrier.arrive" not in text
    with open(os.path.join(build.CSRC_DIR, "ptx.cuh")) as f:
        ptx = f.read()
    body = ptx[ptx.index("void mbar_release_stage"):]
    body = body[:body.index("\n}\n")]
    assert body.index("fence.proxy.async.shared::cta") < body.index(
        "mbar_arrive(bar)")


def test_build_all_starts_one_compile_per_source(tmp_path, monkeypatch):
    """build_all launches every missing library's nvcc before waiting on
    any, and skips a library that exists."""
    src = _csrc(tmp_path, monkeypatch)
    _write(src / "two.cu", "int g() { return 2; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    started, waited = [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            started.append(os.path.basename(cmd[-1]))

        def communicate(self):
            waited.append(len(started))
            with open(self.out, "w") as f:
                f.write("lib")
            return "ptxas info", None

        def poll(self):
            return 0

    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    paths = build.build_all(["kern.cu", "two.cu"])
    assert started == ["kern.cu", "two.cu"] and waited == [2, 2]
    assert all(os.path.isfile(p) for p in paths.values())
    assert build.BUILD_INFO["two.cu"]["log"] == "ptxas info"
    assert build.build_all(["two.cu"]) == {"two.cu": paths["two.cu"]}
    assert started == ["kern.cu", "two.cu"]   # cached: no second compile


def test_stress_patches_apply_to_the_kernels():
    """scripts/attention_stress.py patches the shared header; each patch
    still finds its text, so its "unfenced" variant is the committed
    kernel without the proxy fence."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "attention_stress.py")
    spec = importlib.util.spec_from_file_location("attention_stress", path)
    stress = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stress)
    assert set(stress.PATCHES) == {"committed", "unfenced"}
    for variant, patches in stress.PATCHES.items():
        for fname, old, new in patches:
            with open(os.path.join(build.CSRC_DIR, fname)) as f:
                text = f.read()
            assert text.count(old) == 1, (variant, fname, old)
            assert "fence.proxy.async" not in text.replace(old, new)


def test_ablation_patches_apply_to_the_kernel():
    """scripts/attention_ablation.py patches the kernels' source text; each
    patch of either kernel still finds its text, so the script measures
    these kernels."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "attention_ablation.py")
    spec = importlib.util.spec_from_file_location("attention_ablation", path)
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    assert list(ablation.VARIANTS.values()) == [ablation.PATCHES,
                                                ablation.PATCHES_BF16]
    for variants in ablation.VARIANTS.values():
        for variant, patches in variants.items():
            for fname, old, _ in patches:
                with open(os.path.join(build.CSRC_DIR, fname)) as f:
                    assert old in f.read(), (variant, fname, old)
