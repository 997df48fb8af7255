"""What bounds the attention kernel: variants of it, timed side by side.

    python3 scripts/attention_ablation.py

Copies ``mocha_sigasia2023_torch/ops/csrc`` into the git-ignored
``mocha_sigasia2023_torch/_build/ablation/``, applies one textual patch per
variant, builds every variant with ``nvcc`` at once, and times each at the
main-path shapes on one GPU with ``chip_smoke.time_ms``, in the order
v1..vn, vn..v1 twice (the median of the 4 timings).  Also checks each
variant with logits near +-40 against float64.  The variants:

  library       the kernel as committed
  cvt_rna       TF32 rounding by cvt.rna.tf32.f32 instead of integer ops
  no_chunk_sum  logits accumulated in one fp32 chain, not per 32 columns
  copies_only   the TMA ring, softmax and stores, no products
  products_only the products on whatever shared memory holds, no copies

The last two give wrong outputs by design; only their times mean
anything.  A patch that no longer applies to the source stops the script.
Prints one JSON line with every timing and error.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocha_sigasia2023_torch.ops import attention, build  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "ablation")

# variant -> [(file, old text, new text)]
PATCHES = {
    "library": [],
    "cvt_rna": [("ptx.cuh",
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n"
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 "  return r;")],
    "no_chunk_sum": [
        ("attention.cu", "ptx::mma_tf32x3(part[jj], ab, as, bb, bs);",
         "ptx::mma_tf32x3(acc[j0 + jj], ab, as, bb, bs);"),
        ("attention.cu", "acc[j0 + jj][e] += part[jj][e];", "(void)part;")],
    "copies_only": [
        ("attention.cu", "    qk_chunk<KT>(st, warp * 16, g, t, s_acc);", ""),
        ("attention.cu", "    float out[kTiles][4];\n"
                         "    pv_chunk<KT>(st, g, t, s_acc, out);",
         "    float out[kTiles][4] = {};")],
    "products_only": [
        ("attention.cu", "    for (int i = 0; i < kStages; ++i) produce(i);",
         "    ;"),
        ("attention.cu", "    ptx::mbar_wait(&full[s], (i / kStages) & 1);",
         ""),
        ("attention.cu", "    if (tid == 0 && i + kStages < loads) "
                         "produce(i + kStages);", "")],
}


def build_variants(patches=PATCHES, out=OUT, dtypes=(torch.float32,)):
    """{(variant, dtype): C entry}: a patched copy of the sources for each
    variant, and one ``nvcc`` for each (variant, kernel source), all
    started before any is waited on."""
    procs = {}
    for name, edits in patches.items():
        src = os.path.join(out, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"{name}: patch no longer applies to "
                                   f"{fname}: {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for dtype in dtypes:
            source, entry, _ = attention.KERNELS[dtype]
            lib = os.path.join(src, f"lib{source[:-3]}.so")
            procs[name, dtype] = (lib, entry, subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                 os.path.join(src, source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, entry, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(lib), entry)
        library = attention.load_library(key[1])
        fn.argtypes, fn.restype = library.argtypes, library.restype
        fns[key] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device is available",
              file=sys.stderr)
        return 1
    fns = {name: fn for (name, _), fn in build_variants().items()}
    dev = torch.device("cuda")
    names = list(fns)
    order = names + names[::-1] + names + names[::-1]
    result = {"card": cs.card_line(), "ms": {}, "large_logit_err": {}}
    for shape, b, h, n, m, d in cs.ATTN_SHAPES:
        q, k, v = cs.head_views(np.random.RandomState(0), b, h, n, m, d, dev)
        times = {name: [] for name in names}
        for name in order:
            attention.load_library = (lambda f: lambda *_: f)(fns[name])
            times[name].append(cs.time_ms(lambda: attention.fused_attention(
                q, k, v, scale=d ** -0.5))[0])
        result["ms"][shape] = {name: float(np.median(t))
                               for name, t in times.items()}
        cs.log(f"[ablation] {shape}: " + ", ".join(
            f"{name} {result['ms'][shape][name]:.4f} ms" for name in names))
    b, h = cs.LARGE_LOGIT_HEADS
    _, _, _, n, m, d = cs.ATTN_SHAPES[1]
    q, k, v = cs.head_views(np.random.RandomState(1), b, h, n, m, d, dev)
    q = q * cs.LARGE_LOGIT_Q_SCALE
    logits = torch.einsum("bhnd,bhmd->bhnm", q.double(), k.double())
    exact = torch.softmax(logits * d ** -0.5, -1) @ v.double()
    for name in names:
        attention.load_library = (lambda f: lambda *_: f)(fns[name])
        out = attention.fused_attention(q, k, v, scale=d ** -0.5)
        result["large_logit_err"][name] = float((out - exact).abs().max())
    cs.log(f"[ablation] large logits, max abs vs float64: "
           f"{json.dumps(result['large_logit_err'])}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
