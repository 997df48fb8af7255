"""Hold the attention kernels to their plain versions on many launches.

    python3 scripts/attention_stress.py [--reps 1000]

One check can pass where a race inside a kernel fails a later launch.
This script copies ``mocha_sigasia2023_torch/ops/csrc`` into the
git-ignored ``mocha_sigasia2023_torch/_build/stress/`` once per variant,
applies the variant's textual patch, builds both sources of every variant
with ``nvcc`` at once, and then, for each dtype and variant on one GPU,
launches the kernel ``--reps`` times at each main-path shape
(``chip_smoke.ATTN_SHAPES``) and at two edge shapes, holding every output
to the plain version at chip_smoke's tolerance.  It does so once shape by
shape and once round robin over the shapes, with a short spinning kernel
before each round, and times each shape with ``chip_smoke.time_ms``.  The
variants of the tuned kernels:

  committed   the sources as committed
  unfenced    ring stages released by a bare mbarrier arrive, without the
              proxy fence of ``ptx::mbar_release_stage``

Then the general kernel (``attention_general.cu``, as committed: its ring
of cp.async buffers could race) the same way in both dtypes, at its timed
shapes (``chip_smoke.GENERAL_SHAPES``) and its check cases
(``chip_smoke.general_cases``).

A patch that no longer applies to the source stops the script.  Prints
one JSON line with the count of launches outside the tolerance and the
time per call of every (dtype, variant, shape).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocha_sigasia2023_torch.ops import attention, build  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "scripts"))
from attention_ablation import build_variants, dtype_name  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "stress")

# variant -> [(file, old text, new text)]
PATCHES = {
    "committed": [],
    "unfenced": [("ptx.cuh",
                  '  asm volatile("fence.proxy.async.shared::cta;" ::: '
                  '"memory");\n  mbar_arrive(bar);',
                  "  mbar_arrive(bar);")],
}
EDGE_SHAPES = [("edge N=17,M=45,d=64", 2, 3, 17, 45, 64),
               ("edge N=200,M=128,d=64", 2, 3, 200, 128, 64)]


def outside(q, k, v, scale, ref, limit):
    """1 if one launch's output leaves the tolerance, else 0."""
    out = attention.fused_attention(q, k, v, scale=scale).float()
    return int(bool(((out - ref).abs() > limit).any()))


def tuned_cases(dtype, dev):
    """(name, q, k, v) at the tuned kernels' main-path and edge shapes."""
    return [(name, *cs.head_views(np.random.RandomState(i), b, h, n, m, d,
                                  dev, dtype))
            for i, (name, b, h, n, m, d) in enumerate(cs.ATTN_SHAPES
                                                      + EDGE_SHAPES)]


def general_cases(dtype, dev):
    """(name, q, k, v) of the general kernel: its timed shapes and
    chip_smoke's check cases."""
    rng = np.random.RandomState(2)
    return ([(name, *cs.head_views(rng, b, h, n, m, d, dev, dtype))
             for name, b, h, n, m, d in cs.GENERAL_SHAPES]
            + cs.general_cases(rng, dev, dtype))


def stress(named, reps):
    """{shape: {"outside_alone", "outside_round_robin", "launches", "ms"}}
    for the (name, q, k, v) cases, through ``fused_attention``."""
    cases = []
    for name, q, k, v in named:
        atol, rtol = cs.KERNEL_DTYPES[q.dtype][0]
        scale = q.shape[-1] ** -0.5
        ref = attention.attention_reference(q, k, v, scale).float()
        cases.append((name, q, k, v, scale, ref, atol + rtol * ref.abs()))
    result = {}
    for name, q, k, v, scale, ref, limit in cases:
        bad = sum(outside(q, k, v, scale, ref, limit) for _ in range(reps))
        ms, _ = cs.time_ms(lambda: attention.fused_attention(
            q, k, v, scale=scale))
        result[name] = {"outside_alone": bad, "launches": reps, "ms": ms}
    rounds = {name: 0 for name, *_ in cases}
    for _ in range(reps):
        torch.cuda._sleep(200_000)
        for name, q, k, v, scale, ref, limit in cases:
            rounds[name] += outside(q, k, v, scale, ref, limit)
    for name, bad in rounds.items():
        result[name]["outside_round_robin"] = bad
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=1000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_stress: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fns = build_variants(PATCHES, OUT, tuple(attention.KERNELS))
    result = {"card": cs.card_line(), "reps": args.reps, "results": {}}
    load_library = attention.load_library
    runs = [(f"{dtype_name(dtype)} {variant}",
             (lambda f: lambda *_: f)(fn), tuned_cases(dtype, dev))
            for (variant, dtype), fn in fns.items()]
    runs += [(f"general {dtype_name(dtype)} committed", load_library,
              general_cases(dtype, dev))
             for dtype in (torch.float32, torch.bfloat16)]
    for key, library, named in runs:
        attention.load_library = library
        res = stress(named, args.reps)
        result["results"][key] = res
        for name, r in res.items():
            cs.log(f"[stress] {key} {name}: {r['outside_alone']} + "
                   f"{r['outside_round_robin']} of 2 x {r['launches']} "
                   f"launches outside the tolerance; {r['ms']:.4f} ms")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
