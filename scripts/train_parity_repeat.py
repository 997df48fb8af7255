"""chip_smoke.py's train phase, repeated on one dataset.

    python3 scripts/train_parity_repeat.py [--repeats 3] [--device cuda]

Runs chip_smoke's dataset phase once (its synthetic clips and the files
it writes), then its train phase ``repeats`` times on those files: each a
one-epoch cli/train run at the shipped config, the one-step parity check
of the trained weights on the card against the CPU and float64, and
characterize --gen-ckpt.  A training epoch on the card is not
bit-reproducible, so each repeat holds the gradient gate at other trained
weights.

Prints one JSON line per repeat (the gradient gate's median ratio, its
worst tensor by the ratio to the farthest CPU float32 run and by the
ratio to the CPU's own run alone, how many tensors float64 alone decides
and float32 misses, the least norm spread, the phase's seconds and the
failure, if any) and writes them to chiprun_out/train_parity_repeat.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROW_KEYS = ("tensor", "f64_ratio", "f64_ratio_to_cpu", "f64_cpu",
            "f64_cpu_jittered", "decided")


def summary(k, result, failure, seconds, dev):
    line = {"repeat": k, "phase_s": seconds, "failure": failure}
    if result is not None:
        parity = result["parity"]
        grads = parity["gradients"]
        line.update({
            "f64_ratio_median": grads["f64_ratio_median"],
            "worst_f64_ratio": {key: grads["worst_f64_ratio"].get(key)
                                for key in ROW_KEYS + ("f64_" + dev,)},
            "worst_f64_ratio_to_cpu": {
                key: grads["worst_f64_ratio_to_cpu"].get(key)
                for key in ROW_KEYS + ("f64_" + dev,)},
            "decided_in_float64_alone": len(
                parity["decided_in_float64_alone"]),
            "float32_misses": len(parity["float32_misses"]),
            "least_norm_spread": parity["least_norm_spread"],
            "steps_per_s": result["steps_per_s"]})
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "train_parity_repeat.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = cs.GeneratorConfig()
    lines = []
    with tempfile.TemporaryDirectory() as root:
        cs.dataset_phase(cfg, dev, root)
        for k in range(args.repeats):
            rep = os.path.join(root, f"repeat_{k}")
            os.makedirs(rep)
            for sub in ("data", "bvh"):
                os.symlink(os.path.join(root, sub), os.path.join(rep, sub))
            t0 = time.perf_counter()
            result, failure = None, None
            try:
                result, _ = cs.train_phase(cfg, dev, rep)
            except RuntimeError as e:
                failure = str(e)[:2000]
            lines.append(summary(k, result, failure,
                                 time.perf_counter() - t0, dev.type))
            print(json.dumps(lines[-1]), flush=True)
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"repeats": lines, "card": card}, f, indent=1)
    print(card)
    return 1 if any(line["failure"] for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
