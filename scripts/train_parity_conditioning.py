"""The train phase's one-step parity check at steps that float32 cannot
resolve.

    python3 scripts/train_parity_conditioning.py [--gains 1,1e-3,1e-5]
        [--clips 6] [--frames 600] [--device cuda]

Makes ``clips`` synthetic clips of ``frames`` frames and their dataset as
chip_smoke.py's dataset phase does, and a seeded GeneratorTrainer at the
shipped config (full widths).  For each gain g it writes a checkpoint in
which one channel of the last decoder layer's AdaIN applies the gain
1 + gamma = g and the shift beta = 1 to every sample (those channels' fc2
weight rows zeroed, their biases g - 1 and 1), and runs
chip_smoke.train_parity on it: one step at batch 8 on the card and on the
CPU, in float32 and in float64, and the CPU's float32 runs from
jittered weights.  The AdaIN's output in that channel is
then 1 plus g times the normalized input, and float32 keeps about g of
its spread (trained weights reach such gains: beta of order 1, gamma
from -1.4 to 1.4 after an epoch, scripts/train_grad_probe.py): the last
decoder layer's query path, the AdaIN's fc1 and fc2 and the encoder
above the style carry float32 rounding amplified by about 1 / g, on
every device.

Prints one JSON line per gain (the float32 card-to-CPU comparison's
worst tensor and how many tensors miss its bar, the tensors that float64
alone decides, the float64 comparison's worst tensor, the least token
spread at a mean_variance_norm input, and the failures) and writes every
gap to chiprun_out/train_parity_conditioning.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CHANNEL = 0    # the AdaIN channel whose gain and shift are set
BETA = 1.0


def set_gain(trainer, gain):
    """The last decoder layer's AdaIN applies ``gain`` and BETA to
    CHANNEL: gamma is fc2's first half of outputs, beta its second."""
    fc2 = trainer.gen.decoder["layers"][-1]["adain"]["fc2"]
    beta = fc2.out_features // 2 + CHANNEL
    with torch.no_grad():
        fc2.weight[[CHANNEL, beta]] = 0.0
        fc2.bias[CHANNEL] = gain - 1.0
        fc2.bias[beta] = BETA


def summary(gain, gaps, failures):
    grads = gaps["gradients"]
    return {
        "gain": gain,
        "float32_worst": {k: grads["worst_of_bar"][k] for k in (
            "tensor", "of_bar", "cpu_f64_of_bar", "jittered_f64_of_bar",
            "decided")},
        "float32_misses": gaps["float32_misses"],
        "decided_in_float64_alone": gaps["decided_in_float64_alone"],
        "float64_worst": {k: grads["worst_f64_of_bar"][k] for k in (
            "tensor", "f64_of_bar")},
        "f64_ratio_median": grads["f64_ratio_median"],
        "worst_f64_ratio": {k: grads["worst_f64_ratio"][k] for k in (
            "tensor", "f64_ratio", "f64_ratio_to_cpu", "decided")},
        "worst_f64_ratio_to_cpu": {k: grads["worst_f64_ratio_to_cpu"][k]
                                   for k in ("tensor", "f64_ratio",
                                             "f64_ratio_to_cpu")},
        "least_norm_spread": gaps["least_norm_spread"],
        "failures": failures}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gains", default="1,1e-3,1e-5")
    ap.add_argument("--clips", type=int, default=6)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=cs.characterize.DEFAULT_CONFIG)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "train_parity_conditioning.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    config = cs.get_config(args.config)
    seed = int(config.get("manualSeed", 1777))
    rows, lines = {}, []
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "bvh"))
        for i, name in enumerate(cs.dataset_names(args.clips)):
            cs.bvh.save(os.path.join(root, "bvh", name + ".bvh"),
                        cs.make_mocha_bvh_data(
                            T=args.frames, seed=3000 + i,
                            walk_speed=(150.0 if name.startswith("Run")
                                        else 60.0) + 2.0 * (i % 10)))
        data = os.path.join(root, "data")
        cs.quiet(cs.generate_database.main,
                 ["--bvh-dir", os.path.join(root, "bvh"), "--out", data,
                  "--device", "cpu"])
        ds = cs.MotionDataset(data, device=dev)
        for gain in (float(g) for g in args.gains.split(",")):
            trainer = cs.GeneratorTrainer(dict(config, dropout=False), 1,
                                          seed=seed, device="cpu")
            set_gain(trainer, gain)
            model_dir = os.path.join(root, f"gain_{gain:g}")
            os.makedirs(model_dir)
            path = trainer.save(model_dir, 1)
            gaps, failures = cs.train_parity(config, path, ds, dev, seed)
            rows[f"{gain:g}"] = {"gaps": gaps, "failures": failures}
            lines.append(summary(gain, gaps, failures))
            print(json.dumps(lines[-1]), flush=True)
    rows["card"] = cs.card_line() if dev.type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(rows["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
