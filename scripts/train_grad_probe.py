"""Where a training step's gradients on the card part from float64.

    python3 scripts/train_grad_probe.py [--clips 60] [--epochs 1]

Makes the data and the checkpoint as chip_smoke.py's dataset and train
phases do (``clips`` synthetic clips, cli/train for ``epochs`` epochs on
the card, the shipped config), then takes chip_smoke's parity batch (8
windows, dropout off) through one backward on the card, then on the CPU
in float32 and in float64 and on the card again, each replaying the first
run's piecewise choices (chip_smoke.PinnedChoices: the L1 signs, the
torch.where conditions, the ReLU masks), and on the CPU in float32 and
float64 at their own choices.  Each run records, with their
gradients, every generator forward's inputs and outputs, every transformer
stack's output, and every decoder AdaIN's input x, pooled style, fc1
output h, fc2 output gb, normalized input n, output y and query input.
Prints one JSON line, and writes the whole record to
chiprun_out/train_grad_probe.json:

- ``params``: every parameter's gradient, its distance to float64 on the
  card and on the CPU and their ratio (the worst first), with the choices
  pinned; ``params_own_choices``: the same, each run at its own choices;
- ``flips``: the choices each replay overrode;
- ``taps``: the same for each recorded tensor's gradient and value;
- ``reductions``: per AdaIN call, gb's gradient summed again in float64
  from the run's own y gradient and n, against the run's gb gradient (the
  run's own token sums) and against float64's (what reached y);
- ``repeat``: the largest gap between the card's two backwards;
- ``kernels``: the kernels the card's backward launched, by name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocha_sigasia2023_torch.models import generator as G  # noqa: E402
from mocha_sigasia2023_torch.models import layers as L  # noqa: E402
from mocha_sigasia2023_torch.train import trainer as T  # noqa: E402


class Recorder:
    """Taps on the training forwards, the transformer stacks and the
    decoder's AdaIN; each tap is an exact view whose gradient is kept."""

    def __init__(self):
        self.values, self.grads = {}, {}
        self.count = {"fwd": 0, "tf": 0, "adain": 0}
        self.real = (L.adain, L.attention, G.transformer, T._make_fwd)

    def next(self, kind):
        k = self.count[kind]
        self.count[kind] += 1
        return f"{kind}{k}"

    def tap(self, name, t):
        t = t.view_as(t)
        self.values[name] = t.detach().double().cpu()
        if t.requires_grad:
            t.register_hook(lambda g: self.grads.__setitem__(
                name, g.detach().double().cpu()))
        return t

    def adain(self, p, x, style):
        c = self.current = self.next("adain")
        x = self.tap(f"{c}.x", x)
        pooled = self.tap(f"{c}.pooled", style.mean(dim=1))
        h = self.tap(f"{c}.h", L.leaky_relu(L.linear(p["fc1"], pooled), 0.2))
        gb = self.tap(f"{c}.gb", L.linear(p["fc2"], h))
        fin = gb.shape[-1] // 2
        n = self.tap(f"{c}.n", L.mean_variance_norm(x))
        return self.tap(f"{c}.y",
                        (1.0 + gb[:, None, :fin]) * n + gb[:, None, fin:])

    def attention(self, p, src, tar=None, **kw):
        if kw.get("adain"):
            src = self.tap(f"{self.current}.q_src", src)
        return self.real[1](p, src, tar, **kw)

    def transformer(self, p, x, sty=None, **kw):
        name = self.next("tf") + (".decoder" if kw.get("adain_on")
                                  else ".encoder")
        return self.tap(name, self.real[2](p, x, sty, **kw))

    def make_fwd(self, *args, **kw):
        real = self.real[3](*args, **kw)

        def fwd(a, b, seed, extract=False):
            f = self.next("fwd")
            out = real(self.tap(f"{f}.a", a), self.tap(f"{f}.b", b), seed,
                       extract)
            if extract:
                return tuple(self.tap(f"{f}.out{i}", o)
                             for i, o in enumerate(out))
            return self.tap(f"{f}.out", out)
        return fwd

    def __enter__(self):
        L.adain, L.attention = self.adain, self.attention
        G.transformer, T._make_fwd = self.transformer, self.make_fwd
        return self

    def __exit__(self, *exc):
        L.adain, L.attention, G.transformer, T._make_fwd = self.real


def run(config, ckpt_path, bs, bc, norm, seed, device, dtype, choices,
        kernels=None):
    """One backward of the checkpoint's weights at ``choices`` (None: its
    own, recorded): (recorder, gradients, the PinnedChoices)."""
    t = cs.GeneratorTrainer(dict(config, dropout=False), 1, seed=seed,
                            device=device)
    t.load(ckpt_path)
    if dtype == torch.float64:
        t.gen.double()
        t.prj.double()

        def cast(tree):
            return {k: np.asarray(torch.as_tensor(v).cpu(), np.float64)
                    for k, v in tree.items()}
        bs, bc, norm = cast(bs), cast(bc), cast(norm)
    with Recorder() as rec, cs.PinnedChoices(choices) as pin:
        if kernels is None:
            t.backward(bs, bc, norm)
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t.backward(bs, bc, norm)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    kernels[e.key[:120]] = e.count
    grads = {f"{part}.{n}": p.grad.detach().double().cpu()
             for part, m in (("gen", t.gen), ("prj", t.prj))
             for n, p in m.named_parameters()}
    return rec, grads, pin


def dist(a, b):
    return float((a - b).abs().max())


def gaps(dev, cpu, ref):
    """Distance to ``ref`` on the card and on the CPU, and their ratio."""
    d, c = dist(dev, ref), dist(cpu, ref)
    eps = float(torch.finfo(torch.float32).eps)
    return {"max": float(ref.abs().max()), "device": d, "cpu": c,
            "ratio": d / (c + eps * float(ref.abs().max()) + 1e-300)}


def by_ratio(rows):
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]["ratio"]))


def compare(dev, cpu, f64, again, cpu_own, f64_own):
    params = {n: gaps(dev[1][n], cpu[1][n], g) for n, g in f64[1].items()}
    own = {n: gaps(dev[1][n], cpu_own[1][n], g)
           for n, g in f64_own[1].items()}
    taps = {}
    for name, v in f64[0].values.items():
        taps[name] = {"value": gaps(dev[0].values[name], cpu[0].values[name],
                                    v)}
        if name in f64[0].grads:
            taps[name]["grad"] = gaps(dev[0].grads[name],
                                      cpu[0].grads[name],
                                      f64[0].grads[name])
    reductions = {}
    for name in sorted({n.split(".")[0] for n in f64[0].grads
                        if n.startswith("adain")}):
        out = {}
        for label, rec in (("device", dev[0]), ("cpu", cpu[0])):
            g, n = rec.grads[f"{name}.y"], rec.values[f"{name}.n"]
            sums = torch.cat([(g * n).sum(1), g.sum(1)], dim=-1)
            out[f"{label}_own_sums"] = dist(sums, rec.grads[f"{name}.gb"])
            out[f"{label}_vs_float64"] = dist(sums,
                                              f64[0].grads[f"{name}.gb"])
        reductions[name] = out
    repeat = max(dist(again[1][n], g) for n, g in dev[1].items())
    return {"params": by_ratio(params), "params_own_choices": by_ratio(own),
            "flips": {label: r[2].flips for label, r in (
                ("cpu", cpu), ("float64", f64), ("device_again", again),
                ("cpu_own", cpu_own), ("float64_own", f64_own))},
            "choices": sum(c.numel() for c in dev[2].choices),
            "taps": taps, "reductions": reductions, "repeat": repeat}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=cs.DATASET_CLIPS)
    ap.add_argument("--frames", type=int, default=cs.DATASET_FRAMES)
    ap.add_argument("--epochs", type=int, default=cs.TRAIN_EPOCHS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=cs.characterize.DEFAULT_CONFIG)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "train_grad_probe.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
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
        work = os.path.join(root, "train")
        os.makedirs(work)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            trainer, _, _ = cs.quiet(cs.train_cli.main, [
                "--config", args.config, "--data-dir", data,
                "--max-epochs", str(args.epochs), "--device", dev.type])
        finally:
            os.chdir(cwd)
        ckpt_path = cs.train_ckpt.latest_checkpoint(os.path.join(
            work, trainer.config["name"], "pth"))
        seed = int(trainer.config.get("manualSeed", 1777))
        ds = cs.MotionDataset(data, device=dev)
        batches = cs.iterate_batches(ds, cs.TRAIN_PARITY_BATCH, seed=seed)
        bs, bc = next(batches), next(batches)
        config = cs.get_config(args.config)
        kernels = {} if dev.type == "cuda" else None
        common = (config, ckpt_path, bs, bc, ds.norm, seed)
        first = run(*common, dev, torch.float32, None, kernels)
        pinned = first[2].choices
        runs = [first, run(*common, "cpu", torch.float32, pinned),
                run(*common, "cpu", torch.float64, pinned),
                run(*common, dev, torch.float32, pinned),
                run(*common, "cpu", torch.float32, None),
                run(*common, "cpu", torch.float64, None)]
    result = compare(*runs)
    result["kernels"] = kernels
    result["card"] = cs.card_line() if dev.type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    worst_taps = sorted(((n, r["grad"]) for n, r in result["taps"].items()
                         if "grad" in r), key=lambda kv: -kv[1]["ratio"])
    print(json.dumps({
        "params": dict(list(result["params"].items())[:8]),
        "params_own_choices": dict(list(
            result["params_own_choices"].items())[:8]),
        "flips": result["flips"], "choices": result["choices"],
        "taps": dict(worst_taps[:8]), "repeat": result["repeat"],
        "card": result["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
