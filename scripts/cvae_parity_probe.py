"""Where the CVAE trainer's card-to-CPU gap comes from.

    python3 scripts/cvae_parity_probe.py [--clips 60] [--frames 1200]
                                         [--iters 40]

Makes chip_smoke.py's cvae data: the dataset phase's synthetic clips
(database built on the CPU), cnt-norm, the Neutral_Princess and
Neutral_AverageJoe character exports on the --random-init generator, and
cli/train_cvae for ``iters`` iterations at the shipped config on the
card.  Then it takes chip_smoke's parity batch and the trained weights
(dropout and condition dropout 0, z = mu) through:

- ``first_offset``: the first offset's forward and backward on the card,
  on the CPU and on the CPU in float64: each metric, and each parameter
  tensor's gradient as the card's and the CPU's distance to float64
  (largest |difference| over the tensor's largest |g|), the worst first;
- ``rollout``: a teacher-forced rollout on each: per parameter tensor the
  mean |card - CPU| as a share of its mean update, and each float32 run's
  mean distance to the float64 rollout's, the worst share first;
- ``conditioning``: the smallest temp-weighted character cnt std the loss
  divides by, and the smallest spread over the tokens of
  mean_variance_norm's input (out_un) relative to its mean.

Prints one JSON line and writes the whole record to ``--out``
(cvae_parity_probe.json in the working directory by default).
``--device cpu --clips 4 --frames 140 --iters 3 --config <small yaml>
--source-style 18`` rehearses it on the CPU (the first 4 clips hold no
Neutral_AverageJoe).
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

ANNEAL_W = 0.7
TOP = 8


def make_data(root, args, dev):
    """The dataset chain and the CVAE training of chip_smoke's phases 10
    and 12; returns (CLI trainer, feature files)."""
    bvh_dir, data = os.path.join(root, "bvh"), os.path.join(root, "data")
    os.makedirs(bvh_dir)
    for i, name in enumerate(cs.dataset_names(args.clips)):
        cs.bvh.save(os.path.join(bvh_dir, name + ".bvh"),
                    cs.make_mocha_bvh_data(
                        T=args.frames, seed=3000 + i,
                        walk_speed=(150.0 if name.startswith("Run")
                                    else 60.0) + 2.0 * (i % 10)))
    cs.quiet(cs.generate_database.main,
             ["--bvh-dir", bvh_dir, "--out", data, "--device", "cpu"])
    cs.MotionDataset(data, device="cpu")
    common = ["--data-dir", data, "--random-init", "--device", dev.type,
              "--config", args.config]
    cs.quiet(cs.collect_features.main, ["cnt-norm", *common])
    files = []
    for style, name in ((args.source_style, "source"),
                        (cs.DATASET_STYLE, "princess")):
        path = os.path.join(root, f"{name}_feature.npz")
        cs.quiet(cs.collect_features.main, [
            "character", *common, "--styles", str(style), "--actions",
            *map(str, cs.DATASET_CHARACTER_ACTIONS), "--out", path])
        files.append(path)
    files.append(os.path.join(data, "cnt_norm.npz"))
    trainer, _, _ = cs.quiet(cs.train_cvae_cli.main, [
        "--config", args.config, "--src-features", files[0],
        "--cha-features", files[1], "--cnt-norm", files[2], "--out",
        os.path.join(root, "cvae"), "--num-iters", str(args.iters),
        "--device", dev.type])
    return trainer, files


def as_float64(t):
    """A CPU trainer turned to float64: weights, constants and optimizer."""
    t.cvae.double()
    for name in ("_enc_std", "_enc_mean", "_ccnt_std", "_ccnt_mean"):
        setattr(t, name, getattr(t, name).double())
    t.restart()
    return t


def on(t, batch):
    dtype = next(t.cvae.parameters()).dtype
    return [torch.as_tensor(a, device=t.device).to(dtype) for a in batch]


def first_offset(t, state, batch):
    """The first offset's metrics and gradients (float64, on the CPU), and
    mean_variance_norm's input spread."""
    t.restart(state)
    src, enc, cnt, dgnd = on(t, batch)
    condition = torch.cat([src[:, 1], enc[:, 0]], dim=1)
    gen = torch.Generator(device=t.device).manual_seed(0)
    t.opt.zero_grad(set_to_none=True)
    total, metrics, out = t._losses(1, condition, src, enc, cnt, dgnd,
                                    ANNEAL_W, gen)
    total.backward()
    out_un = out.detach() * t._enc_std + t._enc_mean
    spread = out_un.std(dim=1) / out_un.mean(dim=1).abs()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in t.cvae.named_parameters()}
    return metrics.detach().double().cpu().numpy(), grads, float(spread.min())


def rollout(t, state, batch):
    t.restart(state)
    t.rollout(*on(t, batch), 0.0, ANNEAL_W,
              torch.Generator(device=t.device).manual_seed(0))
    return {n: p.detach().double().cpu() for n, p in
            t.cvae.named_parameters()}


def worst(rows, key):
    return dict(sorted(rows.items(), key=lambda kv: -kv[1][key])[:TOP])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=cs.DATASET_CLIPS)
    ap.add_argument("--frames", type=int, default=cs.DATASET_FRAMES)
    ap.add_argument("--iters", type=int, default=cs.CVAE_ITERS)
    ap.add_argument("--source-style", type=int, default=cs.CVAE_SOURCE_STYLE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=cs.characterize.DEFAULT_CONFIG)
    ap.add_argument("--out", default="cvae_parity_probe.json")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as root:
        trainer, files = make_data(root, args, dev)
        tc = trainer.tc._replace(dropout=0.0, condition_dropout=0.0)
        state = {k: v.detach().cpu() for k, v in
                 trainer.cvae.state_dict().items()}
        batch = None
        while batch is None:
            batch = trainer.sample_batch(0)
        runs = {"card": cs.cvae_trainer_like(trainer, files, tc, dev),
                "cpu": cs.cvae_trainer_like(trainer, files, tc, cpu),
                "f64": as_float64(cs.cvae_trainer_like(trainer, files, tc,
                                                       cpu))}
        ccnt_std = float(runs["cpu"]._ccnt_std.min())
        with cs.reparameterize_to_mu():
            first = {k: first_offset(t, state, batch)
                     for k, t in runs.items()}
            after = {k: rollout(t, state, batch) for k, t in runs.items()}
    grads = {}
    for n, g64 in first["f64"][1].items():
        scale = float(g64.abs().max()) or 1.0
        d = float((first["card"][1][n] - g64).abs().max()) / scale
        c = float((first["cpu"][1][n] - g64).abs().max()) / scale
        grads[n] = {"card_to_f64": d, "cpu_to_f64": c,
                    "card_cpu": float((first["card"][1][n]
                                       - first["cpu"][1][n]).abs().max())
                    / scale, "max_abs_g": scale}
    params, gap_sum, upd_sum, n_sum = {}, 0.0, 0.0, 0
    for n, start in state.items():
        start = start.double()
        upd = (after["f64"][n] - start).abs()
        gap = (after["card"][n] - after["cpu"][n]).abs()
        params[n] = {
            "gap_share": float(gap.mean() / max(float(upd.mean()), 1e-30)),
            "mean_gap": float(gap.mean()), "mean_update": float(upd.mean()),
            "card_to_f64": float((after["card"][n] - after["f64"][n])
                                 .abs().mean()),
            "cpu_to_f64": float((after["cpu"][n] - after["f64"][n])
                                .abs().mean()),
            "elements": start.numel()}
        gap_sum += float(gap.sum())
        upd_sum += float(upd.sum())
        n_sum += start.numel()
    result = {
        "card": cs.card_line() if dev.type == "cuda" else "cpu",
        "batch": list(batch[0].shape),
        "first_offset_metrics": {k: v[0].tolist() for k, v in first.items()},
        "first_offset_grads": worst(grads, "card_to_f64"),
        "first_offset_grads_all": grads,
        "rollout_mean_gap_share": gap_sum / max(upd_sum, 1e-30),
        "rollout_params": worst(params, "gap_share"),
        "rollout_params_all": params,
        "rollout_to_f64": {
            k: float(sum(float((after[k][n] - after["f64"][n]).abs().sum())
                         for n in state) / n_sum) for k in ("card", "cpu")},
        "conditioning": {
            "min_temp_weighted_cha_cnt_std": ccnt_std,
            "min_out_un_spread": {k: v[2] for k, v in first.items()}}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.endswith("_all")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
