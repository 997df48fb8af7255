"""Which ops make a training step on the card non-deterministic.

    python3 scripts/train_determinism_probe.py [--clips 6] [--device cuda]
        [--steps 1,2,3,4,5,6,7]

Writes the dataset phase's first ``--clips`` synthetic BVH clips (1,200
frames each), builds their database, and runs cli/train for one epoch
(10 steps of 64 at 6 clips, every step logged, the shipped config) in
one process:

1. twice as it ships (no deterministic mode): the parameters and Adam
   moments of the two runs against each other at the parallel phase's
   bars (chip_smoke.compare_states);
2. under ``torch.use_deterministic_algorithms(True, warn_only=True)``
   with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: every op that warns it has
   no deterministic implementation, by message; then twice more in that
   mode, compared as in 1;
3. the first step's gradients (chip_smoke.dp_backward) twice, tensor by
   tensor, as shipped, with ``torch.backends.cudnn.deterministic`` alone
   and in deterministic mode: the tensors whose gradients differ at all;
   and one epoch twice with cuDNN's flag alone;
4. once under ``torch.use_deterministic_algorithms(True)``: the first
   op that raises, if one does;
5. cli/train --data-parallel 2 against --data-parallel 1, as shipped
   and in deterministic mode (warn_only, in the ranks too): the
   parameters and Adam moments at the parallel phase's bars;
6. in deterministic mode (raising, in the ranks too, as the parallel
   phase trains): cli/train --data-parallel 2 twice, the tensors of the
   two runs that are not bit-identical; and one process that sums the
   blocks' gradients as the ranks do (chip_smoke.HalfBatchTrainer)
   against each of them and against the 1-process run, at the bars and
   bit for bit.  What parts the 2-rank run from one process when the
   blocks' sums alone differ.

7. in deterministic mode: the first step's gradients (chip_smoke.
   dp_backward) of 2 spawned ranks, of one process summing the blocks'
   gradients as the ranks do, and of the plain process: the tensors
   that are not bit-identical, pair by pair.

``--steps`` picks which of these run.

Every process runs without TF32 (the ranks through
``NVIDIA_TF32_OVERRIDE=0``, as chip_smoke's parallel phase runs them).

Prints one JSON line a reading and a summary line.  About 4 minutes on an
H100, 1.5 for step 6 alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import warnings

# cuBLAS reads this when its first handle is made; the ranks that
# cli/train spawns would run cuDNN in TF32 without the second
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ["NVIDIA_TF32_OVERRIDE"] = "0"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def differing(a, b):
    """{name: elements that differ} over two {name: tensor} maps."""
    return {k: int((a[k] != b[k]).sum()) for k in a
            if not torch.equal(a[k], b[k])}


def state_differs(p1, p2):
    """Tensors of two trainer checkpoints that are not bit-identical."""
    one, two = (cs.train_ckpt.load_checkpoint(p) for p in (p1, p2))
    out = {}
    for part in ("gen", "prj", "gen_ema"):
        out[part] = len(differing(one[part], two[part]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=cs.DP_CLIPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None,
                    help="a config YAML (default: the shipped one)")
    ap.add_argument("--frames", type=int, default=cs.DATASET_FRAMES)
    ap.add_argument("--steps", default="1,2,3,4,5,6,7",
                    help="the numbered steps to run, comma-separated")
    args = ap.parse_args()
    steps = {int(x) for x in args.steps.split(",")}
    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_determinism_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    cs.no_tf32()
    if dev.type == "cuda":
        cs.log(f"[card] torch {torch.__version__}; {cs.card_line()}")
    config = args.config or cs.characterize.DEFAULT_CONFIG
    readings = {}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "bvh"))
        names = cs.dataset_names(args.clips)
        for i, name in enumerate(names):
            speed = 150.0 if name.startswith("Run") else 60.0
            cs.bvh.save(os.path.join(root, "bvh", name + ".bvh"),
                        cs.make_mocha_bvh_data(
                            T=args.frames, seed=3000 + i,
                            walk_speed=speed + 2.0 * (i % 10)))
        data = cs.subset_database(root, names, os.path.join(root, "data"),
                                  dev)
        step_config = cs.every_step_config(config,
                                           os.path.join(root, "cfg.yaml"))
        train = ["--config", step_config, "--data-dir", data,
                 "--max-epochs", "1", "--device", dev.type]

        def run(name, *extra, trainer=None):
            return cs.train_run(os.path.join(root, name),
                                train + list(extra), trainer=trainer)[1]

        load = cs.train_ckpt.load_checkpoint
        if 1 in steps:
            readings.update(as_shipped(run, load))
        if 2 in steps:
            readings.update(deterministic_repeat(run, load))
        if 3 in steps:
            readings.update(one_backward(run, load, step_config, data, dev))
        if 4 in steps:
            readings.update(raising(run))
        if 5 in steps:
            readings.update(two_ranks_vs_one(run, load))
        if 6 in steps:
            readings.update(half_batch(run, load))
        if 7 in steps:
            readings.update(first_step_blocks(
                {"config": step_config, "data": data}, dev, root))
    print(json.dumps(readings), flush=True)
    return 0


def repeat_reading(load, a, b):
    return {"over_bar": cs.compare_states(load(a), load(b)),
            "tensors_not_identical": state_differs(a, b)}


def as_shipped(run, load):
    """1. One epoch twice as shipped."""
    torch.use_deterministic_algorithms(False)
    out = {"plain_repeat": repeat_reading(load, run("plain_a"),
                                          run("plain_b"))}
    cs.log(f"[probe] as shipped, repeat: {json.dumps(out['plain_repeat'])}")
    return out


def deterministic_repeat(run, load):
    """2. Deterministic mode, warn_only: the ops that warn, and a repeat."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = run("det_a")
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    cs.log(f"[probe] ops with no deterministic implementation (one epoch, "
           f"warn_only): {json.dumps(ops)}")
    out = {"warned_ops": ops,
           "deterministic_repeat": repeat_reading(load, c, run("det_b"))}
    cs.log(f"[probe] deterministic mode, repeat: "
           f"{json.dumps(out['deterministic_repeat'])}")
    torch.use_deterministic_algorithms(False)
    return out


def one_backward(run, load, step_config, data, dev):
    """3. The first step's backward twice in each mode; one epoch twice
    with cuDNN's deterministic flag alone."""
    out = {}
    spec = {"config": step_config, "data": data}
    for mode in ("shipped", "cudnn", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        torch.backends.cudnn.deterministic = mode == "cudnn"
        g1, g2 = (cs.dp_backward(spec, dev, None)["grads"] for _ in "ab")
        diff = differing(g1, g2)
        out[f"first_step_gradients_differing_{mode}"] = diff
        cs.log(f"[probe] first-step gradients, {mode}, two backwards: "
               f"{len(diff)} of {len(g1)} tensors differ: "
               f"{json.dumps(diff)}")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = True
    out["cudnn_flag_repeat"] = repeat_reading(load, run("cudnn_a"),
                                              run("cudnn_b"))
    torch.backends.cudnn.deterministic = False
    cs.log(f"[probe] cudnn.deterministic alone, repeat: "
           f"{json.dumps(out['cudnn_flag_repeat'])}")
    return out


def raising(run):
    """4. Deterministic mode, raising: the first op that raises."""
    torch.use_deterministic_algorithms(True)
    try:
        run("det_raise")
        raised = None
    except RuntimeError as e:
        raised = str(e).split("\n")[0]
    torch.use_deterministic_algorithms(False)
    cs.log(f"[probe] deterministic mode, raising: {json.dumps(raised)}")
    return {"raised": raised}


def two_ranks_vs_one(run, load):
    """5. 2 ranks against 1, as shipped and in deterministic mode
    (warn_only)."""
    out = {}
    for mode in ("plain", "deterministic"):
        mode_ctx = cs.deterministic_training(warn_only=True) \
            if mode == "deterministic" else contextlib.nullcontext()
        with mode_ctx:
            one = run(f"{mode}_one")
            two = run(f"{mode}_two", "--data-parallel", "2")
        out[f"{mode}_two_ranks_vs_one"] = cs.compare_states(load(one),
                                                            load(two))
        cs.log(f"[probe] {mode}, 2 ranks vs 1: "
               f"{json.dumps(out[f'{mode}_two_ranks_vs_one'])}")
    return out


def half_batch(run, load):
    """6. Deterministic mode (raising): 2 ranks twice; one process
    summing the blocks' gradients as the ranks do, against them and
    against the 1-process run."""
    with cs.deterministic_training():
        one = load(run("det6_one"))
        two_a = load(run("det6_two_a", "--data-parallel", "2"))
        two_b = load(run("det6_two_b", "--data-parallel", "2"))
        half = load(run("det6_half_batch", trainer=cs.HalfBatchTrainer))

    def reading(a, b):
        return {"tensors_not_identical": len(cs.states_differ(a, b)),
                "at_the_bars": cs.compare_states(a, b)}

    out = {"two_ranks_repeat": reading(two_a, two_b),
           "half_batch_vs_two_ranks": reading(half, two_a),
           "half_batch_vs_one": reading(one, half),
           "two_ranks_vs_one": reading(one, two_a)}
    for k, v in out.items():
        cs.log(f"[probe] deterministic mode, {k}: {json.dumps(v)}")
    return out


def grad_rank(rank, dev, spec, out):
    """One rank of step 7: its first-step gradients after the mean."""
    cs.no_tf32()
    if rank == 0:
        torch.save(cs.dp_backward(spec, dev, cs.make_mesh(
            device_type=dev.type))["grads"], out)
    else:
        cs.dp_backward(spec, dev, cs.make_mesh(device_type=dev.type))


def first_step_blocks(spec, dev, root):
    """7. The first step's gradients: 2 ranks, the half-batch process and
    the plain one, in deterministic mode."""
    out = os.path.join(root, "grads_rank0.pt")
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    if dev.type == "cpu":   # the ranks' thread count (distributed.spawn)
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // cs.PARALLEL_RANKS))
    with cs.deterministic_training():
        cs.distributed.spawn(grad_rank, cs.PARALLEL_RANKS,
                             args=(spec, out), backend="gloo",
                             device=rank_dev)
        one = cs.dp_backward(spec, dev, None)["grads"]
        real = cs.GeneratorTrainer
        cs.GeneratorTrainer = cs.HalfBatchTrainer
        try:
            half = cs.dp_backward(spec, dev, None)["grads"]
        finally:
            cs.GeneratorTrainer = real
    two = torch.load(out)
    readings = {"first_step_half_batch_vs_two_ranks": differing(half, two),
                "first_step_one_vs_two_ranks": differing(one, two),
                "first_step_tensors": len(one)}
    cs.log(f"[probe] deterministic mode, first step, tensors not "
           f"bit-identical: {json.dumps(readings)}")
    return readings


if __name__ == "__main__":
    sys.exit(main())
