"""Data-parallel generator training and resuming from the JAX trainer's
optimizer state, on the CPU.

The model and dataset of tests/test_torch_train.py (dim 64, 2 heads,
depth 1; two synthetic 140-frame clips, 20 windows, batches of 8).  The
JAX trainer runs on its 8-device mesh (one sample a device), dropout off:
2 steps, a ``.msgpack`` save, a 3rd step.  Against it: the port's
trainer on 2 gloo ranks (4 samples each) for 3 steps, at
tests/test_torch_train.py's bars (losses rtol 2e-3, NCE 2e-2; parameters
and EMA atol 5e-5 x scale / rtol 2e-4); the same with dropout on against
the port's single-process trainer (the first step's gradients rtol 1e-4
/ atol 1e-5 x the largest, each step's losses at the bars above; the
parameters are not compared after dropout-on steps: Adam's first update
is lr x sign(g) for an element whose gradient lies within float32's
rounding of zero, and with dropout on such an element of
``gen.embed.joint.tcn.weight`` lands 8.2e-6 apart, over the 2.8e-6 bar);
``cli/train --data-parallel 2``, and the same CLI under ``torchrun``,
against ``--data-parallel 1``;
and the port resuming the JAX file (and its ``convert_checkpoint``
``.ckpt``) for the 3rd step, AdamW's moments and counts included.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("jax")
import jax  # noqa: E402

from mocha_sigasia2023_tpu.data.dataset import (  # noqa: E402
    MotionDataset as JMotionDataset)
from mocha_sigasia2023_tpu.data.dataset import (  # noqa: E402
    iterate_batches as j_iterate_batches)
from mocha_sigasia2023_tpu.parallel import make_mesh  # noqa: E402
from mocha_sigasia2023_tpu.train import trainer as jtrainer  # noqa: E402

from mocha_sigasia2023_torch.cli import convert_checkpoint  # noqa: E402
from mocha_sigasia2023_torch.cli import generate_database  # noqa: E402
from mocha_sigasia2023_torch.cli import train as tcli  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.parallel import distributed as pdist  # noqa: E402
from mocha_sigasia2023_torch.train import checkpoint as tckpt  # noqa: E402
from mocha_sigasia2023_torch.train import trainer as ttrainer  # noqa: E402
from mocha_sigasia2023_torch.utils import config as tconfig  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOCHA_PARENTS = [-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13, 14, 8, 16,
                 17, 18, 0, 20, 21, 22]
MODEL = {
    "mot_in_dim": 15, "nframes": 60, "njoints": 24, "nbody": 6,
    "temporal_patch_size": 4,
    "encoder_dim": 64, "encoder_depth": 1, "encoder_heads": 2,
    "encoder_dim_head": 32, "encoder_mlp_dim": 128,
    "decoder_dim": 64, "decoder_depth": 1, "decoder_heads": 2,
    "decoder_dim_head": 32, "decoder_mlp_dim": 128,
    "prj_dim": 64, "num_patches": -1,
    "graph": {
        "joint": {"layout": "mocha", "strategy": "distance", "max_hop": 2},
        "bodypart": {"layout": "mocha", "strategy": "distance",
                     "max_hop": 1},
    },
}
SMALL_CONFIG = {
    "name": "test_model",
    "dataset": {"mocha": {"parents": MOCHA_PARENTS}},
    "model": MODEL,
    "lr_gen": 1e-4, "weight_decay_gen": 1e-4, "lr_drop": 100,
    "rec_w": 1, "nce_w": 0.1, "cyc_w": 1, "ema_beta": 0.999,
}
CLIPS = ("Walk_Neutral_Princess_001", "Run_Angry_Clown_002")
LOSS_RTOL = {"gen/loss_total": 2e-3, "gen/loss_recon": 2e-3,
             "gen/loss_nce_cnt": 2e-2, "gen/loss_cyc": 2e-3}
STEPS = 3
DROPOUT_SEED = 42


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_parallel_ds")
    os.makedirs(d / "bvh")
    for i, name in enumerate(CLIPS):
        bvh.save(str(d / "bvh" / f"{name}.bvh"),
                 make_mocha_bvh_data(T=140, seed=100 + i))
    with contextlib.redirect_stdout(None):
        generate_database.main(["--bvh-dir", str(d / "bvh"), "--out",
                                str(d / "data"), "--device", "cpu"])
    ds = JMotionDataset(str(d / "data"), "train")
    batches = list(j_iterate_batches(ds, 8, shuffle=True, seed=3))
    steps = [(batches[s % 2], batches[(s + 1) % 2]) for s in range(STEPS)]
    return d, ds, steps


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX trainer on its 8-device mesh: its initial params, each
    step's metrics, the .msgpack after step 2 and the state after 3."""
    _, ds, steps = data
    jt = jtrainer.GeneratorTrainer(
        dict(SMALL_CONFIG, split_step=False, dropout=False),
        steps_per_epoch=100, mesh=make_mesh())
    assert jt.mesh.shape["data"] == 8
    init = jax.tree.map(np.array, jt.state.params)
    key = jax.random.PRNGKey(0)
    metrics, path = [], None
    for step, (bs, bc) in enumerate(steps):
        if step == 2:
            path = jt.save(str(tmp_path_factory.mktemp("jax_ckpt")), 2)
            opt_before_3 = jax.tree.map(np.asarray, jt.state.opt_state)
        key, sub = jax.random.split(key)
        m = jt.train_step(bs, bc, ds.norm, sub)
        metrics.append({k: float(v) for k, v in m.items()})
    final = {"gen": jt.state.params["gen"], "prj": jt.state.params["prj"],
             "gen_ema": jt.state.gen_ema}
    final = {k: convert.flatten_pytree(jax.tree.map(np.asarray, v))
             for k, v in final.items()}
    return dict(init=init, metrics=metrics, msgpack=path, final=final,
                opt_before_3=opt_before_3,
                count=int(np.asarray(jt.state.opt_state[1][0].count)))


def _spec(data, init, out, dropout, seed):
    _, ds, steps = data
    sd = ranks.state_dicts_from_jax(init)
    return {"config": dict(SMALL_CONFIG, dropout=dropout),
            "gen": sd["gen"], "prj": sd["prj"],
            "norm": {k: torch.as_tensor(np.array(v))
                     for k, v in ds.norm.items()},
            "batches": [({k: np.array(v) for k, v in bs.items()},
                         {k: np.array(v) for k, v in bc.items()})
                        for bs, bc in steps],
            "seed": seed, "out": out}


@pytest.fixture(scope="module")
def port_runs(data, jax_run, tmp_path_factory):
    """One launch of 2 ranks: 3 steps with dropout off, 3 with dropout on;
    and the single-process port trainer with dropout on."""
    d = tmp_path_factory.mktemp("dp_runs")
    specs = [_spec(data, jax_run["init"], str(d / f"{name}_{{rank}}.pt"),
                   dropout, seed)
             for name, dropout, seed in (("off", False, None),
                                         ("on", True, DROPOUT_SEED))]
    pdist.spawn(ranks.trainer_rank, 2, args=(specs,), device="cpu",
                threads=2)
    out = {name: [torch.load(d / f"{name}_{r}.pt") for r in range(2)]
           for name in ("off", "on")}
    out["single_on"] = ranks.run_trainer(specs[1], torch.device("cpu"), None)
    return out


def _check_params(got, want, what):
    for part, flat in want.items():
        assert set(flat) == set(got[part]), (what, part)
        for k, b in flat.items():
            a = got[part][k]
            a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
            b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-3)
            np.testing.assert_allclose(a, b, atol=5e-5 * scale, rtol=2e-4,
                                       err_msg=f"{what}: {part}.{k}")


def _check_losses(got, want, what):
    for step, (g, w) in enumerate(zip(got, want)):
        for name, rtol in LOSS_RTOL.items():
            np.testing.assert_allclose(g[name], w[name], rtol=rtol,
                                       err_msg=f"{what}, step {step}: {name}")


def test_data_parallel_steps_match_the_jax_mesh_trainer(jax_run, port_runs):
    r0, r1 = port_runs["off"]
    assert r0["step"] == r1["step"] == STEPS
    _check_losses(r0["metrics"], jax_run["metrics"], "2 ranks vs JAX")
    _check_params(r0, jax_run["final"], "2 ranks vs JAX")
    # the ranks hold one state and report the global batch's metrics
    for part in ("gen", "prj", "gen_ema"):
        for k in r0[part]:
            assert torch.equal(r0[part][k], r1[part][k]), (part, k)
    assert r0["metrics"] == r1["metrics"]


def test_data_parallel_dropout_matches_the_single_process_step(port_runs):
    (r0, r1), one = port_runs["on"], port_runs["single_on"]
    gscale = max(float(g.abs().max()) for g in one["grads"].values())
    assert set(r0["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        np.testing.assert_allclose(r0["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5 * gscale, err_msg=k)
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
    for name in LOSS_RTOL:
        np.testing.assert_allclose(r0["first"][name], one["first"][name],
                                   rtol=1e-5, err_msg=name)
    _check_losses(r0["metrics"], one["metrics"], "2 ranks vs 1, dropout")
    # the masks are on: the same batch without dropout gives another loss
    off = port_runs["off"][0]["first"]["gen/loss_total"]
    assert abs(r0["first"]["gen/loss_total"] - off) > 1e-6


def _train_config(path):
    """The shipped config at the small widths, every step logged."""
    cfg = tconfig.get_config(os.path.join(
        REPO, "mocha_sigasia2023_torch", "configs", "config.yaml"))
    cfg["model"].update({k: v for k, v in MODEL.items() if k != "graph"})
    cfg["cvae"].update(latent_dim=MODEL["encoder_dim"], depth=1, nheads=2,
                       feedforward_dim=64)
    cfg.update(log_every=1, save_every=25)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _cli(work, config, data_dir, *extra):
    os.makedirs(work)
    with contextlib.chdir(work), contextlib.redirect_stdout(None):
        tcli.main(["--config", config, "--data-dir", data_dir,
                   "--max-epochs", "1", "--batch-size", "8",
                   "--device", "cpu", *extra])
    return _read_run(work)


def _read_run(work):
    main = os.path.join(work, "model_ours")
    recs = [json.loads(line) for line in
            open(os.path.join(main, "log", "train", "metrics.jsonl"))]
    return (tckpt.load_checkpoint(tckpt.checkpoint_path(
        os.path.join(main, "pth"), 1)), recs, main)


@pytest.fixture(scope="module")
def cli_one(data, tmp_path_factory):
    """cli/train --data-parallel 1 (this process): the reference run."""
    d, _, _ = data
    tmp = tmp_path_factory.mktemp("cli_one")
    config = _train_config(tmp / "config.yaml")
    return config, _cli(str(tmp / "k1"), config, str(d / "data"),
                        "--data-parallel", "1")


def _same_run(two, recs2, main2, one, recs1, what):
    assert two["step"] == one["step"] == 2
    _check_params(two, {p: one[p] for p in ("gen", "prj", "gen_ema")}, what)
    assert [(r["tag"], r["step"]) for r in recs2] == \
        [(r["tag"], r["step"]) for r in recs1]   # rank 0 alone logs
    for a, b in zip(recs2, recs1):
        if a["tag"] in LOSS_RTOL:
            np.testing.assert_allclose(a["value"], b["value"],
                                       rtol=LOSS_RTOL[a["tag"]],
                                       err_msg=f"{what}: {a['tag']} "
                                       f"{a['step']}")
    assert sorted(os.listdir(main2)) == ["info", "log", "pth"]
    assert os.listdir(os.path.join(main2, "pth")) == ["gen_001.ckpt"]


def test_cli_data_parallel_2_writes_the_checkpoint_of_1(data, cli_one,
                                                        tmp_path):
    d, _, _ = data
    config, (one, recs1, _) = cli_one
    two, recs2, main2 = _cli(str(tmp_path / "k2"), config, str(d / "data"),
                             "--data-parallel", "2")
    _same_run(two, recs2, main2, one, recs1, "cli 2 ranks vs 1")


def test_cli_under_torchrun_writes_the_checkpoint_of_1(data, cli_one,
                                                       tmp_path):
    """The same CLI as 2 ranks that torchrun started (WORLD_SIZE, RANK,
    MASTER_ADDR / MASTER_PORT from its agent)."""
    d, _, _ = data
    config, (one, recs1, _) = cli_one
    work = tmp_path / "torchrun"
    work.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mocha_sigasia2023_torch.cli.train",
         "--config", config, "--data-dir", str(d / "data"),
         "--max-epochs", "1", "--batch-size", "8", "--device", "cpu"],
        cwd=str(work), env=dict(os.environ, PYTHONPATH=REPO,
                                OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: data=2 model=1 (gloo)" in proc.stdout
    _same_run(*_read_run(str(work)), one, recs1, "torchrun 2 ranks vs 1")


def test_cli_refuses_ranks_that_do_not_split_the_batch():
    with pytest.raises(SystemExit, match="split the batch of 8 evenly"):
        tcli.main(["--data-parallel", "3", "--batch-size", "8",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="gloo"):
        tcli.main(["--backend", "nccl", "--device", "cpu"])


def _resumed_step(path, data, init):
    _, ds, steps = data
    t = ttrainer.GeneratorTrainer(dict(SMALL_CONFIG, dropout=False), 100,
                                  device="cpu")
    assert t.load(path, resume=True) == 2
    before = {"step": t.step, "opt": copy.deepcopy(t.opt.state_dict()),
              "last_epoch": t.schedule.last_epoch,
              "lr": [g["lr"] for g in t.opt.param_groups]}
    t.train_step(*steps[2], ds.norm)
    return t, before


def _check_resumed(t, before, jax_run):
    assert before["step"] == 2 and before["last_epoch"] == 2
    assert before["lr"] == [SMALL_CONFIG["lr_gen"]] * 2
    mu = convert.flatten_pytree(jax_run["opt_before_3"][1][0].mu)
    names = [f"gen.{n}" for n, _ in t.gen.named_parameters()] + \
        [f"prj.{n}" for n, _ in t.prj.named_parameters()]
    state = before["opt"]["state"]
    assert len(state) == len(names) == len(mu)
    for i, name in enumerate(names):
        assert float(state[i]["step"]) == 2.0
        np.testing.assert_array_equal(state[i]["exp_avg"].numpy(), mu[name])
    assert t.step == jax_run["count"] == STEPS
    assert float(t.opt.state_dict()["state"][0]["step"]) == STEPS
    got = {"gen": t.gen.state_dict(), "prj": t.prj.state_dict(),
           "gen_ema": t.gen_ema.state_dict()}
    _check_params(got, jax_run["final"], "resumed vs JAX")


def test_resume_from_the_jax_msgpack_takes_jax_next_step(data, jax_run):
    t, before = _resumed_step(jax_run["msgpack"], data, jax_run["init"])
    _check_resumed(t, before, jax_run)


def test_converted_checkpoint_resumes_the_same(data, jax_run, tmp_path):
    config = _train_config(tmp_path / "config.yaml")
    dst = str(tmp_path / "gen_002.ckpt")
    with contextlib.redirect_stdout(None):
        convert_checkpoint.main([jax_run["msgpack"], dst, "--kind", "gen",
                                 "--config", config])
    saved = tckpt.load_checkpoint(dst)
    assert saved["step"] == 2 and saved["opt_state"]["adamw"]["count"] == 2
    t, before = _resumed_step(dst, data, jax_run["init"])
    _check_resumed(t, before, jax_run)
    a, _ = _resumed_step(jax_run["msgpack"], data, jax_run["init"])
    for k, v in a.gen.state_dict().items():
        assert torch.equal(v, t.gen.state_dict()[k]), k
