"""The port's generator training path against the JAX package, on the CPU.

One small model (tests/test_train.py:96-116's config: dim 64, 2 heads,
depth 1) and one tiny dataset (two synthetic 140-frame clips, mirrored:
20 windows, as test_train.py's ``tiny_dataset``), both made here from
seeds; the JAX trainer is built once for the module and its initial
weights reach the port through the weight bridge.  Bars, from
tests/test_train.py: one ``compute_gen_loss`` gradient against jax.grad
within rtol 1e-4 / atol 1e-5 x the largest gradient (:210); three
``train_step``s on the same batches (dropout off) with the losses within
rtol 2e-3 (NCE 2e-2) and the params and EMA within atol 5e-5 x scale /
rtol 2e-4 (:342-362); bf16 forwards within 5% of float32 (:521-523); a
remat step equal to a plain one with dropout on, to rtol 1e-4 / atol
1e-5 x the largest gradient (:226-234).  Then the port's own CLI,
checkpoints and prefetching.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.data.dataset import (  # noqa: E402
    MotionDataset as JMotionDataset)
from mocha_sigasia2023_tpu.data.dataset import (  # noqa: E402
    iterate_batches as j_iterate_batches)
from mocha_sigasia2023_tpu.parallel import make_mesh  # noqa: E402
from mocha_sigasia2023_tpu.train import trainer as jtrainer  # noqa: E402
from mocha_sigasia2023_tpu.utils import config as jconfig  # noqa: E402
from mocha_sigasia2023_tpu.utils.logging import (  # noqa: E402
    MetricsLogger as JMetricsLogger)

from mocha_sigasia2023_torch.cli import characterize as tchar  # noqa: E402
from mocha_sigasia2023_torch.cli import generate_database  # noqa: E402
from mocha_sigasia2023_torch.cli import train as tcli  # noqa: E402
from mocha_sigasia2023_torch.data import dataset as tds  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import (  # noqa: E402
    make_mocha_bvh_data)
from mocha_sigasia2023_torch.io import bvh  # noqa: E402
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.train import checkpoint as tckpt  # noqa: E402
from mocha_sigasia2023_torch.train import losses as tlosses  # noqa: E402
from mocha_sigasia2023_torch.train import trainer as ttrainer  # noqa: E402
from mocha_sigasia2023_torch.utils import config as tconfig  # noqa: E402
from mocha_sigasia2023_torch.utils.logging import MetricsLogger  # noqa: E402

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
LOSSES = ("gen/loss_total", "gen/loss_recon", "gen/loss_nce_cnt",
          "gen/loss_cyc")
METRICS = LOSSES + ("gen/cnt_acc_top1", "gen/cnt_acc_top5")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tiny dataset: its directory, and the JAX MotionDataset over it
    (which writes norm.npz; the port's reads the same file)."""
    d = tmp_path_factory.mktemp("train_ds")
    os.makedirs(d / "bvh")
    for i, name in enumerate(CLIPS):
        bvh.save(str(d / "bvh" / f"{name}.bvh"),
                 make_mocha_bvh_data(T=140, seed=100 + i))
    with contextlib.redirect_stdout(None):
        generate_database.main(["--bvh-dir", str(d / "bvh"), "--out",
                                str(d / "data"), "--device", "cpu"])
    return d, JMotionDataset(str(d / "data"), "train")


@pytest.fixture(scope="module")
def jax_trainer(data):
    """The JAX trainer (monolithic step, dropout off, one device) and a
    copy of its initial params."""
    jt = jtrainer.GeneratorTrainer(
        dict(SMALL_CONFIG, split_step=False, dropout=False),
        steps_per_epoch=100, mesh=make_mesh(n_data=1))
    return jt, jax.tree.map(np.array, jt.state.params)


def port_trainer(init, **extra):
    """A port trainer starting from the JAX params ``init``."""
    t = ttrainer.GeneratorTrainer(dict(SMALL_CONFIG, **extra),
                                  steps_per_epoch=100, device="cpu")
    gen = convert.generator_from_jax(init["gen"], t.gen_cfg, device="cpu")
    with torch.no_grad():
        t.gen.load_state_dict(gen.state_dict())
        t.gen_ema.load_state_dict(gen.state_dict())
        t.prj.load_state_dict(convert.projector_from_jax(
            init["prj"], t.prj_cfg, device="cpu").state_dict())
    return t


def _batches(ds, seed=3):
    out = list(j_iterate_batches(ds, 8, shuffle=True, seed=seed))
    assert len(out) >= 2
    return out


def _port_params(t):
    return {"gen": {k: v.detach().numpy() for k, v in
                    t.gen.state_dict().items()},
            "prj": {k: v.detach().numpy() for k, v in
                    t.prj.state_dict().items()}}


def test_compute_gen_loss_gradient_matches_jax(data, jax_trainer):
    _, ds = data
    jt, init = jax_trainer
    bs, bc = _batches(ds)[:2]

    def loss_fn(p):
        return jtrainer.compute_gen_loss(
            p, jt.gen_cfg, jt.prj_cfg, bs, bc, ds.norm, jt.parents,
            jt.weights, jax.random.PRNGKey(0), train=False)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, init))
    pt = port_trainer(init, dropout=False)
    tm, _ = pt.backward(bs, bc, ds.norm)
    # the losses; the top-k accuracies count near-tied NCE logits at these
    # random weights (positive-to-negative gaps of ~1e-4 in logits of ~14),
    # which float32 rounding orders either way, so they are not compared
    # (nor does tests/test_train.py compare them)
    assert set(tm) == set(jm) == set(METRICS)
    for name in LOSSES:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    jflat = {part: convert.flatten_pytree(jax.tree.map(np.asarray, jg[part]))
             for part in ("gen", "prj")}
    tgrads = {"gen": dict(pt.gen.named_parameters()),
              "prj": dict(pt.prj.named_parameters())}
    gscale = max(float(np.abs(g).max()) for part in jflat.values()
                 for g in part.values())
    for part, flat in jflat.items():
        assert set(flat) == set(tgrads[part])
        for k, g in flat.items():
            np.testing.assert_allclose(
                tgrads[part][k].grad.numpy(), g, rtol=1e-4,
                atol=1e-5 * gscale, err_msg=f"{part}.{k}")


def test_backward_returns_the_nce_logits_its_accuracies_rank(data,
                                                             jax_trainer):
    _, ds = data
    _, init = jax_trainer
    bs, bc = _batches(ds)[:2]
    pt = port_trainer(init, dropout=False)
    m, logits = pt.backward(bs, bc, ds.norm)
    n = bs["X"].shape[0] * pt.gen_cfg.num_tokens
    assert logits.shape == (n, n + 1) and not logits.requires_grad
    top1, top5 = tlosses.contrastive_acc(logits)
    assert float(top1) == float(m["gen/cnt_acc_top1"])
    assert float(top5) == float(m["gen/cnt_acc_top5"])


def test_three_steps_match_jax_trainer(data, jax_trainer):
    _, ds = data
    jt, init = jax_trainer
    pt = port_trainer(init, dropout=False)
    batches = _batches(ds)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        bs, bc = batches[step % 2], batches[(step + 1) % 2]
        key, sub = jax.random.split(key)
        jm = jt.train_step(bs, bc, ds.norm, sub)
        tm = pt.train_step(bs, bc, ds.norm)
        for name, rtol in (("gen/loss_total", 2e-3), ("gen/loss_recon", 2e-3),
                           ("gen/loss_nce_cnt", 2e-2), ("gen/loss_cyc", 2e-3)):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=rtol, err_msg=f"step {step}: "
                                       f"{name}")
    assert pt.step == 3 and int(jt.state.step) == 3
    want = {"gen": jt.state.params["gen"], "prj": jt.state.params["prj"],
            "gen_ema": jt.state.gen_ema}
    got = _port_params(pt)
    got["gen_ema"] = {k: v.numpy() for k, v in pt.gen_ema.state_dict().items()}
    for part, tree in want.items():
        flat = convert.flatten_pytree(jax.tree.map(np.asarray, tree))
        assert set(flat) == set(got[part])
        for k, b in flat.items():
            scale = max(float(np.abs(b).max()), 1e-3)
            np.testing.assert_allclose(got[part][k], b, atol=5e-5 * scale,
                                       rtol=2e-4, err_msg=f"{part}.{k}")
    # the params moved, and the EMA trails them
    moved = got["gen"]["head.conv_out.bias"] - init["gen"]["head"][
        "conv_out"]["bias"]
    assert np.abs(moved).max() > 0
    trail = got["gen_ema"]["head.conv_out.bias"] - init["gen"]["head"][
        "conv_out"]["bias"]
    assert np.abs(trail).max() < np.abs(moved).max()


def _grads(t):
    return {k: p.grad.clone() for k, p in (*t.gen.named_parameters(),
                                           *t.prj.named_parameters())}


def test_remat_step_equals_plain_step_with_dropout(data, jax_trainer):
    _, ds = data
    _, init = jax_trainer
    bs, bc = _batches(ds, seed=7)[:2]
    runs = []
    for remat in (False, True):
        t = port_trainer(init, dropout=True, remat=remat)
        m, _ = t.backward(bs, bc, ds.norm,
                          torch.Generator().manual_seed(42))
        runs.append((m, _grads(t)))
    (m0, g0), (m1, g1) = runs
    for name in LOSSES:
        np.testing.assert_allclose(float(m1[name]), float(m0[name]),
                                   rtol=1e-5, err_msg=name)
    gscale = max(float(g.abs().max()) for g in g0.values())
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-4,
                                   atol=1e-5 * gscale, err_msg=k)
    # dropout is on: another seed gives another loss
    t = port_trainer(init, dropout=True)
    m2, _ = t.backward(bs, bc, ds.norm, torch.Generator().manual_seed(43))
    assert float(m2["gen/loss_total"]) != float(m0["gen/loss_total"])


def test_bf16_compute_tracks_float32(data, jax_trainer):
    _, ds = data
    _, init = jax_trainer
    bs, bc = _batches(ds)[:2]
    m32 = port_trainer(init, dropout=False).train_step(bs, bc, ds.norm)
    tbf = port_trainer(init, dropout=False, compute_dtype="bfloat16")
    mbf = tbf.train_step(bs, bc, ds.norm)
    for p in (*tbf.gen.parameters(), *tbf.prj.parameters(),
              *tbf.gen_ema.parameters()):
        assert p.dtype == torch.float32       # master weights stay f32
    for name in LOSSES:
        a, b = float(m32[name]), float(mbf[name])
        assert np.isfinite(b)
        assert abs(a - b) <= 0.05 * max(abs(a), 1.0), (name, a, b)


def test_describe_params_is_the_jax_listing(jax_trainer):
    jt, _ = jax_trainer
    pt = ttrainer.GeneratorTrainer(SMALL_CONFIG, 100, device="cpu")
    assert tconfig.describe_params(pt.gen, "Generator") == \
        jconfig.describe_params(jt.state.params["gen"], "Generator")
    assert tconfig.describe_params(pt.prj, "Projector") == \
        jconfig.describe_params(jt.state.params["prj"], "Projector")


def test_metrics_logger_writes_the_jax_records(tmp_path):
    metrics = {"gen/loss_total": 1.5, "gen/loss_nce_cnt": 0.25}
    for cls, sub in ((JMetricsLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / sub), tensorboard=False)
        log.add_scalars(metrics, 7)
        log.close()
    recs = {sub: [json.loads(line) for line in
                  open(tmp_path / sub / "metrics.jsonl")]
            for sub in ("jax", "port")}
    assert [{k: v for k, v in r.items() if k != "time"}
            for r in recs["port"]] == \
        [{k: v for k, v in r.items() if k != "time"} for r in recs["jax"]]
    assert all(set(r) == {"tag", "value", "step", "time"}
               for r in recs["port"])


def _train_config(path):
    """The shipped config at the small widths: every step logged, one
    checkpoint at the end."""
    cfg = tconfig.get_config(os.path.join(
        REPO, "mocha_sigasia2023_torch", "configs", "config.yaml"))
    cfg["model"].update({k: v for k, v in MODEL.items() if k != "graph"})
    cfg["cvae"].update(latent_dim=MODEL["encoder_dim"], depth=1, nheads=2,
                       feedforward_dim=64)
    cfg.update(log_every=1, save_every=25)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def cli_run(data, tmp_path_factory):
    """cli/train.main for one epoch at batch 8 on the tiny dataset, from a
    working directory of its own; returns (workdir, config path, the
    trainer it returned)."""
    d, _ = data
    work = tmp_path_factory.mktemp("train_cli")
    config = _train_config(work / "config.yaml")
    with contextlib.chdir(work), contextlib.redirect_stdout(None):
        trainer = tcli.main(["--config", config, "--data-dir",
                             str(d / "data"), "--max-epochs", "1",
                             "--batch-size", "8", "--device", "cpu"])
    return work, config, trainer


def test_cli_train_writes_info_metrics_and_checkpoint(cli_run):
    work, config, trainer = cli_run
    main = work / "model_ours"
    assert open(main / "info" / "config.yaml").read() == open(config).read()
    network = open(main / "info" / "info-network").read()
    assert network.startswith("Generator\n") and "\n\nProjector\n" in network
    recs = [json.loads(line) for line in
            open(main / "log" / "train" / "metrics.jsonl")]
    # 20 windows at batch 8: two steps an epoch, each logged
    assert sorted({r["step"] for r in recs}) == [0, 1]
    assert {r["tag"] for r in recs} == set(METRICS)
    assert all(np.isfinite(r["value"]) for r in recs)
    path = tckpt.latest_checkpoint(str(main / "pth"))
    assert path == tckpt.checkpoint_path(str(main / "pth"), 1)
    assert tckpt.epoch_from_path(path) == 1 and trainer.step == 2
    assert not [f for f in os.listdir(main / "pth") if ".tmp." in f]


def _optimizer_tensors(t):
    sd = t.opt.state_dict()
    return [(i, k, v) for i, s in sorted(sd["state"].items())
            for k, v in sorted(s.items())]


def test_resume_restores_the_trainer_exactly(cli_run):
    work, config, trainer = cli_run
    path = tckpt.checkpoint_path(str(work / "model_ours" / "pth"), 1)
    fresh = ttrainer.GeneratorTrainer(tconfig.get_config(config), 2,
                                      seed=5, device="cpu")
    assert fresh.load(path, resume=True) == 1
    for a, b in ((trainer.gen, fresh.gen), (trainer.prj, fresh.prj),
                 (trainer.gen_ema, fresh.gen_ema)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    want, got = _optimizer_tensors(trainer), _optimizer_tensors(fresh)
    assert len(want) == len(got) == 3 * (
        len(list(trainer.gen.parameters()))
        + len(list(trainer.prj.parameters())))
    for (i, k, a), (j, m, b) in zip(want, got):
        assert (i, k) == (j, m) and torch.equal(a, b), (i, k)
    assert fresh.schedule.state_dict() == trainer.schedule.state_dict()
    assert fresh.step == trainer.step == 2
    # the CLI resumes at the checkpoint's epoch and trains the next
    with contextlib.chdir(work), contextlib.redirect_stdout(None):
        again = tcli.main(["--config", config, "--max-epochs", "2",
                           "--batch-size", "8", "--device", "cpu",
                           "--data-dir", trainer.config["data_dir"],
                           "--resume", path])
    assert again.step == 4
    assert tckpt.latest_checkpoint(str(work / "model_ours" / "pth")) == \
        tckpt.checkpoint_path(str(work / "model_ours" / "pth"), 2)


def test_characterize_serves_the_checkpoint_ema(cli_run, data, monkeypatch):
    work, config, trainer = cli_run
    d, _ = data
    path = tckpt.checkpoint_path(str(work / "model_ours" / "pth"), 1)
    args = ["--config", config, "--src", str(d / "bvh" / f"{CLIPS[0]}.bvh"),
            "--cha", str(d / "bvh" / f"{CLIPS[1]}.bvh"), "--random-init",
            "--deterministic", "--device", "cpu"]
    with contextlib.redirect_stdout(None):
        tchar.main(args + ["--gen-ckpt", path, "--out", str(work / "a")])
        ema = trainer.gen_ema_params
        monkeypatch.setattr(tchar, "load_generator",
                            lambda *a: ema.requires_grad_(False))
        tchar.main(args + ["--out", str(work / "b")])
    files = sorted(os.listdir(work / "a"))
    assert len(files) == 3 and files == sorted(os.listdir(work / "b"))
    for f in files:
        a, b = bvh.load(str(work / "a" / f)), bvh.load(str(work / "b" / f))
        assert np.isfinite(a["positions"]).all()
        np.testing.assert_array_equal(a["positions"], b["positions"])
        np.testing.assert_array_equal(a["rotations"], b["rotations"])


def test_prefetch_batches_yields_the_plain_batches(data):
    d, _ = data
    ds = tds.MotionDataset(str(d / "data"), device="cpu")
    plain = list(tds.iterate_batches(ds, 4, seed=1, epoch=2))
    placed = list(tds.prefetch_batches(
        tds.iterate_batches(ds, 4, seed=1, epoch=2),
        place=lambda b: {k: torch.from_numpy(v) for k, v in b.items()}))
    assert len(plain) == len(placed) == len(ds) // 4
    for a, b in zip(plain, placed):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k].numpy())


def test_prefetch_batches_raises_the_workers_exception():
    def batches():
        yield {"X": np.zeros(1)}
        raise ValueError("worker failed")

    it = tds.prefetch_batches(batches())
    assert next(it)["X"].shape == (1,)
    with pytest.raises(ValueError, match="worker failed"):
        next(it)
