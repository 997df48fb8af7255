"""The port's CVAE training path against the JAX package, on the CPU.

Small widths, as tests/test_train.py:393-523 trains the JAX trainer
(latent 32, depth 1, 2 heads, ff 64, 12 tokens, rollout 4, batch 4), with
features, norms and batches made here from NumPy seeds and weights from
the JAX initializer crossing to the port through ``convert.cvae_from_jax``.
Bars: the schedules, ``norm_artifacts``, ``sample_batch`` and the number
of learning-rate decays exact (the rate itself to float32 rounding, as
optax computes it in float32); ``posterior`` and ``forward`` without
dropout within atol 2e-5 (tests/test_models.py:178); one rollout against
JAX's ``_rollout_impl`` (reparameterization patched to mu on both sides,
dropout and condition dropout 0) within the bars of
tests/test_train.py:640-667, which hold JAX against the torch reference:
metrics rtol 2e-3 / 5e-2 / 1e-2 / 1e-2 (enc / kl / cnt / dist), the mean
|port - JAX| of the parameters under 0.2 x the mean update and the largest
under 10 lr (R - 1).  Observed in this test (CPU): metrics within 3e-7
relative, mean parameter difference 4e-4 of the mean update, the largest
8e-5 against a bar of 3e-3.  The prefetched loop equals the sync loop bit
for bit and bf16 forwards track float32 within 5% (:422-523).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.train import trainer_cvae as jtc  # noqa: E402

from mocha_sigasia2023_torch.data.dataset import (  # noqa: E402
    prefetch_batches)
from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as tcvae  # noqa: E402
from mocha_sigasia2023_torch.train import trainer_cvae as ttc  # noqa: E402

torch.set_num_threads(2)
S, D, B, R = 12, 32, 4, 4
SMALL = dict(latent_dim=D, depth=1, nheads=2, feedforward_dim=64, nseq=S,
             rollout_steps=R, batch_size=B)
MODEL_TOL = 2e-5
METRIC_RTOL = (2e-3, 5e-2, 1e-2, 1e-2)   # enc, kl, cnt, dist


def _features(seed, n=60, actions=None):
    """Source and character feature sets, cnt norms and the actions."""
    rng = np.random.RandomState(seed)
    act = np.zeros(n, np.int32) if actions is None else actions
    return dict(
        src_cnt=rng.randn(n, S, D).astype(np.float32), src_action=act,
        src_range_starts=np.array([0]), src_range_stops=np.array([n]),
        cha_cnt=rng.randn(n, S, D).astype(np.float32),
        cha_encoded=rng.randn(n, S, D).astype(np.float32),
        cha_action=act,
        cha_range_starts=np.array([0]), cha_range_stops=np.array([n]),
        cnt_mean=rng.randn(S, D).astype(np.float32),
        cnt_std=(rng.rand(S, D) + 0.5).astype(np.float32),
        target_actions=[0])


def _pair(kw, **tc):
    """The JAX trainer and the port's on the CPU, the port holding the JAX
    trainer's initial weights."""
    jt = jtc.CVAETrainer(jtc.CVAETrainerConfig(**SMALL, **tc), **kw)
    tt = ttc.CVAETrainer(ttc.CVAETrainerConfig(**SMALL, **tc), device="cpu",
                         **kw)
    init = jax.tree.map(np.array, jt.params)
    with torch.no_grad():
        tt.cvae.load_state_dict(
            convert.cvae_from_jax(init, tt.cfg, device="cpu").state_dict())
    return jt, tt, init


@pytest.mark.parametrize("args", [(15, 6, 256), (2, 6, 32, 0.5, 2.0)])
def test_temp_weight_matrix_is_jax_exactly(args):
    got = ttc.temp_weight_matrix(*args)
    want = jtc.temp_weight_matrix(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rollout_indices_and_schedule_are_jax_exactly():
    starts, stops = np.array([0, 40, 75]), np.array([40, 75, 90])
    for steps in (4, 10):
        got = ttc.rollout_indices(starts, stops, steps)
        want = jtc.rollout_indices(starts, stops, steps)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for args in ((3, 5, 2), (10000, 10000, 20000)):
        np.testing.assert_array_equal(ttc.sample_schedule(*args),
                                      jtc.sample_schedule(*args))


def test_norm_artifacts_are_jax_exactly():
    jt, tt, _ = _pair(_features(2))
    got, want = tt.norm_artifacts(), jt.norm_artifacts()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def cvaes():
    cfg = dict(output_seq=S, latent_dim=D, depth=2, nheads=2,
               feedforward_dim=64, dropout=0.0)
    jcfg = jcvae.CVAEConfig(**cfg)
    params = jcvae.init_cvae(jax.random.PRNGKey(9), jcfg)
    tc = convert.cvae_from_jax(jax.tree.map(np.array, params),
                               tcvae.CVAEConfig(**cfg), device="cpu")
    return tc, params, jcfg


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, S, D).astype(np.float32),
            rng.randn(3, 2 * S, D).astype(np.float32))


@pytest.mark.parametrize("train", [False, True])
def test_posterior_matches_jax(cvaes, train):
    """Without dropout a training forward gives the serving forward's
    values (it keeps every query row)."""
    tc, params, jcfg = cvaes
    x, c = _inputs(3)
    mu_t, lv_t = tcvae.posterior(tc, torch.as_tensor(x), torch.as_tensor(c),
                                 train=train)
    mu_j, lv_j = jcvae.posterior(params, jnp.asarray(x), jnp.asarray(c),
                                 jcfg)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j),
                               atol=MODEL_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(cvaes, monkeypatch, train):
    """The training forward with z = mu on both sides (the noise cannot be
    matched across frameworks), dropout 0."""
    tc, params, jcfg = cvaes
    monkeypatch.setattr(tcvae, "reparameterize", lambda g, mu, lv: mu)
    monkeypatch.setattr(jcvae, "reparameterize", lambda k, mu, lv: mu)
    x, c = _inputs(4)
    got = tcvae.forward(tc, torch.as_tensor(x), torch.as_tensor(c),
                        generator=torch.Generator().manual_seed(1),
                        train=train)
    want = jcvae.forward(params, jnp.asarray(x), jnp.asarray(c), jcfg,
                         key=jax.random.PRNGKey(1))
    for a, b in zip(jax.tree.leaves(want), (got[0], *got[1], *got[2])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=MODEL_TOL)


def test_reparameterize_and_dropout_follow_the_generator(cvaes):
    """The noise and the dropout masks are functions of the generator's
    seed; a training forward with dropout differs from one without."""
    tc, _, _ = cvaes
    x, c = (torch.as_tensor(a) for a in _inputs(5))
    drop = tcvae.CVAE(tc.cfg._replace(dropout=0.3))
    drop.load_state_dict(tc.state_dict())

    def run(model, seed, train=True):
        return tcvae.forward(model, x, c, train=train,
                             generator=torch.Generator().manual_seed(seed))

    a, b, other = run(drop, 3), run(drop, 3), run(drop, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
    assert not torch.equal(a[0], other[0])
    assert not torch.allclose(a[0], run(tc, 3)[0], atol=1e-3)
    mu, lv = a[1]
    z = tcvae.reparameterize(torch.Generator().manual_seed(2), mu, lv)
    z2 = tcvae.reparameterize(torch.Generator().manual_seed(2), mu, lv)
    assert torch.equal(z, z2) and not torch.equal(z, mu)
    with pytest.raises(ValueError, match="torch.Generator"):
        tcvae.reparameterize(None, mu, lv)


def _jax_schedule(jt):
    """The learning-rate schedule closed over by the JAX trainer's
    optax.adamw."""
    seen, todo = set(), [jt.tx.update]
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        if isinstance(f, (tuple, list)):
            todo.extend(f)
            continue
        if getattr(f, "__name__", "") == "lr_schedule":
            return f
        for cell in getattr(f, "__closure__", None) or ():
            try:
                todo.append(cell.cell_contents)
            except ValueError:
                pass
    raise AssertionError("no lr_schedule in the JAX optimizer")


def test_learning_rate_at_every_update_is_optax_schedule():
    """Every update count of iterations 0-2 and 199-202 (9 updates an
    iteration at the shipped rollout of 10; iteration 0 at lr, 1-200 at
    lr 0.99, 201-400 at lr 0.99^2)."""
    kw = _features(6)
    tc = dict(SMALL, rollout_steps=10, nseq=S)
    jt = jtc.CVAETrainer(jtc.CVAETrainerConfig(**tc), **kw)
    tt = ttc.CVAETrainer(ttc.CVAETrainerConfig(**tc), device="cpu", **kw)
    sched = _jax_schedule(jt)
    counts = list(range(0, 27)) + list(range(199 * 9, 203 * 9))
    for count in counts:
        want = float(sched(jnp.int32(count)))
        it = count // 9
        assert tt.n_decays(count) == (0 if it < 1 else (it - 1) // 200 + 1)
        np.testing.assert_allclose(tt.learning_rate(count), want, rtol=1e-6,
                                   err_msg=str(count))
    assert tt.learning_rate(0) == 1e-4
    np.testing.assert_allclose(tt.learning_rate(9 * 200), 0.99e-4)
    np.testing.assert_allclose(tt.learning_rate(9 * 201), 0.99 ** 2 * 1e-4)


def test_sample_batch_is_jax_exactly():
    """Six draws from one seed over two actions, one of which has too few
    source rollouts for a batch (those draws are None on both sides)."""
    n = 60
    actions = np.zeros(n, np.int32)
    actions[50:] = 1                     # 1 source rollout: underfull
    kw = dict(_features(8, n, actions), target_actions=[0, 1])
    jt = jtc.CVAETrainer(jtc.CVAETrainerConfig(**SMALL), **kw)
    tt = ttc.CVAETrainer(ttc.CVAETrainerConfig(**SMALL), device="cpu", **kw)
    kinds = []
    for it in range(6):
        got, want = tt.sample_batch(it), jt.sample_batch(it)
        kinds.append(want is None)
        if want is None:
            assert got is None, it
            continue
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert any(kinds) and not all(kinds), kinds


@pytest.mark.parametrize("student_p", [0.0, 1.0])
def test_one_rollout_matches_jax(monkeypatch, student_p):
    """Teacher-forced (student_p 0) and student-forced (1): each offset's
    condition takes the ground truth or the forward's own output."""
    monkeypatch.setattr(tcvae, "reparameterize", lambda g, mu, lv: mu)
    monkeypatch.setattr(jcvae, "reparameterize", lambda k, mu, lv: mu)
    jt, tt, init = _pair(_features(7, 40), dropout=0.0,
                         condition_dropout=0.0)
    rng = np.random.RandomState(1)
    src, enc, cnt = (rng.randn(B, R, S, D).astype(np.float32)
                     for _ in range(3))
    Dgnd = np.sqrt(((src - cnt) ** 2).sum(-1)).astype(np.float32)
    anneal_w = 0.7
    p2, _, m = jt._rollout(jt.params, jt.opt_state,
                           *map(jnp.asarray, (src, enc, cnt, Dgnd)),
                           jnp.float32(student_p), jnp.float32(anneal_w),
                           jax.random.PRNGKey(0))
    got = tt.rollout(*map(torch.as_tensor, (src, enc, cnt, Dgnd)), student_p,
                     anneal_w, torch.Generator().manual_seed(0))
    for a, b, rtol, name in zip(got.numpy(), np.asarray(m), METRIC_RTOL,
                                ("enc_l1", "kl", "cnt_l1", "dist_l1")):
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name)
    want = convert.flatten_pytree(jax.tree.map(np.array, p2))
    start = convert.flatten_pytree(init)
    state = tt.cvae.state_dict()
    assert sorted(state) == sorted(want)
    diff = np.concatenate([np.abs(state[k].numpy() - want[k]).ravel()
                           for k in want])
    upd = np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want])
    assert upd.mean() > 1e-5
    assert diff.mean() < 0.2 * upd.mean(), (diff.mean(), upd.mean())
    assert diff.max() < 10 * 1e-4 * (R - 1), diff.max()
    assert tt.updates == R - 1


def test_prefetched_loop_matches_sync_loop():
    """The CLI's loop (batch_stream -> prefetch_batches -> step_placed,
    metrics read in stacks of 3) leaves the same weights and metrics as
    train_iteration, bit for bit, dropout and condition dropout on."""
    kw = _features(11)
    tc = ttc.CVAETrainerConfig(**SMALL, teacher_iters=2, ramping_iters=2,
                               student_iters=2, kl_anneal_end=4)
    n_iters = 6
    sync = ttc.CVAETrainer(tc, device="cpu", **kw)
    sync_metrics = [sync.train_iteration(i) for i in range(n_iters)]

    pre = ttc.CVAETrainer(tc, device="cpu", **kw)

    def place(item):
        it, b = item
        return it, None if b is None else tuple(map(torch.from_numpy, b))

    pending, pre_metrics = [], {}
    for it, batch in prefetch_batches(pre.batch_stream(n_iters),
                                      place=place):
        pending.append((it, pre.step_placed(it, batch)))
        if len(pending) == 3:
            vals = torch.stack([m for _, m in pending]).numpy()
            for (i, _), v in zip(pending, vals):
                pre_metrics[i] = pre.metrics_dict(i, v)
            pending.clear()
    for i, m in pending:
        pre_metrics[i] = pre.metrics_dict(i, m)
    for k, v in sync.cvae.state_dict().items():
        assert torch.equal(v, pre.cvae.state_dict()[k]), k
    assert sync.updates == pre.updates == n_iters * (R - 1)
    for i, ms in enumerate(sync_metrics):
        assert ms == pre_metrics[i], i
        assert all(np.isfinite(v) for v in ms.values())


def test_bf16_compute_tracks_float32():
    """compute_dtype bfloat16: float32 masters, finite, the first
    iteration's losses within 5% of float32's from the same weights,
    batch and streams (tests/test_train.py:489-523)."""
    kw = _features(3)
    tc = ttc.CVAETrainerConfig(**SMALL, dropout=0.0, condition_dropout=0.0)
    t32 = ttc.CVAETrainer(tc, device="cpu", **kw)
    tbf = ttc.CVAETrainer(tc._replace(compute_dtype="bfloat16"),
                          device="cpu", **kw)
    m32, mbf = t32.train_iteration(0), tbf.train_iteration(0)
    for p in tbf.cvae.parameters():
        assert p.dtype == torch.float32
    for k in ("cvae/encoded_loss", "cvae/cnt_loss", "cvae/dist_loss"):
        a, b = m32[k], mbf[k]
        assert np.isfinite(b)
        assert abs(a - b) <= 0.05 * max(abs(a), 1.0), (k, a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        t32.cvae.parameters(), tbf.cvae.parameters()))


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttc.CVAETrainer(ttc.CVAETrainerConfig(**SMALL), **_features(1))
