"""The port's training building blocks against the JAX package, on the CPU:
the losses (value and jax.grad), the projector in its five modes and its
two converters, the safe global-norm clip; and the port's own training
rules: fused_attention refuses inputs that need a gradient, training
forwards take the plain attention path with dropout, serving forwards
still reach the kernel wrapper.

Bars, from tests/test_train.py:37-86: recon_criterion rtol 1e-4;
convert_YtilToX atol 2e-4 / rtol 1e-3; patch_nce_loss rtol 1e-4 (logits
atol 1e-4); contrastive_acc atol 1e-5; kl_normal rtol 1e-5.  Gradients
within rtol 1e-4 / atol 1e-5 x the largest (tests/test_train.py:210).
The projector within 1e-5; the clip within float32 rounding (rtol 1e-6),
zeros exactly when the norm is not finite."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import convert as jconvert  # noqa: E402
from mocha_sigasia2023_tpu.models import projector as jprj  # noqa: E402
from mocha_sigasia2023_tpu.ops import numerics as jnum  # noqa: E402
from mocha_sigasia2023_tpu.train import losses as jlosses  # noqa: E402

from mocha_sigasia2023_torch.models import convert  # noqa: E402
from mocha_sigasia2023_torch.models import generator as tgen  # noqa: E402
from mocha_sigasia2023_torch.models import layers as tlayers  # noqa: E402
from mocha_sigasia2023_torch.models import projector as tprj  # noqa: E402
from mocha_sigasia2023_torch.ops import attention as tattn  # noqa: E402
from mocha_sigasia2023_torch.ops import numerics as tnum  # noqa: E402
from mocha_sigasia2023_torch.train import losses as tlosses  # noqa: E402

torch.set_num_threads(2)
PARENTS = np.asarray([-1, 0, 1, 2, 3, 4, 1, 6, 7, 8, 9, 10, 11, 12, 9, 14,
                      15, 9, 17, 18, 19, 1, 21, 22, 23])
SMALL_GEN = dict(encoder_dim=32, decoder_dim=32, encoder_heads=2,
                 encoder_dim_head=16, decoder_heads=2, decoder_dim_head=16,
                 encoder_mlp_dim=64, decoder_mlp_dim=64, encoder_depth=2,
                 decoder_depth=1)


def _grad_close(tg, jg):
    jg = np.asarray(jg)
    np.testing.assert_allclose(np.asarray(tg), jg, rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))


def _both(fn_j, fn_t, arrays):
    """(JAX value, port value, JAX grads, port grads) of fn over float32
    ``arrays``; the gradient is of a fixed random projection of the
    output."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout, tout = fn_j(*jargs), fn_t(*targs)
    w = np.asarray(np.random.RandomState(9).randn(*np.shape(jout)),
                   np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(fn_j(*a) * w),
                      argnums=tuple(range(len(arrays))))(*jargs)
    torch.sum(tout * torch.as_tensor(w)).backward()
    return (np.asarray(jout), tout.detach().numpy(), jgrads,
            [t.grad for t in targs])


def test_recon_criterion_matches_jax():
    rng = np.random.RandomState(0)
    B, T, J = 2, 8, 25
    pred = rng.randn(B, T, J - 1, 15).astype(np.float32)
    gt = rng.randn(B, T, J, 15).astype(np.float32)
    jv, tv, jg, tg = _both(
        lambda p, g: jlosses.recon_criterion(p, g, PARENTS),
        lambda p, g: tlosses.recon_criterion(p, g, PARENTS), [pred, gt])
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    for a, b in zip(tg, jg):
        _grad_close(a, b)


def test_recon_criterion_compute_dtype_float64():
    """A float64 tail returns the input's dtype and agrees with float32."""
    rng = np.random.RandomState(1)
    pred = torch.as_tensor(rng.randn(2, 6, 24, 15).astype(np.float32))
    gt = torch.as_tensor(rng.randn(2, 6, 25, 15).astype(np.float32))
    a = tlosses.recon_criterion(pred, gt, PARENTS)
    b = tlosses.recon_criterion(pred, gt, PARENTS,
                                compute_dtype=torch.float64)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(float(b), float(a), rtol=1e-5)


def test_convert_YtilToX_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 6, 24, 15).astype(np.float32)
    root = rng.randn(2, 6, 1, 15).astype(np.float32)
    jv, tv, jg, tg = _both(
        lambda p, r: jlosses.convert_YtilToX(p, r, PARENTS),
        lambda p, r: tlosses.convert_YtilToX(p, r, PARENTS), [pred, root])
    np.testing.assert_allclose(tv, jv, atol=2e-4, rtol=1e-3)
    for a, b in zip(tg, jg):
        _grad_close(a, b)


def test_patch_nce_loss_matches_jax():
    rng = np.random.RandomState(3)
    q = rng.randn(64, 32).astype(np.float32)
    k = rng.randn(64, 32).astype(np.float32)
    jloss, jlogits = jlosses.patch_nce_loss(jnp.asarray(q), jnp.asarray(k))
    tloss, tlogits = tlosses.patch_nce_loss(torch.as_tensor(q),
                                            torch.as_tensor(k))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    jv, tv, jg, tg = _both(
        lambda a, b: jlosses.patch_nce_loss(a, b)[0],
        lambda a, b: tlosses.patch_nce_loss(a, b)[0], [q, k])
    _grad_close(tg[0], jg[0])
    # the keys carry no gradient, in both packages
    assert not np.any(np.asarray(jg[1])) and tg[1] is None


def test_contrastive_acc_matches_jax():
    logits = np.random.RandomState(0).randn(40, 10).astype(np.float32)
    logits[:5, 0] = logits[:5, 1]          # ties
    want = jlosses.contrastive_acc(jnp.asarray(logits))
    got = tlosses.contrastive_acc(torch.as_tensor(logits))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)


def test_kl_normal_matches_jax():
    rng = np.random.RandomState(3)
    arrays = [rng.randn(4, 8).astype(np.float32),
              (rng.randn(4, 8) * 0.3).astype(np.float32),
              rng.randn(4, 8).astype(np.float32),
              (rng.randn(4, 8) * 0.3).astype(np.float32)]
    jv, tv, jg, tg = _both(jlosses.kl_normal, tlosses.kl_normal, arrays)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for a, b in zip(tg, jg):
        _grad_close(a, b)


# ---------------------------------------------------------------------------
# Projector
# ---------------------------------------------------------------------------

PRJ_WIDTHS = dict(encoder_dim=16, prj_dim=8, hidden=32)


@pytest.mark.parametrize("mode", ["all", "spatial", "temp", "style",
                                  "no_patches"])
def test_projector_modes_match_jax(mode):
    jcfg = jprj.ProjectorConfig(mode=mode, **PRJ_WIDTHS)
    tcfg = tprj.ProjectorConfig(mode=mode, **PRJ_WIDTHS)
    params = jax.tree.map(np.asarray, jprj.init_projector(
        jax.random.PRNGKey(5), jcfg))
    prj = convert.projector_from_jax(params, tcfg, device="cpu")
    feat = np.random.RandomState(4).randn(3, 90, 16).astype(np.float32)
    ids = [None]
    if mode in ("all", "spatial", "temp"):
        n = 90 // jcfg.m_dim
        ids.append(np.random.RandomState(6).permutation(n)[: n // 2])
    for pid in ids:
        want, _ = jprj.apply_projector(
            params, jcfg, jnp.asarray(feat),
            None if pid is None else jnp.asarray(pid))
        got, got_id = tprj.apply_projector(
            prj, tcfg, torch.as_tensor(feat),
            None if pid is None else torch.as_tensor(pid))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    if mode == "all":
        # with a generator the patches are a seeded permutation, truncated
        # to num_patches
        cut = tcfg._replace(num_patches=7)
        g = torch.Generator().manual_seed(3)
        _, a = tprj.sample_patches(cut, torch.as_tensor(feat), generator=g)
        _, b = tprj.sample_patches(cut, torch.as_tensor(feat),
                                   generator=torch.Generator().manual_seed(3))
        assert a.tolist() == b.tolist() and len(set(a.tolist())) == 7


def test_projector_from_torch_matches_jax_converter():
    rng = np.random.RandomState(7)
    sd = {"module.mlp.0.weight": rng.randn(1024, 256),
          "module.mlp.0.bias": rng.randn(1024),
          "module.mlp.2.weight": rng.randn(1024, 1024),
          "module.mlp.2.bias": rng.randn(1024)}
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}
    want = jconvert.projector_from_torch(sd)
    got = convert.projector_from_torch(sd, device="cpu").state_dict()
    assert set(got) == set(convert.flatten_pytree(want))
    for k, v in convert.flatten_pytree(want).items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(ValueError, match="dropped"):
        convert.projector_from_torch(dict(sd, extra=torch.zeros(1)),
                                     device="cpu")


# ---------------------------------------------------------------------------
# safe_clip_by_global_norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["under", "over", "inf", "nan"])
def test_safe_clip_matches_jax(case):
    rng = np.random.RandomState(8)
    grads = [rng.randn(5, 3).astype(np.float32) * 0.05,
             rng.randn(7).astype(np.float32) * 0.05]
    if case == "over":
        grads = [g * 100.0 for g in grads]
    elif case in ("inf", "nan"):
        grads[1][3] = np.inf if case == "inf" else np.nan
    tx = jnum.safe_clip_by_global_norm(1.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads],
                        tx.init(None))
    got = tnum.safe_clip_by_global_norm([torch.as_tensor(g) for g in grads],
                                        1.0)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads))
    for a, b, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        if case == "under":
            np.testing.assert_array_equal(a.numpy(), g)
        elif case == "over":
            np.testing.assert_allclose(a.numpy(), g / norm, rtol=1e-5)
        else:
            assert not a.any()


# ---------------------------------------------------------------------------
# Training forwards: the repair, the plain path, dropout
# ---------------------------------------------------------------------------

def test_fused_attention_refuses_inputs_that_need_a_gradient():
    q = torch.randn(1, 2, 5, 64, requires_grad=True)
    k, v = torch.randn(1, 2, 7, 64), torch.randn(1, 2, 7, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.fused_attention(q, k, v, scale=0.125)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.fused_attention(k[:, :, :5], k, v.requires_grad_(), scale=0.1)
    with torch.no_grad():
        out = tattn.fused_attention(q, k, v, scale=0.125)
    np.testing.assert_allclose(
        out.numpy(), tattn.attention_reference(q, k, v, 0.125).detach(),
        atol=1e-6)


@pytest.fixture
def counted_kernel_calls(monkeypatch):
    calls = []
    real = tlayers.fused_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tlayers, "fused_attention", counting)
    return calls


def _small_generator():
    cfg = tgen.GeneratorConfig(**SMALL_GEN)
    return tlayers.numpy_init_(tgen.Generator(cfg), 0), cfg


def test_training_forward_never_calls_the_kernel(counted_kernel_calls):
    gen, cfg = _small_generator()
    x = torch.as_tensor(np.random.RandomState(0).randn(
        2, 60, 24, 15).astype(np.float32))
    for g in (None, torch.Generator().manual_seed(1)):
        out = tgen.forward(gen, x, x, train=True, generator=g)
        out.square().mean().backward()
        assert gen.encoder.layers[0].attn.to_q.weight.grad.abs().sum() > 0
    feats = tgen.forward(gen, x, x, extract_feature=True, train=True)
    feats[2].sum().backward()
    assert counted_kernel_calls == []
    # without train, a forward that needs gradients now raises ...
    with pytest.raises(RuntimeError, match="no backward"):
        tgen.forward(gen, x, x)
    # ... and equals the training forward without dropout
    with torch.no_grad():
        served = tgen.forward(gen, x, x)
        plain = tgen.forward(gen, x, x, train=True)
    np.testing.assert_allclose(served.numpy(), plain.numpy(), atol=1e-6)


def test_serving_forward_calls_the_kernel(counted_kernel_calls):
    gen, cfg = _small_generator()
    gen.requires_grad_(False)
    x = torch.zeros(1, 60, 24, 15)
    tgen.forward(gen, x, x)
    assert len(counted_kernel_calls) == 2 * cfg.encoder_depth \
        + cfg.decoder_depth


def test_dropout_keep_rate_scale_and_seed():
    x = torch.ones(100_000)
    g = torch.Generator().manual_seed(11)
    y = tlayers.dropout(x, 0.1, g, True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.9, rtol=1e-6)
    y2 = tlayers.dropout(x, 0.1, torch.Generator().manual_seed(11), True)
    assert torch.equal(y, y2)
    y3 = tlayers.dropout(x, 0.1, torch.Generator().manual_seed(12), True)
    assert not torch.equal(y, y3)
    for args in ((0.1, g, False), (0.0, g, True), (0.1, None, True)):
        assert tlayers.dropout(x, *args) is x


def test_split_is_a_function_of_the_seed():
    g = torch.Generator().manual_seed(5)
    a = [c.initial_seed() for c in tlayers.split(g, 3)]
    torch.rand(10, generator=g)            # draws do not change the split
    b = [c.initial_seed() for c in tlayers.split(g, 3)]
    assert a == b and len(set(a)) == 3
    c = [c.initial_seed() for c in tlayers.split(
        torch.Generator().manual_seed(6), 3)]
    assert not set(a) & set(c)


def test_training_attention_places_dropout_as_jax():
    """Dropout on the attention weights and on to_out's output: with a
    generator the output changes; the dropped weights are those the
    generator's first stream draws."""
    torch.manual_seed(0)
    p = tlayers.attention_params(8, 2, 4)
    x = torch.randn(2, 5, 8)
    g = torch.Generator().manual_seed(2)
    got = tlayers.attention(p, x, heads=2, drop=0.5, generator=g,
                            train=True)
    g_attn, g_out = tlayers.split(torch.Generator().manual_seed(2), 2)
    q, k, v = (tlayers.linear(p[n], x).reshape(2, 5, 2, 4).transpose(1, 2)
               for n in ("to_q", "to_k", "to_v"))
    w = torch.softmax(q @ k.transpose(-1, -2) * 0.5, dim=-1)
    w = tlayers.dropout(w, 0.5, g_attn, True)
    o = (w @ v).transpose(1, 2).reshape(2, 5, 8)
    want = tlayers.dropout(tlayers.linear(p["to_out"], o), 0.5, g_out, True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
