"""flops.py and roofline.py against counts by hand."""

from __future__ import annotations

import json

import pytest

from portbench import flops, harness, roofline
from portbench.reference.models import graph
from portbench.tests import tiny


def tiny_config(cell="cvae-offline-64x240"):
    config = json.loads(json.dumps(harness.load_cell(cell).config))
    config["model"].update(tiny.WIDTHS)
    if config.get("cvae") is not None:
        config["cvae"].update(latent_dim=32, feedforward_dim=32)
    return config


def transformer_flops(B, n, m, dim, depth, heads, dh, mlp, adain=False,
                      style_tokens=None):
    inner = heads * dh
    per = (2 * B * n * dim * inner            # q
           + 2 * 2 * B * m * dim * inner      # k, v
           + 4 * B * heads * n * m * dh       # q k^T and P v
           + 2 * B * n * inner * dim          # to_out
           + 2 * 2 * B * n * dim * mlp)       # feed-forward
    if adain:
        per += 2 * B * dim * 2 * dim + 2 * B * 2 * dim * 2 * dim
    return depth * per


@pytest.mark.parametrize("B", [1, 5])
def test_encode_flops_by_hand(B):
    config = tiny_config()
    m = config["model"]
    e, tps, T, V, C = (m["encoder_dim"], m["temporal_patch_size"],
                       m["nframes"], m["njoints"], m["mot_in_dim"])
    U, t = m["nbody"], m["nframes"] // m["temporal_patch_size"]
    Kj = graph.joint_adjacency("mocha", "distance", 2).shape[0]
    Kb = graph.bodypart_adjacency("mocha", "distance", 1).shape[0]
    c0 = e // tps
    k = 5 + tps - 1                       # the mean-pool folded taps
    hand = (2 * B * T * V * C * c0                    # conv_in
            + 2 * B * T * V * c0 * e * Kj             # joint graph conv
            + 2 * B * e * T * U * Kj * V              # joint adjacency
            + 2 * e * e * k * 5                       # folding the taps
            + 2 * B * e * e * k * t * U               # strided temporal conv
            + 2 * B * t * U * e * e * Kb              # body graph conv
            + 2 * B * e * t * U * Kb * U              # body adjacency
            + 2 * B * e * e * 3 * t * U               # body temporal conv
            + transformer_flops(B, t * U, t * U, e, m["encoder_depth"],
                                m["encoder_heads"], m["encoder_dim_head"],
                                m["encoder_mlp_dim"]))
    assert flops.encode_flops(config, B) == hand


def test_match_and_batch_flops_add_up():
    config = tiny_config()
    m = config["model"]
    tokens = m["nframes"] // m["temporal_patch_size"] * m["nbody"]
    assert flops.match_flops(config, 70) == 2 * tokens * m["encoder_dim"] * 70
    S, T = 3, 7
    total = flops.offline_batch_flops(config, S, T, [70] * S, chunk=4)
    full, rest = divmod(S * T, 4)
    want = (full * flops.encode_flops(config, 4)
            + flops.encode_flops(config, rest)
            + T * flops.decode_flops(config, S)
            + (T - 1) * flops.cvae_sample_flops(config, S)
            + T * S * flops.match_flops(config, 70))
    assert total == want


def test_train_step_flops_count_forward_and_backward():
    config = tiny_config("gen-train-b64")
    fwd_bwd = flops.train_step_flops(config, 2)
    # six generator forwards of 2 windows: twelve encodes at least, and the
    # backward costs about twice the forward
    assert fwd_bwd > 3 * 12 * flops.encode_flops(config, 2)


def test_attention_bound_by_hand():
    # one head, 2 queries, 2 keys, d = 4, float32: 128 bytes against
    # 64 products at the TF32 rate plus 16 softmax operations
    by_bytes = 4 * (2 * 4 * 2 + 2 * 4 * 2) / 3.35e12
    by_ops = 4 * 2 * 2 * 4 / 495e12 + 4 * 2 * 2 / 67e12
    assert roofline.attention_bound_s(1, 1, 2, 2, 4) == pytest.approx(
        max(by_bytes, by_ops), rel=1e-12)
    # the fp32 decoder of PERF.md's kernel table (0.0282 ms): q, k, v, o
    assert roofline.attention_bound_s(64, 4, 90, 90, 256) * 1e3 == \
        pytest.approx(4 * 64 * 4 * 90 * 256 * 4 / 3.35e12 * 1e3, rel=1e-12)
    # compute-bound when keys are many and d is small
    b = roofline.attention_bound_s(1, 1, 4096, 4096, 8, "bfloat16")
    assert b == pytest.approx(4 * 4096 * 4096 * 8 / 989e12
                              + 4 * 4096 * 4096 / 67e12, rel=1e-12)
