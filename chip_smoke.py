"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card: torch version, card name and power limit; TF32 switched off
     for matmuls and cuDNN (the savgol and temporal convs go through cuDNN).
  2. build: compile every CUDA source of the port from this checkout.
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the serving path gives it, atol 2e-5 / rtol 1e-4, with the device
     time per call (CUDA events around 50 calls queued behind a spinning
     kernel) of the kernel, the plain version and one PyTorch library call,
     the kernel's roofline share and the wrapper's host time a call.
     Untimed, the same check at edge shapes (N in {1, 17, 128, 200}, M in
     {1, 45, 128}, d in {64, 128, 256}) and with logits near +-40; a
     misaligned view must be refused.
  4. slice: the full-width model (random weights from a NumPy seed) serves
     64 synthetic clips x 240 frames against a 2048-window character
     database: featurize -> windows -> encode -> batched stream runner with
     the CVAE and both streams.  Launch counters are zeroed just before
     and read just after each of 3 timed runs; the rates are the median
     run's, with the range.
  5. parity: the same slice at 2 streams x 120 frames, deterministic,
     through the port on the GPU and on the CPU with the same weights;
     positions within 1e-3 and identical nearest-neighbour picks.
  6. cli: ``characterize.main`` in-process at full width (--random-init)
     on 64 synthetic BVH clips of 255, 215 and 175 frames (three featurize
     groups) against a 2048-window character: a warm-up, then 3 timed
     non-deterministic runs, each checked for 3 groups and for at least
     the attention launches the groups imply (counters zeroed before each
     run).  Every one of the 192 output files must read back finite with
     its own clip's frame count.  BVH parse and export are timed alone on
     the same files.  --tchunk 60 must match the monolithic run within
     1e-4 (deterministic), and --src on the GPU must match --src on the CPU
     within 1e-3 (135 frames, 256-window character).

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from mocha_sigasia2023_torch.cli import characterize  # noqa: E402
from mocha_sigasia2023_torch.data.dataset import (  # noqa: E402
    compute_norm_stats, window_xy_features)
from mocha_sigasia2023_torch.data.preprocess import featurize_clip  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_torch.data.windows import (  # noqa: E402
    padded_window_indices, window_features)
from mocha_sigasia2023_torch.io import bvh  # noqa: E402
from mocha_sigasia2023_torch.models.cvae import CVAEConfig, init_cvae  # noqa: E402
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, content_feature, init_generator)
from mocha_sigasia2023_torch.ops import attention, build  # noqa: E402
from mocha_sigasia2023_torch.runtime import export  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as rtf  # noqa: E402
from mocha_sigasia2023_torch.runtime.stream import (  # noqa: E402
    build_consts, make_batch_runner)

# H100 SXM data sheet: HBM bandwidth, dense TF32 tensor-core rate, and the
# fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
ATOL, RTOL = 2e-5, 1e-4
WINDOW_PAD = 60 // 4   # featurize yields T - window//4 windows per clip
# the slice: the JAX package's e2e bench workload (bench.py:399-530)
STREAMS, FRAMES, DB_WINDOWS = 64, 240, 2048
REPEATS = 3


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


HOLD_CYCLES = 20_000_000   # ~10 ms of a spinning kernel at H100 clocks


def time_ms(fn, calls=50, batches=5, warmup=5):
    """Device and host time of one call, in ms.  A spinning kernel holds the
    card while the host queues ``calls`` calls; CUDA events around the calls
    then time the device alone, divided by ``calls``, the median over
    ``batches`` such runs.  The host time is the wall time to queue one
    call.  A batch whose host did not finish queueing before the card was
    free would make the events time the host: it is dropped and the hold
    doubled; raises if even a 16x hold is too short."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold = torch.cuda.Event(enable_timing=True)
    dev, host = [], []
    hold_cycles = HOLD_CYCLES
    while len(dev) < batches:
        hold.record()
        torch.cuda._sleep(hold_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t_host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if t_host * 1e3 >= hold.elapsed_time(start):
            check(hold_cycles < 16 * HOLD_CYCLES,
                  f"timing: queueing {calls} calls took {t_host * 1e3:.2f} "
                  f"ms, longer than the {hold.elapsed_time(start):.2f} ms "
                  "hold")
            hold_cycles *= 2
            continue
        dev.append(start.elapsed_time(end) / calls)
        host.append(t_host * 1e3 / calls)
    return float(np.median(dev)), float(np.median(host))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (name, batch, heads, query rows, key rows, head dim)
ATTN_SHAPES = [
    ("encoder chunk", 128, 4, 90, 90, 128),
    ("decoder streams", 64, 4, 90, 90, 256),
    ("cross M=45", 64, 4, 90, 45, 256),
]


# untimed edge shapes: (batch, heads, query rows, key rows, head dim); the
# last two take two row blocks and the largest shared-memory footprint
ATTN_EDGE_SHAPES = ([(2, 3, n, m, d) for n in (1, 17) for m in (1, 45, 128)
                     for d in (64, 128, 256)]
                    + [(2, 3, 200, 128, 64), (2, 3, 128, 128, 256)])
# q x 8 puts the logits near +-40.  There the fp32 plain version is itself
# about 3e-5 from float64 at the largest of the 5.9M outputs of a full
# decoder call, so the checked case has the edge shapes' 6 heads; the full
# batch is measured against float64 and reported.
LARGE_LOGIT_Q_SCALE = 8.0
LARGE_LOGIT_HEADS = (2, 3)
DESIGN = ("one CTA per (batch, head) for N <= 96; q|k then v staged in "
          "32-column chunks by TMA (128-byte swizzle) through a 3-stage "
          "mbarrier ring; q k^T and P v as 3xTF32 mma.sync.m16n8k8 with fp32 "
          "accumulation; softmax and P in registers")


def attention_bound_ms(b, h, n, m, d):
    """Least time for the call on an H100 SXM: each input read once and the
    output written once at the HBM rate, against the two products
    (4*B*H*N*M*d operations) at the dense TF32 tensor-core rate plus the
    softmax (scale, max, exp and divide per logit) at the fp32 rate."""
    nbytes = 4 * (b * h * n * d * 2 + b * h * m * d * 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = (4 * b * h * n * m * d / PEAK_TF32_FLOPS
             + 4 * b * h * n * m / PEAK_FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def head_views(rng, b, h, n, m, d, dev):
    """q, k, v as the serving path hands them over: (B, N, H, d)
    projections viewed as (B, H, N, d)."""
    def make(rows_):
        return torch.as_tensor(rng.standard_normal(
            (b, rows_, h, d)).astype(np.float32), device=dev).transpose(1, 2)
    return make(n), make(m), make(m)


def check_attention(name, q, k, v, scale):
    """The kernel against its plain version; returns (max abs, max rel)."""
    out = attention.fused_attention(q, k, v, scale=scale)
    ref = attention.attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    check(bool(torch.isfinite(out).all()), f"attention {name}: non-finite")
    check(bool((err <= ATOL + RTOL * ref.abs()).all()),
          f"attention {name}: max abs err {max_abs:.3e} exceeds atol "
          f"{ATOL} + rtol {RTOL}")
    return max_abs, max_rel


def attention_edge_checks(dev):
    """Edge shapes, large logits and a refused misaligned view, untimed;
    returns the largest abs error seen."""
    rng = np.random.RandomState(1)
    worst = 0.0
    for b, h, n, m, d in ATTN_EDGE_SHAPES:
        q, k, v = head_views(rng, b, h, n, m, d, dev)
        max_abs, _ = check_attention(f"N={n},M={m},d={d}", q, k, v,
                                     d ** -0.5)
        worst = max(worst, max_abs)
    log(f"[kernel] attention: {len(ATTN_EDGE_SHAPES)} edge shapes within "
        f"atol {ATOL} / rtol {RTOL}, max abs {worst:.3e}")
    _, b, h, n, m, d = ATTN_SHAPES[1]
    for heads in (LARGE_LOGIT_HEADS, (b, h)):
        q, k, v = head_views(rng, *heads, n, m, d, dev)
        q = q * LARGE_LOGIT_Q_SCALE
        logits = torch.einsum("bhnd,bhmd->bhnm", q.double(),
                              k.double()) * d ** -0.5
        exact = torch.softmax(logits, -1) @ v.double()
        out = attention.fused_attention(q, k, v, scale=d ** -0.5)
        plain = attention.attention_reference(q, k, v, d ** -0.5)
        outside = int(((out - plain).abs() > ATOL + RTOL * plain.abs()).sum())
        log(f"[kernel] attention large logits (B*H={heads[0] * heads[1]}, "
            f"N=M={n}, d={d}, q x {LARGE_LOGIT_Q_SCALE:g}, logits "
            f"{float(logits.min()):.1f} to {float(logits.max()):.1f}): max "
            f"abs vs float64: kernel {float((out - exact).abs().max()):.3e}, "
            f"plain {float((plain - exact).abs().max()):.3e}; kernel vs plain"
            f" {float((out - plain).abs().max()):.3e}, {outside} of "
            f"{out.numel()} outside atol {ATOL} / rtol {RTOL}")
        if heads == LARGE_LOGIT_HEADS:
            max_abs, _ = check_attention("large logits", q, k, v, d ** -0.5)
            worst = max(worst, max_abs)
    flat = torch.empty(b * n * h * d + 1, device=dev)[1:]
    bad = flat.view(b, n, h, d).transpose(1, 2)   # 4 bytes off alignment
    before = attention.fused_attention.launches
    try:
        attention.fused_attention(bad, k, v, scale=d ** -0.5)
    except ValueError as e:
        log(f"[kernel] attention: misaligned view refused ({e})")
    else:
        raise RuntimeError("attention: a misaligned view was not refused")
    check(attention.fused_attention.launches == before,
          "attention: the refused call counted a launch")
    return worst


def tensor_map_encode_us(q, box_rows, calls=2000):
    """Host time of one cuTensorMapEncodeTiled, as the kernel's C entry
    calls it three times a launch: q's (B, H, N, d) view as a 4-D fp32 map,
    [box_rows x 32] boxes, 128-byte swizzle.  None if the driver call
    fails."""
    enc = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    enc.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                     ctypes.c_void_p, u64p, u64p, u32p, u32p]
                    + [ctypes.c_int] * 4)
    enc.restype = ctypes.c_int
    buf = (ctypes.c_ubyte * 192)()          # a 64-byte-aligned CUtensorMap
    tmap = (ctypes.addressof(buf) + 63) // 64 * 64
    b, h, n, d = q.shape
    dims = (ctypes.c_uint64 * 4)(d, n, h, b)
    strides = (ctypes.c_uint64 * 3)(*(4 * q.stride(i) for i in (2, 1, 0)))
    box = (ctypes.c_uint32 * 4)(32, box_rows, 1, 1)
    unit = (ctypes.c_uint32 * 4)(1, 1, 1, 1)
    # FLOAT32 = 7, rank 4, INTERLEAVE_NONE, SWIZZLE_128B = 3,
    # L2_PROMOTION_L2_256B = 3, FLOAT_OOB_FILL_NONE
    args = (tmap, 7, 4, q.data_ptr(), dims, strides, box, unit, 0, 3, 3, 0)
    if enc(*args) != 0:
        return None
    t0 = time.perf_counter()
    for _ in range(calls):
        enc(*args)
    return (time.perf_counter() - t0) / calls * 1e6


def kernel_phase(dev):
    rng = np.random.RandomState(0)
    rows = []
    for name, b, h, n, m, d in ATTN_SHAPES:
        q, k, v = head_views(rng, b, h, n, m, d, dev)
        scale = d ** -0.5
        max_abs, max_rel = check_attention(name, q, k, v, scale)
        ms, host_ms = time_ms(
            lambda: attention.fused_attention(q, k, v, scale=scale))
        plain_ms, _ = time_ms(
            lambda: attention.attention_reference(q, k, v, scale))
        lib_ms, _ = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound_ms(b, h, n, m, d)
        encode_us = tensor_map_encode_us(q, 96)
        row = {"shape": name, "B": b, "H": h, "N": n, "M": m, "d": d,
               "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "roofline_share": bound_ms / ms, "host_ms": host_ms,
               "tensor_map_encode_us": encode_us}
        log(f"[kernel] attention {name} (B={b},H={h},N={n},M={m},d={d}): "
            f"max abs {max_abs:.3e} max rel {max_rel:.3e} | kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), roofline share "
            f"{bound_ms / ms:.3f}; host {1e3 * host_ms:.1f} us a call, of "
            f"which 3 tensor-map encodes take "
            + ("(not measured)" if encode_us is None
               else f"{3 * encode_us:.2f} us"))
        rows.append(row)
    edge_max_abs = attention_edge_checks(dev)
    torch.cuda.synchronize()
    return rows, edge_max_abs


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------


def character_setup(gen, db_windows, dev):
    """Norm stats and session constants from one synthetic character clip
    (demo mode: no dataset), as the JAX package's e2e benchmark does."""
    cha_clip = make_mocha_bvh_data(T=db_windows + WINDOW_PAD, seed=10_000,
                                   walk_speed=60.0)
    feats = featurize_clip(
        torch.as_tensor(cha_clip["rotations"], dtype=torch.float32, device=dev),
        torch.as_tensor(cha_clip["positions"], dtype=torch.float32, device=dev),
        cha_clip["order"], cha_clip["names"], cha_clip["parents"])
    w = window_features(feats, 60, 10, padded=False)
    X, Y, root = window_xy_features(w["rotations"], w["positions"],
                                    w["velocities"], w["angular_velocities"],
                                    feats["bone_parents"])
    norm = compute_norm_stats(X.cpu().numpy(), Y.cpu().numpy(),
                              root.cpu().numpy())
    cha = rtf.clip_stream_features_device(cha_clip, gen, norm, device=dev)
    cnt_norm = rtf.compute_cnt_norm(cha["encoded"], cha["cnt"])
    consts = build_consts(norm, cnt_norm, None, cha, device=dev)
    return norm, consts, cha["bone_parents"]


def run_slice(gen, cvae, norm, consts, parents, clips, dev, *,
              deterministic, root_dtype, seed=7, keep_encoded=False):
    runner = make_batch_runner(gen, cvae, consts, parents,
                               deterministic=deterministic,
                               root_dtype=root_dtype, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    frame0, xs = rtf.batch_stream_features_device(clips, gen, norm,
                                                  emit_cnt=False, device=dev)
    sync(dev)
    t1 = time.perf_counter()
    out = runner(frame0, xs, None if deterministic else generator)
    sync(dev)
    t2 = time.perf_counter()
    if keep_encoded:   # (frames, streams, tokens, dim), for NN-pick gaps
        out["encoded"] = torch.cat([frame0["encoded"][None], xs["encoded"]])
    return out, t1 - t0, t2 - t1


def nn_gaps(consts, encoded, picks_a, picks_b):
    """Per query window: squared distance to database pick a minus that to
    pick b, as the matcher scores them (runtime/matching.py)."""
    cnt = content_feature(encoded)
    q = ((cnt - consts.cnt_mean) / consts.cnt_std).reshape(len(cnt), -1)
    d2 = consts.cha_cnt_sq - 2.0 * q @ consts.cha_cnt_flat.T
    rows = torch.arange(len(cnt))
    return (d2[rows, picks_a] - d2[rows, picks_b]).tolist()


def check_outputs(out, T, S, J=25):
    shapes = {"src_pos": (T, S, J, 3), "trans_pos": (T, S, J, 3),
              "ik_pos": (T, S, J, 3), "cm_pos": (T, S, J, 3),
              "trans_rot": (T, S, J, 4), "ik_rot": (T, S, J, 4),
              "cm_rot": (T, S, J, 4), "nn_index": (T, S)}
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape,
              f"output {k} has shape {tuple(out[k].shape)}, want {shape}")
        check(bool(torch.isfinite(out[k].float()).all()),
              f"output {k} is not finite")


def slice_phase(cfg, cvae_cfg, dev, *, streams, frames, db_windows, repeats):
    gen = init_generator(cfg, seed=0, device=dev)
    cvae = init_cvae(cvae_cfg, seed=1, device=dev)
    t0 = time.perf_counter()
    norm, consts, parents = character_setup(gen, db_windows, dev)
    sync(dev)
    log(f"[slice] character database: {consts.cha_encoded.shape[0]} windows "
        f"in {time.perf_counter() - t0:.2f} s")
    clips = [make_mocha_bvh_data(T=frames + WINDOW_PAD, seed=i)
             for i in range(streams)]
    run_slice(gen, cvae, norm, consts, parents, clips, dev,
              deterministic=False, root_dtype=torch.float32)   # warm-up
    n_chunks = -(-streams * frames // 128)
    expected = (n_chunks * cfg.encoder_depth
                + ((frames - 1) * 2 + 1) * cfg.decoder_depth)
    runs = []
    for r in range(repeats):
        attention.fused_attention.launches = 0
        out, t_feat, t_run = run_slice(gen, cvae, norm, consts, parents,
                                       clips, dev, deterministic=False,
                                       root_dtype=torch.float32, seed=100 + r)
        launches = attention.fused_attention.launches
        check_outputs(out, frames, streams)
        log(f"[slice] repeat {r}: featurize+encode {t_feat:.3f} s, stream "
            f"runner {t_run:.3f} s, attention launches {launches}")
        check(launches >= expected,
              f"attention kernel launched {launches} times on the main path,"
              f" expected at least {expected}")
        runs.append((t_feat + t_run, t_feat, t_run, launches))
    # host time varies run to run: report the median repeat and the range
    runs.sort()
    total, t_feat, t_run, launches = runs[len(runs) // 2]
    n = streams * frames
    result = {"streams": streams, "frames": frames, "repeats": repeats,
              "database_windows": int(consts.cha_encoded.shape[0]),
              "featurize_encode_s": t_feat, "runner_s": t_run,
              "e2e_frames_per_s": n / total,
              "e2e_frames_per_s_range": [n / runs[-1][0], n / runs[0][0]],
              "step_loop_frames_per_s": n / t_run,
              "step_loop_frames_per_s_range": [
                  n / max(r[2] for r in runs), n / min(r[2] for r in runs)],
              "attention_launches": launches,
              "expected_launches_at_least": expected}
    log(f"[slice] {json.dumps(result)}")
    return result, launches


def parity_phase(cfg, cvae_cfg, dev, *, streams=2, frames=120,
                 db_windows=256):
    cpu = torch.device("cpu")
    outs, cpu_consts = {}, None
    for d in (dev, cpu):
        gen = init_generator(cfg, seed=0, device=d)
        cvae = init_cvae(cvae_cfg, seed=1, device=d)
        norm, consts, parents = character_setup(gen, db_windows, d)
        clips = [make_mocha_bvh_data(T=frames + WINDOW_PAD, seed=50 + i)
                 for i in range(streams)]
        out, _, _ = run_slice(gen, cvae, norm, consts, parents, clips, d,
                              deterministic=True, root_dtype=torch.float64,
                              keep_encoded=True)
        outs[d.type] = {k: v.cpu() for k, v in out.items()}
        cpu_consts = consts
    g, c = outs[dev.type], outs["cpu"]
    check_outputs(g, frames, streams)
    if not torch.equal(g["nn_index"], c["nn_index"]):
        bad = (g["nn_index"] != c["nn_index"]).nonzero()
        gaps = nn_gaps(cpu_consts, c["encoded"][bad[:, 0], bad[:, 1]],
                       g["nn_index"][bad[:, 0], bad[:, 1]],
                       c["nn_index"][bad[:, 0], bad[:, 1]])
        log(f"[parity] NN picks differ at (frame, stream) {bad.tolist()}; "
            f"distance gaps GPU-pick minus CPU-pick, scored on the CPU: "
            f"{gaps}")
        raise RuntimeError(f"parity: NN picks differ between GPU and CPU at "
                           f"{len(bad)} (frame, stream)s")
    errs = {k: float((g[k] - c[k]).abs().max())
            for k in ("src_pos", "trans_pos", "ik_pos", "cm_pos")}
    log(f"[parity] GPU vs CPU, {streams} streams x {frames} frames: "
        f"max abs position error {json.dumps(errs)}; NN picks identical")
    check(max(errs.values()) <= 1e-3, f"parity: positions differ {errs}")
    return errs


# ---------------------------------------------------------------------------
# the characterize CLI
# ---------------------------------------------------------------------------

# 64 BVH clips in three raw lengths (three featurize groups), a character
# of 2048 windows; full width from the port's configs/config.yaml
CLI_LENGTHS = (255, 215, 175)
CLI_CLIPS = 64
CLI_REPEATS = 3
CLI_PARITY_FRAMES, CLI_PARITY_DB = 135, 256
GROUPS_LINE = re.compile(r"featurize\+encode: (\d+) group")


def write_cli_inputs(root, lengths, db_windows, first_seed):
    """Synthetic source clips (one per entry of ``lengths``) and a
    character clip, as BVH files; returns (src dir, character path)."""
    src = os.path.join(root, "src")
    os.makedirs(src, exist_ok=True)
    for i, T in enumerate(lengths):
        bvh.save(os.path.join(src, f"clip_{i:02d}.bvh"),
                 make_mocha_bvh_data(T=T, seed=first_seed + i))
    cha = os.path.join(root, "cha.bvh")
    bvh.save(cha, make_mocha_bvh_data(T=db_windows + WINDOW_PAD, seed=10_000,
                                      walk_speed=60.0))
    return src, cha


def run_cli(args):
    """``characterize.main(args)`` with its printout captured; returns
    (outputs, wall seconds, the number of featurize groups it reported, the
    attention launches during the call)."""
    attention.fused_attention.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = characterize.main(args)
    wall = time.perf_counter() - t0      # outputs are host arrays: synced
    launches = attention.fused_attention.launches
    m = GROUPS_LINE.search(buf.getvalue())
    return out, wall, (int(m.group(1)) if m else None), launches


def read_outputs(out_dir):
    """Every BVH the CLI wrote: {file name: loaded dict}."""
    return {f: bvh.load(os.path.join(out_dir, f))
            for f in sorted(os.listdir(out_dir))}


def cli_phase(cfg, dev, root, *, clips=CLI_CLIPS, db_windows=DB_WINDOWS,
              repeats=CLI_REPEATS, config=None):
    """Phase 6.  ``config`` (a config file for ``cfg``) defaults to the
    port's own, which has the full widths."""
    lengths = [CLI_LENGTHS[i % len(CLI_LENGTHS)] for i in range(clips)]
    src, cha = write_cli_inputs(root, lengths, db_windows, first_seed=200)
    n_w = [len(padded_window_indices(L, 60, 1)[0]) for L in lengths]
    frames = sum(n_w)
    cfg_args = ["--config", config] if config else []
    base = ["--src-dir", src, "--cha", cha, "--random-init",
            "--device", dev.type] + cfg_args

    def args(out, *extra):
        return base + ["--out", os.path.join(root, out), *extra]

    group_sizes = {L: lengths.count(L) for L in set(lengths)}
    group_nw = {L: n for L, n in zip(lengths, n_w)}
    expected = (sum(-(-S * group_nw[L] // 128) for L, S in group_sizes.items())
                * cfg.encoder_depth
                + ((max(n_w) - 1) * 2 + 1) * cfg.decoder_depth)

    run_cli(args("warmup"))
    runs = []
    for r in range(repeats):
        out, wall, n_groups, launches = run_cli(
            args(f"run{r}", "--seed", str(100 + r)))
        log(f"[cli] repeat {r}: main() {wall:.3f} s for {frames} frames, "
            f"{n_groups} groups, attention launches {launches}")
        check(n_groups == len(CLI_LENGTHS),
              f"cli: {n_groups} featurize groups, want {len(CLI_LENGTHS)}")
        check(launches >= expected,
              f"cli: attention launched {launches} times, expected at least "
              f"{expected}")
        runs.append((wall, launches))

    # every output: present, readable, finite, its own clip's frame count
    outs = read_outputs(os.path.join(root, "run0"))
    check(len(outs) == 3 * clips, f"cli: {len(outs)} output files")
    counts = []
    for i, n in enumerate(n_w):
        for prefix in ("Src_", "Ours_", "CM_"):
            name = (f"Src_clip_{i:02d}.bvh" if prefix == "Src_"
                    else f"{prefix}clip_{i:02d}_To_cha.bvh")
            check(name in outs, f"cli: {name} was not written")
            d = outs[name]
            check(d["rotations"].shape[0] == n,
                  f"cli: {name} has {d['rotations'].shape[0]} frames, want "
                  f"{n}")
            check(bool(np.isfinite(d["rotations"]).all()
                       and np.isfinite(d["positions"]).all()),
                  f"cli: {name} is not finite")
            counts.append(d["rotations"].shape[0])
    check(len(set(counts)) > 1, "cli: every clip has the longest clip's "
          "frame count")

    # BVH parse and export, timed alone on the same files
    t0 = time.perf_counter()
    loaded = [bvh.load(os.path.join(src, f)) for f in sorted(os.listdir(src))]
    bvh.load(cha)
    parse_s = time.perf_counter() - t0
    parents = np.concatenate([[-1], np.asarray(loaded[0]["parents"]) + 1])
    export_dir = os.path.join(root, "export")
    os.makedirs(export_dir)
    t0 = time.perf_counter()
    for i, n in enumerate(n_w):
        for key in ("src", "ik", "cm"):
            export.save_characterized_bvh(
                os.path.join(export_dir, f"{key}_{i:02d}.bvh"),
                out[f"{key}_pos"][:n, i], out[f"{key}_rot"][:n, i], parents,
                loaded[0]["names"])
    export_s = time.perf_counter() - t0

    # --tchunk against the monolithic run, deterministic
    _, mono_s, _, _ = run_cli(args("mono", "--deterministic"))
    _, chunk_s, _, _ = run_cli(args("tchunk", "--deterministic",
                                    "--tchunk", "60"))
    mono = read_outputs(os.path.join(root, "mono"))
    chunked = read_outputs(os.path.join(root, "tchunk"))
    check(sorted(mono) == sorted(chunked), "cli: --tchunk wrote other files")
    tchunk_err = max(float(np.abs(chunked[f][k] - mono[f][k]).max())
                     for f in mono for k in ("rotations", "positions"))
    log(f"[cli] --tchunk 60 vs monolithic, deterministic: max abs "
        f"{tchunk_err:.3e} over {len(mono)} files (monolithic {mono_s:.3f} s,"
        f" chunked {chunk_s:.3f} s)")
    check(tchunk_err <= 1e-4, f"cli: --tchunk differs by {tchunk_err:.3e}")

    parity = cli_parity(root, dev, cfg_args)

    runs.sort()
    wall, launches = runs[len(runs) // 2]
    result = {"clips": clips, "raw_lengths": list(CLI_LENGTHS),
              "frames": frames, "database_windows": db_windows,
              "repeats": repeats, "main_s": wall,
              "cli_frames_per_s": frames / wall,
              "cli_frames_per_s_range": [frames / runs[-1][0],
                                         frames / runs[0][0]],
              "bvh_parse_s": parse_s, "bvh_files_parsed": len(loaded) + 1,
              "export_s": export_s, "bvh_files_written": 3 * clips,
              "parse_export_share": (parse_s + export_s) / wall,
              "featurize_groups": len(CLI_LENGTHS),
              "attention_launches": launches,
              "expected_launches_at_least": expected,
              "tchunk_max_abs": tchunk_err, "parity": parity}
    log(f"[cli] {json.dumps(result)}")
    return result, launches


def cli_parity(root, dev, extra):
    """``--src``, deterministic, through main() on ``dev`` and on the CPU
    with the same seeded weights: the four output streams compared."""
    d = os.path.join(root, "parity")
    src, cha = write_cli_inputs(d, [CLI_PARITY_FRAMES], CLI_PARITY_DB,
                                first_seed=300)
    clip = os.path.join(src, "clip_00.bvh")
    outs = []
    for name in (dev.type, "cpu"):
        out, _, _, _ = run_cli(
            ["--src", clip, "--cha", cha, "--random-init", "--deterministic",
             "--device", name, "--out", os.path.join(d, name), *extra])
        outs.append(out)
    g, c = outs
    errs = {k: float(np.abs(g[k] - c[k]).max())
            for k in ("src_pos", "trans_pos", "ik_pos", "cm_pos")}
    same_picks = bool(np.array_equal(g["nn_index"], c["nn_index"]))
    log(f"[cli] --src parity {dev.type} vs cpu, {len(g['src_pos'])} frames: "
        f"max abs "
        f"position error {json.dumps(errs)}; NN picks identical: "
        f"{same_picks}")
    check(max(errs.values()) <= 1e-3, f"cli parity: positions differ {errs}")
    return {"max_abs_position_err": errs, "nn_picks_identical": same_picks}


def build_phase():
    t0 = time.perf_counter()
    attention.load_library()
    info = build.BUILD_INFO[attention.SOURCE]
    log(f"[build] {attention.SOURCE}: {info['seconds']:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        log(f"[build]   {line}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    build_phase()
    attn_rows, edge_max_abs = kernel_phase(dev)

    cfg = GeneratorConfig()
    cvae_cfg = CVAEConfig(output_seq=cfg.num_tokens)
    slice_result, launches = slice_phase(
        cfg, cvae_cfg, dev, streams=STREAMS, frames=FRAMES,
        db_windows=DB_WINDOWS, repeats=REPEATS)
    lo, hi = slice_result["e2e_frames_per_s_range"]
    log(f"[slice] median of {REPEATS}: e2e "
        f"{slice_result['e2e_frames_per_s']:.1f} frames/s (range {lo:.1f}-"
        f"{hi:.1f}), step loop {slice_result['step_loop_frames_per_s']:.1f} "
        f"frames/s on {card}")

    parity_phase(cfg, cvae_cfg, dev)

    with tempfile.TemporaryDirectory() as root:
        cli_result, cli_launches = cli_phase(cfg, dev, root)
    lo, hi = cli_result["cli_frames_per_s_range"]
    log(f"[cli] median of {CLI_REPEATS}: {cli_result['cli_frames_per_s']:.1f}"
        f" frames/s through main() (range {lo:.1f}-{hi:.1f}), slice e2e "
        f"{slice_result['e2e_frames_per_s']:.1f} frames/s; BVH parse "
        f"{cli_result['bvh_parse_s']:.3f} s + export "
        f"{cli_result['export_s']:.3f} s = "
        f"{cli_result['parse_export_share']:.3f} of main(); on {card}")

    main_row = next(r for r in attn_rows if r["shape"] == "decoder streams")
    kernels = [{
        "name": "attention",
        "route": "cuda",
        "source": "mocha_sigasia2023_torch/ops/csrc/attention.cu",
        "replaces": "mocha_sigasia2023_tpu/ops/attention.py:37",
        "launches": launches,
        "launches_by_path": {"slice": launches, "cli": cli_launches},
        "max_abs_err": max([r["max_abs_err"] for r in attn_rows]
                           + [edge_max_abs]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "roofline_share": main_row["roofline_share"],
        "design": DESIGN,
        "shapes": attn_rows,
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
