"""Drive the PyTorch/CUDA port's serving, dataset and training paths (the
generator's and the CVAE's) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its wall time):
  1. card: torch version, card name and power limit; TF32 switched off
     for matmuls and cuDNN (the savgol and temporal convs go through cuDNN).
  2. build: compile every CUDA source of the port from this checkout (the
     two tuned attention kernels and the general one), one nvcc per
     source, started together.
  3. kernels, then kernels (bf16): each instance of the attention kernel
     against its plain PyTorch version at the shapes the serving path
     gives it (float32 at atol 2e-5 / rtol 1e-4; bfloat16 compared in
     float32 at atol 8e-3 / rtol 8e-3), with the device time per call
     (CUDA events around 50 calls queued behind a spinning kernel) of the
     kernel, the plain version and one PyTorch library call (SDPA in the
     same dtype), the kernel's roofline share and the wrapper's host time
     a call.  Untimed, the same check at edge shapes (N in {1, 17, 128,
     200}, M in {1, 45, 90, 128}, d in {64, 128, 256}, and 2 * SMs + 1
     heads, one more item than the bf16 kernel's persistent grid takes in
     two rounds) and with logits near +-40; a misaligned view must go to
     the general kernel, match the plain version and leave the tuned
     counters where they were.  Each main-path shape is held to the plain
     version again on 300 more launches, each edge shape on 10, so that a
     race that fails some launches shows.
  3b. kernels (general): the general kernel (attention_general.cu) in both
     dtypes against its plain version at N = M = 180 with d = 32 and 96,
     M = 300 with N = 17 and d = 128, d = 50 with 200-byte rows, N = M =
     d = 1, d = 320 over M = 200 and d = 300 with its logits resident
     (three column blocks), N = M = 1,000 (two passes), M at the plan's
     switch between its paths and one key past it, q one element off
     alignment, 2 * SMs + 1 heads, 2^20 + 3 heads (a CTA takes two items)
     and logits near +-40, each again on 10 more launches, every launch
     on its counter; timed beside its bound, plain version and SDPA at
     the encoder chunk of a 120-frame, 96-wide-head config (B*H = 512,
     N = M = 180, d = 96), its decoder (B*H = 256, d = 32) and a
     240-frame encoder chunk (N = M = 360, d = 128).  Then the wide run:
     a random-weight generator of that config (decoder heads of 32)
     serves 4 streams x 120 frames through the runner on the card and on
     the CPU (positions within 1e-3, identical picks), every attention
     launch on the general kernel, as many as its layers imply; once more
     in bf16.
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
     within 1e-3 (135 frames, 256-window character).  Then one --bf16 run
     on the same files: every output finite with its clip's frame count,
     the sources through the bf16 kernel.
  7. multi: the slice's 64 x 240 streams against a stack of 30 synthetic
     characters (2048, 2032, ..., 1584 windows, each its own clip and
     norms; about 11 GB of float32 database on the card), stream s served
     character s % 30: featurize + the multi-character runner, 3 timed
     repeats with the launch check, peak memory; deterministic,
     runner.chunked (tchunk 60) equal to the monolithic run within 1e-4,
     streams 0 and 1 held to dedicated single-character runners (positions
     within 1e-3, identical picks), and the session from a bf16 copy of
     the stack (peak memory, picks at least 90% identical).
  8. live: LiveCharacterizer at full width, one stream, 1,010 frames of a
     synthetic clip, a 2048-window character: the first 12 frames
     (deterministic) held to the batch runner at S = 1 within 1e-5 / 1e-4;
     p50/p99 wall time of push_frame and of push_frame_pipelined (+ flush)
     against the 16.7 ms frame budget; attention launches exactly 2 per
     frame per decoder layer, half that on frame 0.
  9. bf16: the slice with bf16 weights and compute_dtype=bf16, 3 timed
     repeats, every launch on the bf16 kernel and none on the float32 one;
     deterministic at 2 streams x 120 frames, bf16 within 2e-3 of float32
     (picks at least 90% identical), cvae_dtype=bf16 within 2e-3 with
     identical picks, lean_decode and fuse_decodes within 1e-4.
  10. dataset: the offline chain through the port's CLIs in-process on 60
     synthetic BVH clips of 1,200 frames (the 30 styles walking and
     running; 144,000 frames mirrored, a 187 MB database.bin):
     generate_database, MotionDataset (norm.npz), collect_features
     cnt-norm (6,960 windows, 56 float32 launches) and character
     (Neutral_Princess running and walking: 4,560 windows, 36 launches),
     launch counts exact; characterize --src-dir on 8 clips with the
     written norm files, every output finite with its frame count; then 4
     clips through the build and MotionDataset on the CPU too (integer
     blocks identical, floats within 2e-4, contact flips at most 0.1%,
     norm.npz within 1e-4) and their windows encoded on both (encoded
     within 5e-4, cnt 5e-3).  Build frames/s, encode windows/s and the
     character export's savez_compressed are printed on lines of their
     own.
  11. train: cli/train.main in-process at full width for one epoch on
     the dataset phase's files (6,960 windows, 108 steps at batch 64,
     dropout on, float32): every logged metric finite, the mean of the
     last 5 logged loss_total values under the first 5's, no attention
     kernel launched while training (the training forwards take the plain
     formula); the step period from CUDA events, the host's time in the
     call, the epoch wall and peak memory printed on lines of their own; 3
     more steps under torch.profiler (kernel time, idle share, launches).
     Then one step of the checkpoint's weights on the card and on the CPU
     on the same batch of 8 (dropout off), in float32 and in float64, at
     the card's piecewise choices: losses within rtol 1e-4, NCE logits
     within 1e-4 of the largest positive, each top-k accuracy within the
     rows their measured gap can flip, gradients before the clip within
     rtol 1e-3 / atol 1e-5 x each tensor's largest; in float32 wherever
     the CPU's float32 lies within 1/9 of that bar from float64, and
     always in float64 at a bar 1e-3 of it; no tensor's card-to-CPU
     distance ratio to float64 over 8 x max(1, the median).
     Then characterize --gen-ckpt on the written checkpoint (4 clips of
     240 frames): its EMA served through the tuned fp32 kernel, exactly
     the launches its windows and frames imply, every output parsed back
     finite.
  12. cvae: on the dataset phase's files, collect_features character
     for the source style (Neutral_AverageJoe running and walking, 4,560
     windows, 36 float32 launches) on the same --random-init generator;
     cli/train_cvae.main in-process at the shipped cvae config (latent
     256, depth 2, 4 heads, ff 512, dropout 0.1, condition dropout 0.8,
     rollout 10, batch 32, 90 tokens) for 40 iterations: no attention
     kernel launched, every logged value finite, the iteration period
     (CUDA events at each step_placed start, median after 5),
     sample_batch's host time and its share of the period, peak memory,
     the first and last logged encoded_loss.  Then one iteration from
     the trained weights on one batch on the card and on the CPU
     (dropout and condition dropout 0, z = mu), teacher-forced and
     student-forced: metrics within rtol 2e-3 / 5e-2 / 1e-2 / 1e-2
     (enc / kl / cnt / dist), the mean |card - CPU| of the parameters
     under 0.2 x the mean update, the largest under 10 lr (R - 1)
     (tests/test_train.py:640-667); one with bf16 forwards, masters
     float32, finite, enc / cnt / dist within 5% of float32's.  Then
     characterize --src-dir on 4 of the phase's clips with --cvae-ckpt
     on the written cvae_000040.ckpt and its cvae_norm.npz: exactly the
     tuned launches its windows and frames imply, every output finite.
  The general kernel's counter stays at 0 through phases 4-12: the
  shipped config never leaves the tuned kernels.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mocha_sigasia2023_torch.cli import (  # noqa: E402
    characterize, collect_features, generate_database)
from mocha_sigasia2023_torch.cli import train as train_cli  # noqa: E402
from mocha_sigasia2023_torch.cli import train_cvae as train_cvae_cli  # noqa: E402
from mocha_sigasia2023_torch.data.dataset import (  # noqa: E402
    MotionDataset, compute_norm_stats, iterate_batches, window_xy_features)
from mocha_sigasia2023_torch.data.preprocess import featurize_clip  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_torch.data.windows import (  # noqa: E402
    full_window_indices, padded_window_indices, window_features)
from mocha_sigasia2023_torch.io import bvh  # noqa: E402
from mocha_sigasia2023_torch.models import cvae as cvae_mod  # noqa: E402
from mocha_sigasia2023_torch.models.cvae import CVAEConfig, init_cvae  # noqa: E402
from mocha_sigasia2023_torch.models import layers  # noqa: E402
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, content_feature, init_generator)
from mocha_sigasia2023_torch.ops import attention, build  # noqa: E402
from mocha_sigasia2023_torch.runtime import export  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as rtf  # noqa: E402
from mocha_sigasia2023_torch.runtime.live import (  # noqa: E402
    LiveCharacterizer)
from mocha_sigasia2023_torch.runtime.stream import (  # noqa: E402
    build_consts, cast_database, make_batch_runner, stack_consts,
    stack_stream_inputs)
from mocha_sigasia2023_torch.train import checkpoint as train_ckpt  # noqa: E402
from mocha_sigasia2023_torch.train.trainer import (  # noqa: E402
    GeneratorTrainer)
from mocha_sigasia2023_torch.train.trainer_cvae import (  # noqa: E402
    CVAETrainer)
from mocha_sigasia2023_torch.utils import get_config  # noqa: E402

# H100 SXM data sheet: HBM bandwidth, dense TF32 and bf16 tensor-core rates,
# and the fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
ATOL, RTOL = 2e-5, 1e-4
# the bf16 kernel against its plain version, compared in fp32: the two
# differ by the fp32 summation order and by P's bf16 rounding flipping where
# that order moves a value across a rounding boundary
ATOL_BF16, RTOL_BF16 = 8e-3, 8e-3
# dtype -> (tolerance, tensor-core rate, launch counter of fused_attention)
KERNEL_DTYPES = {
    torch.float32: ((ATOL, RTOL), PEAK_TF32_FLOPS, "launches"),
    torch.bfloat16: ((ATOL_BF16, RTOL_BF16), PEAK_BF16_FLOPS,
                     "launches_bf16"),
}
LAUNCH_COUNTERS = ("launches", "launches_bf16", "launches_general")
WINDOW_PAD = 60 // 4   # featurize yields T - window//4 windows per clip
# (at the shipped 60-frame windows)
# the slice: the JAX package's e2e bench workload (bench.py:399-530)
STREAMS, FRAMES, DB_WINDOWS = 64, 240, 2048
REPEATS = 3


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def check_launches(dev, cond, msg):
    """A launch-count check: it holds on the card; a CPU rehearsal's calls
    launch nothing and count nothing."""
    check(dev.type != "cuda" or cond, msg)


def reset_peak_memory(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_memory_gb(dev):
    """torch.cuda.max_memory_allocated in GB (not measured on the CPU)."""
    if dev.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 1e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(fn):
    """Run fn under torch.profiler on the card; return (result, wall s,
    kernel rows (name, device us, calls), the profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: the aten ops that launch them carry the same
    # device time again
    rows = [(e.key, device_time_us(e), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_time_us(e) > 0]
    return out, wall, rows, prof


def summarize(stage, wall, rows, top=12):
    kernel_us = sum(us for _, us, _ in rows)
    return {"stage": stage, "wall_s": wall, "device_kernel_s": kernel_us / 1e6,
            "device_idle_share": 1.0 - kernel_us / 1e6 / wall,
            "kernel_launches": sum(n for _, _, n in rows),
            "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                             "calls": n} for k, us, n in
                            sorted(rows, key=lambda r: -r[1])[:top]]}


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


# launches held to the plain version again after the first check, at each
# main-path shape and each edge shape: without its proxy fence the bf16
# kernel's ring raced, wrong in about 4 launches in 10 at M = 45 and 1 in
# 400 at the decoder shape on an H100 (scripts/attention_stress.py), and
# one check a shape missed it in two runs of three
MAIN_REPEATS, EDGE_REPEATS = 300, 10

# untimed edge shapes: (batch, heads, query rows, key rows, head dim); the
# last three take two row blocks (of the float32 kernel's 96 rows, of the
# bf16 kernel's 128) and the largest shared-memory footprint
ATTN_EDGE_SHAPES = ([(2, 3, n, m, d) for n in (1, 17) for m in (1, 45, 128)
                     for d in (64, 128, 256)]
                    + [(2, 3, 200, 128, 64), (2, 3, 128, 128, 256),
                       (2, 3, 200, 90, 256)])


def persistent_tail_shape(dev):
    """An edge shape of 2 * SMs + 1 heads at N = M = 90, d = 128: the bf16
    kernel's persistent grid has one CTA a SM, so one CTA takes a third
    item and the ring's stage and parity run on across items (132 SMs:
    B*H = 265 = 53 x 5)."""
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    items = 2 * sms + 1
    h = next(h for h in (5, 4, 3, 2, 1) if items % h == 0)
    return items // h, h, 90, 90, 128
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
DESIGN_BF16 = ("persistent and warp-specialized: one CTA a SM walks (batch, "
               "head, 128-row block) items; one producer warp keeps a ring "
               "of TMA stages (128-byte swizzle; 6 of 28 KB at 96 keys) full "
               "across items; two consumer warpgroups of 64 query rows run "
               "q k^T as wgmma m64nNk16 (N = 64/96/128 keys, K-major q and "
               "k) and P v as wgmma m64n64k16 with P from registers and v "
               "MN-major; fp32 softmax, P = e / sum rounded to bf16; each "
               "warp stores its rows of an output chunk through a swizzled "
               "staging tile and one TMA store")


def attention_bound_ms(b, h, n, m, d, dtype=torch.float32):
    """Least time for the call on an H100 SXM: each input read once and the
    output written once at the HBM rate, against the two products
    (4*B*H*N*M*d operations) at the dense tensor-core rate of the dtype
    (TF32 for float32, bf16 for bfloat16) plus the softmax (scale, max, exp
    and divide per logit) at the fp32 rate."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = esize * (b * h * n * d * 2 + b * h * m * d * 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = (4 * b * h * n * m * d / KERNEL_DTYPES[dtype][1]
             + 4 * b * h * n * m / PEAK_FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def head_views(rng, b, h, n, m, d, dev, dtype=torch.float32):
    """q, k, v as the serving path hands them over: (B, N, H, d)
    projections viewed as (B, H, N, d)."""
    def make(rows_):
        return torch.as_tensor(rng.standard_normal(
            (b, rows_, h, d)).astype(np.float32), device=dev).to(
                dtype).transpose(1, 2)
    return make(n), make(m), make(m)


def launches(dtype=torch.float32):
    """fused_attention's launch count of the kernel for ``dtype``."""
    return getattr(attention.fused_attention, KERNEL_DTYPES[dtype][2])


def check_attention(name, q, k, v, scale):
    """The kernel against its plain version, compared in fp32 at the
    dtype's tolerance; returns (max abs, max rel)."""
    atol, rtol = KERNEL_DTYPES[q.dtype][0]
    out = attention.fused_attention(q, k, v, scale=scale).float()
    ref = attention.attention_reference(q, k, v, scale).float()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    check(bool(torch.isfinite(out).all()), f"attention {name}: non-finite")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"attention {name} ({q.dtype}): max abs err {max_abs:.3e} exceeds "
          f"atol {atol} + rtol {rtol}")
    return max_abs, max_rel


def repeat_check(name, q, k, v, scale, reps):
    """``reps`` more launches on the same inputs, each held to the plain
    version at the dtype's tolerance: one launch can pass where a race
    inside the kernel fails one launch in a hundred."""
    atol, rtol = KERNEL_DTYPES[q.dtype][0]
    ref = attention.attention_reference(q, k, v, scale).float()
    limit = atol + rtol * ref.abs()
    bad = sum(bool(((attention.fused_attention(q, k, v, scale=scale).float()
                     - ref).abs() > limit).any()) for _ in range(reps))
    check(bad == 0, f"attention {name} ({q.dtype}): {bad} of {reps} repeated"
          " launches outside the tolerance")
    return reps


def attention_edge_checks(dev, dtype=torch.float32):
    """Edge shapes, large logits and a misaligned view (which goes to the
    general kernel), untimed; returns the largest abs error seen."""
    atol, rtol = KERNEL_DTYPES[dtype][0]
    tag = "attention" if dtype == torch.float32 else f"attention {dtype}"
    rng = np.random.RandomState(1)
    worst = 0.0
    shapes = ATTN_EDGE_SHAPES + [persistent_tail_shape(dev)]
    for b, h, n, m, d in shapes:
        q, k, v = head_views(rng, b, h, n, m, d, dev, dtype)
        max_abs, _ = check_attention(f"N={n},M={m},d={d}", q, k, v,
                                     d ** -0.5)
        repeat_check(f"N={n},M={m},d={d}", q, k, v, d ** -0.5,
                     EDGE_REPEATS)
        worst = max(worst, max_abs)
    log(f"[kernel] {tag}: {len(shapes)} edge shapes (B*H up to "
        f"{max(b * h for b, h, *_ in shapes)}) within "
        f"atol {atol} / rtol {rtol}, max abs {worst:.3e}; each held again "
        f"on {EDGE_REPEATS} more launches")
    _, b, h, n, m, d = ATTN_SHAPES[1]
    for heads in (LARGE_LOGIT_HEADS, (b, h)):
        q, k, v = head_views(rng, *heads, n, m, d, dev, dtype)
        q = q * LARGE_LOGIT_Q_SCALE
        logits = torch.einsum("bhnd,bhmd->bhnm", q.double(),
                              k.double()) * d ** -0.5
        exact = torch.softmax(logits, -1) @ v.double()
        out = attention.fused_attention(q, k, v, scale=d ** -0.5).double()
        plain = attention.attention_reference(q, k, v, d ** -0.5).double()
        outside = int(((out - plain).abs() > atol + rtol * plain.abs()).sum())
        log(f"[kernel] {tag} large logits (B*H={heads[0] * heads[1]}, "
            f"N=M={n}, d={d}, q x {LARGE_LOGIT_Q_SCALE:g}, logits "
            f"{float(logits.min()):.1f} to {float(logits.max()):.1f}): max "
            f"abs vs float64: kernel {float((out - exact).abs().max()):.3e}, "
            f"plain {float((plain - exact).abs().max()):.3e}; kernel vs plain"
            f" {float((out - plain).abs().max()):.3e}, {outside} of "
            f"{out.numel()} outside atol {atol} / rtol {rtol}")
        if heads == LARGE_LOGIT_HEADS:
            max_abs, _ = check_attention("large logits", q, k, v, d ** -0.5)
            worst = max(worst, max_abs)
    b, h = LARGE_LOGIT_HEADS
    q, k, v = head_views(rng, b, h, n, m, d, dev, dtype)
    flat = torch.empty(b * n * h * d + 1, device=dev, dtype=dtype)[1:]
    bad = flat.view(b, n, h, d).transpose(1, 2)   # one element off alignment
    bad.copy_(q)
    before = all_launches()
    check(attention._route(bad, k, v) == "general",
          f"{tag}: a misaligned view was not routed to the general kernel")
    max_abs, _ = check_attention("misaligned view", bad, k, v, d ** -0.5)
    after = all_launches()
    check(after["launches_general"] == before["launches_general"] + 1
          and all(after[c] == before[c] for c in ("launches", "launches_bf16")),
          f"{tag}: the misaligned view's launch counts moved from {before} "
          f"to {after}")
    log(f"[kernel] {tag}: a misaligned view went to the general kernel and "
        f"matches the plain version (max abs {max_abs:.3e}); the tuned "
        "counters did not move")
    return worst


def all_launches():
    """Every launch counter of fused_attention."""
    return {c: getattr(attention.fused_attention, c)
            for c in LAUNCH_COUNTERS}


def reset_launches():
    for c in LAUNCH_COUNTERS:
        setattr(attention.fused_attention, c, 0)


# CUtensorMapDataType of the kernels' maps
TENSOR_MAP_TYPES = {torch.float32: 7, torch.bfloat16: 9}


def tensor_map_encode_us(q, box_rows, calls=2000):
    """Host time of one cuTensorMapEncodeTiled, as a kernel's C entry
    calls it for each of its maps at every launch (3 in float32, 4 in
    bf16): q's (B, H, N, d) view as a 4-D map of its dtype, [box_rows x 128
    bytes] boxes, 128-byte swizzle.  None if the driver call fails."""
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
    esize = q.element_size()
    dims = (ctypes.c_uint64 * 4)(d, n, h, b)
    strides = (ctypes.c_uint64 * 3)(*(esize * q.stride(i)
                                      for i in (2, 1, 0)))
    box = (ctypes.c_uint32 * 4)(128 // esize, box_rows, 1, 1)
    unit = (ctypes.c_uint32 * 4)(1, 1, 1, 1)
    # rank 4, INTERLEAVE_NONE, SWIZZLE_128B = 3, L2_PROMOTION_L2_256B = 3,
    # FLOAT_OOB_FILL_NONE
    args = (tmap, TENSOR_MAP_TYPES[q.dtype], 4, q.data_ptr(), dims, strides,
            box, unit, 0, 3, 3, 0)
    if enc(*args) != 0:
        return None
    t0 = time.perf_counter()
    for _ in range(calls):
        enc(*args)
    return (time.perf_counter() - t0) / calls * 1e6


def kernel_phase(dev, dtype=torch.float32):
    """The kernel for ``dtype`` at the main-path shapes (timed), then the
    edge checks; returns (a row per shape, the edge checks' max abs)."""
    rng = np.random.RandomState(0)
    tag = "attention" if dtype == torch.float32 else f"attention {dtype}"
    n_maps = 3 if dtype == torch.float32 else 4
    rows = []
    for name, b, h, n, m, d in ATTN_SHAPES:
        q, k, v = head_views(rng, b, h, n, m, d, dev, dtype)
        scale = d ** -0.5
        max_abs, max_rel = check_attention(name, q, k, v, scale)
        repeats = repeat_check(name, q, k, v, scale, MAIN_REPEATS)
        ms, host_ms = time_ms(
            lambda: attention.fused_attention(q, k, v, scale=scale))
        plain_ms, _ = time_ms(
            lambda: attention.attention_reference(q, k, v, scale))
        lib_ms, _ = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound_ms(b, h, n, m, d, dtype)
        encode_us = tensor_map_encode_us(q, 96)
        row = {"shape": name, "dtype": str(dtype).replace("torch.", ""),
               "B": b, "H": h, "N": n, "M": m, "d": d,
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "repeated_launches_checked": repeats, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "roofline_share": bound_ms / ms, "host_ms": host_ms,
               "tensor_map_encode_us": encode_us}
        log(f"[kernel] {tag} {name} (B={b},H={h},N={n},M={m},d={d}): "
            f"max abs {max_abs:.3e} max rel {max_rel:.3e}, {repeats} more "
            f"launches within tolerance | kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), roofline share "
            f"{bound_ms / ms:.3f}; host {1e3 * host_ms:.1f} us a call, of "
            f"which {n_maps} tensor-map encodes take "
            + ("(not measured)" if encode_us is None
               else f"{n_maps * encode_us:.2f} us"))
        rows.append(row)
    edge_max_abs = attention_edge_checks(dev, dtype)
    torch.cuda.synchronize()
    return rows, edge_max_abs


# ---------------------------------------------------------------------------
# the general kernel: every shape outside the tuned envelope
# ---------------------------------------------------------------------------

# timed, each beside its bound, plain version and SDPA: the encoder chunk
# of a config with 120-frame windows (180 tokens) and encoder heads of 96
# (WIDE_CONFIG, the kernel line's shape), its decoder (heads of 32), and
# the encoder chunk of a 240-frame config (360 tokens, heads of 128)
GENERAL_SHAPES = [("wide encoder chunk", 128, 4, 180, 180, 96),
                  ("wide decoder", 64, 4, 180, 180, 32),
                  ("240-frame encoder chunk", 128, 4, 360, 360, 128)]
GENERAL_SHAPE = GENERAL_SHAPES[0]
# the card's L2: a call whose bytes fit is timed from L2 when repeated
L2_BYTES = 50 * 2 ** 20
# untimed, held to the plain version: (batch, heads, query rows, key rows,
# head dim); more than 128 keys, head dims off the multiples of 64, one of
# everything, d = 320 over 200 keys (three column blocks of P v; logits
# resident in bf16, two passes in fp32), 1,000 keys (the two-pass path)
GENERAL_EDGE_SHAPES = [(2, 3, 180, 180, 32), (2, 3, 180, 180, 96),
                       (2, 3, 17, 300, 128), (1, 1, 1, 1, 1),
                       (2, 3, 200, 200, 320), (1, 2, 1000, 1000, 96)]
GENERAL_ROWS_D = 50   # contiguous (B, H, rows, 50): 200-byte fp32 rows
# N and d of the cases at the plan's switch between its two paths
GENERAL_SWITCH_N_D = (90, 96)
# heads of the case whose grid (one CTA an item, at most 2^20) makes a CTA
# take a second item
GENERAL_MANY_HEADS = (1 << 20) + 3
DESIGN_GENERAL = ("a CTA of up to 4 warps owns 64 query rows and all of d "
                  "(16 rows a warp); q staged once (d <= 128) or beside "
                  "each 128-column k chunk; k and v in 32-key tiles through "
                  "two cp.async buffers (16-, 8- or 4-byte "
                  "copies or plain loads, as each view's alignment allows); "
                  "q k^T and P v on the tensor cores: 3xTF32 mma.sync."
                  "m16n8k8 (fp32), mma.sync.m16n8k16 with ldmatrix (bf16); "
                  "fp32 logits (base 2) computed once and kept in shared "
                  "memory where general_plan says they fit in half an SM "
                  "(max, sum and P = e / sum in v's dtype from there, P v "
                  "over every column block), else two passes over the keys")


def general_cases(rng, dev, dtype):
    """(name, q, k, v) of the general kernel's untimed checks."""
    cases = [(f"N={n},M={m},d={d}", *head_views(rng, b, h, n, m, d, dev,
                                                dtype))
             for b, h, n, m, d in GENERAL_EDGE_SHAPES]
    # d = 300 with its logits resident: P v over three column blocks
    m = attention.general_resident_keys(200, 300, dtype)
    cases.append((f"N=200,M={m},d=300 (resident)",
                  *head_views(rng, 2, 3, 200, m, 300, dev, dtype)))
    n, d = GENERAL_SWITCH_N_D
    switch = attention.general_resident_keys(n, d, dtype)
    for m in (switch, switch + 1):
        path = ("resident" if attention.general_plan(n, m, d, dtype).resident
                else "two-pass")
        cases.append((f"N={n},M={m},d={d} ({path})",
                      *head_views(rng, 2, 3, n, m, d, dev, dtype)))
    q, k, v = head_views(rng, 2, 3, 180, 180, 96, dev, dtype)
    flat = torch.empty(q.numel() + 1, device=dev, dtype=dtype)[1:]
    off = flat.view(2, 180, 3, 96).transpose(1, 2)   # one element off
    off.copy_(q)
    cases.append((f"q one element ({q.element_size()} bytes) off alignment",
                  off, k, v))
    q, k, v = (torch.as_tensor(rng.standard_normal(
        (GENERAL_MANY_HEADS, 1, 1, 1)).astype(np.float32), device=dev).to(
            dtype) for _ in range(3))
    cases.append((f"{GENERAL_MANY_HEADS} heads, N=M=d=1", q, k, v))
    d = GENERAL_ROWS_D
    rows = [torch.as_tensor(rng.standard_normal((2, 3, r, d)).astype(
        np.float32), device=dev).to(dtype) for r in (90, 90, 90)]
    cases.append((f"d={d}, {d * rows[0].element_size()}-byte rows", *rows))
    b, h, _, _, _ = persistent_tail_shape(dev)
    cases.append((f"{b * h} heads (2 x SMs + 1)",
                  *head_views(rng, b, h, 180, 180, 32, dev, dtype)))
    q, k, v = head_views(rng, 2, 3, 180, 180, 96, dev, dtype)
    cases.append((f"large logits (q x {LARGE_LOGIT_Q_SCALE:g})",
                  q * LARGE_LOGIT_Q_SCALE, k, v))
    return cases


def general_kernel_phase(dev, dtype=torch.float32):
    """The general kernel for ``dtype``: held to its plain version at the
    edge cases (each again on EDGE_REPEATS more launches), every launch on
    the general counter and none on the tuned ones; then timed at
    GENERAL_SHAPES.  Returns (a row per timed shape, the checks' max
    abs)."""
    tag = "attention general" + ("" if dtype == torch.float32
                                 else f" {dtype}")
    rng = np.random.RandomState(2)
    before = all_launches()
    worst = 0.0
    cases = general_cases(rng, dev, dtype)
    for name, q, k, v in cases:
        check(attention._route(q, k, v) == "general",
              f"{tag} {name}: routed to the tuned kernels")
        scale = q.shape[-1] ** -0.5
        max_abs, _ = check_attention(name, q, k, v, scale)
        repeat_check(name, q, k, v, scale, EDGE_REPEATS)
        worst = max(worst, max_abs)
    after = all_launches()
    want = before["launches_general"] + (1 + EDGE_REPEATS) * len(cases)
    check(after["launches_general"] == want
          and after["launches"] == before["launches"]
          and after["launches_bf16"] == before["launches_bf16"],
          f"{tag}: launch counts {after}, want {want} general launches and "
          f"no tuned ones since {before}")
    log(f"[kernel] {tag}: {len(cases)} cases ({', '.join(c[0] for c in cases)})"
        f" within the dtype's tolerance, max abs {worst:.3e}; each held "
        f"again on {EDGE_REPEATS} more launches, all on the general kernel")

    rows = []
    for name, b, h, n, m, d in GENERAL_SHAPES:
        q, k, v = head_views(rng, b, h, n, m, d, dev, dtype)
        check(attention._route(q, k, v) == "general",
              f"{tag} {name}: routed to the tuned kernels")
        scale = d ** -0.5
        max_abs, max_rel = check_attention(name, q, k, v, scale)
        ms, host_ms = time_ms(
            lambda: attention.fused_attention(q, k, v, scale=scale))
        plain_ms, _ = time_ms(
            lambda: attention.attention_reference(q, k, v, scale))
        lib_ms, _ = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound_ms(b, h, n, m, d, dtype)
        nbytes = q.element_size() * b * h * (2 * n + 2 * m) * d
        plan = attention.general_plan(n, m, d, dtype)
        row = {"shape": name, "dtype": str(dtype).replace("torch.", ""),
               "B": b, "H": h, "N": n, "M": m, "d": d,
               "max_abs_err": max(max_abs, worst), "max_rel_err": max_rel,
               "repeated_launches_checked": EDGE_REPEATS * len(cases),
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "roofline_share": bound_ms / ms, "host_ms": host_ms,
               "l2_resident": nbytes <= L2_BYTES,
               "plan": {"resident": plan.resident, "rows": plan.rows,
                        "smem": plan.smem}}
        # a call that fits in L2 is timed from L2: a share over 1 there
        # is the cache's, not a claim against the HBM bound
        share = (f"{bound_ms / ms:.3f}" + (" (L2-resident: bytes fit the "
                                           "50 MB L2)"
                                           if row["l2_resident"] else ""))
        log(f"[kernel] {tag} {name} (B={b},H={h},N={n},M={m},d={d}; "
            f"{'resident' if plan.resident else 'two-pass'}, "
            f"{plan.smem} B smem): max abs "
            f"{max_abs:.3e} max rel {max_rel:.3e} | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), roofline share {share}; host "
            f"{1e3 * host_ms:.1f} us a call")
        rows.append(row)
    torch.cuda.synchronize()
    return rows, worst


def general_phase(dev):
    """The general kernel in both dtypes, then the wide run.  Returns
    ({dtype: rows}, [max abs per dtype], the wide run's result, {dtype:
    its general launches})."""
    rows, worst = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        rows[dtype], w = general_kernel_phase(dev, dtype)
        worst.append(w)
    result, l32, l16 = wide_run({}, dev)
    return rows, worst, result, {torch.float32: l32, torch.bfloat16: l16}


# a generator config outside the tuned envelope: 120-frame windows (180
# tokens), encoder heads of 96 and decoder heads of 32, full widths
# otherwise; every one of its attentions goes to the general kernel
WIDE_CONFIG = dict(nframes=120, encoder_dim_head=96, decoder_dim_head=32)
WIDE_STREAMS, WIDE_FRAMES, WIDE_DB_WINDOWS = 4, 120, 256


def wide_expected_launches(cfg, streams=WIDE_STREAMS, frames=WIDE_FRAMES):
    """General-kernel launches of the wide run: every attention layer of
    the encode chunks and of the decodes (expected_launches)."""
    return expected_launches(cfg, [streams * frames], frames)


def wide_run(cvae_kw, dev, *, streams=WIDE_STREAMS, frames=WIDE_FRAMES,
             db_windows=WIDE_DB_WINDOWS, cfg=None):
    """A random-weight generator of WIDE_CONFIG (``cfg`` overrides it)
    serves ``streams`` x ``frames`` through the slice's runner,
    deterministic, on ``dev`` and on the CPU: positions within 1e-3,
    identical picks, and on the card every attention launch on the general
    kernel, as many as the layers imply.  Then once more on ``dev`` with
    bf16 weights and compute_dtype=bf16 (finite, the same count of general
    launches).  Returns (result, float32 general launches, bf16 general
    launches)."""
    cfg = cfg or GeneratorConfig(**WIDE_CONFIG)
    cvae_cfg = CVAEConfig(output_seq=cfg.num_tokens, **cvae_kw)
    expected = wide_expected_launches(cfg, streams, frames)
    clips = [make_mocha_bvh_data(T=frames + cfg.nframes // 4, seed=70 + i)
             for i in range(streams)]
    outs, counts = {}, {}
    for d in (dev, torch.device("cpu")):
        gen = init_generator(cfg, seed=3, device=d)
        cvae = init_cvae(cvae_cfg, seed=4, device=d)
        norm, consts, parents = character_setup(gen, db_windows, d)
        reset_launches()
        out, _, t_run = run_slice(gen, cvae, norm, consts, parents, clips, d,
                                  deterministic=True,
                                  root_dtype=torch.float64, keep_encoded=True)
        counts[d.type] = all_launches()
        outs[d.type] = {k: v.cpu() for k, v in out.items()}
        if d.type == dev.type:
            dev_run = (gen, cvae, norm, consts, parents, t_run)
    g, c = outs[dev.type], outs["cpu"]
    check_outputs(g, frames, streams)
    check_picks("wide", consts, c["encoded"], g["nn_index"], c["nn_index"])
    errs = max_errors(g, c, POS_KEYS, where=True)
    check(max(e[0] for e in errs.values()) <= 1e-3,
          f"wide: positions differ between {dev.type} and cpu: {errs}")
    got = counts[dev.type]
    check_launches(dev, got == {"launches": 0, "launches_bf16": 0,
                                "launches_general": expected},
                   f"wide: launch counts {got}, want {expected} general "
                   "launches and no tuned ones")

    gen, cvae, norm, consts, parents, t_run = dev_run
    reset_launches()
    out16, _, _ = run_slice(copy.deepcopy(gen).to(torch.bfloat16),
                            copy.deepcopy(cvae).to(torch.bfloat16), norm,
                            consts, parents, clips, dev, deterministic=True,
                            root_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    got16 = all_launches()
    check_outputs(out16, frames, streams)
    check_launches(dev, got16 == {"launches": 0, "launches_bf16": 0,
                                  "launches_general": expected},
                   f"wide bf16: launch counts {got16}, want {expected} "
                   "general launches and no tuned ones")
    result = {"config": WIDE_CONFIG, "tokens": cfg.num_tokens,
              "streams": streams, "frames": frames,
              "database_windows": db_windows,
              "runner_s": t_run, "max_abs_position_err": errs,
              "nn_picks_identical": True, "launches": got,
              "launches_bf16_run": got16, "expected_general": expected,
              "bf16_max_abs_vs_float32": max_errors(
                  {k: v.cpu() for k, v in out16.items()}, g, POS_KEYS)}
    log(f"[wide] {json.dumps(result)}")
    return (result, got["launches_general"], got16["launches_general"])


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------


def character_from_clip(gen, cha_clip, dev, compute_dtype=None):
    """Norm stats and session constants from one character clip (demo
    mode: no dataset), as the JAX package's e2e benchmark derives them;
    windows of the generator's ``nframes``."""
    window = gen.cfg.nframes
    feats = featurize_clip(
        torch.as_tensor(cha_clip["rotations"], dtype=torch.float32, device=dev),
        torch.as_tensor(cha_clip["positions"], dtype=torch.float32, device=dev),
        cha_clip["order"], cha_clip["names"], cha_clip["parents"])
    w = window_features(feats, window, 10, padded=False)
    X, Y, root = window_xy_features(w["rotations"], w["positions"],
                                    w["velocities"], w["angular_velocities"],
                                    feats["bone_parents"])
    norm = compute_norm_stats(X.cpu().numpy(), Y.cpu().numpy(),
                              root.cpu().numpy())
    cha = rtf.clip_stream_features_device(cha_clip, gen, norm,
                                          window=window,
                                          compute_dtype=compute_dtype,
                                          device=dev)
    cnt_norm = rtf.compute_cnt_norm(cha["encoded"], cha["cnt"])
    consts = build_consts(norm, cnt_norm, None, cha, device=dev)
    return norm, consts, cha["bone_parents"]


def character_setup(gen, db_windows, dev):
    """The slice's character: one synthetic clip of ``db_windows``
    windows."""
    return character_from_clip(
        gen, make_mocha_bvh_data(T=db_windows + gen.cfg.nframes // 4,
                                 seed=10_000, walk_speed=60.0), dev)


def run_slice(gen, cvae, norm, consts, parents, clips, dev, *,
              deterministic, root_dtype, seed=7, keep_encoded=False,
              char_ids=None, **runner_kw):
    """Featurize + encode ``clips`` and run the batch runner over them;
    returns (outputs, featurize seconds, runner seconds).  ``runner_kw``
    go to make_batch_runner (``compute_dtype`` also to the featurizer);
    ``char_ids`` to a multi-character runner."""
    runner = make_batch_runner(gen, cvae, consts, parents,
                               deterministic=deterministic,
                               root_dtype=root_dtype, device=dev,
                               multi_character=char_ids is not None,
                               **runner_kw)
    generator = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    frame0, xs = rtf.batch_stream_features_device(
        clips, gen, norm, window=gen.cfg.nframes, emit_cnt=False,
        compute_dtype=runner_kw.get("compute_dtype"), device=dev)
    sync(dev)
    t1 = time.perf_counter()
    out = runner(frame0, xs, None if deterministic else generator,
                 char_ids=char_ids)
    sync(dev)
    t2 = time.perf_counter()
    if keep_encoded:   # (frames, streams, tokens, dim), for NN-pick gaps
        out["encoded"] = torch.cat([frame0["encoded"][None], xs["encoded"]])
    return out, t1 - t0, t2 - t1


def nn_gaps(consts, encoded, picks_a, picks_b):
    """Per query window: squared distance to database pick a minus that to
    pick b, with float64 sums as the matcher scores them
    (runtime/matching.py)."""
    cnt = content_feature(encoded)
    q = ((cnt - consts.cnt_mean) / consts.cnt_std).reshape(len(cnt), -1)
    d2 = (consts.cha_cnt_sq.double()
          - 2.0 * q.double() @ consts.cha_cnt_flat.double().T)
    rows = torch.arange(len(cnt))
    return (d2[rows, picks_a] - d2[rows, picks_b]).tolist()


POS_KEYS = ("src_pos", "trans_pos", "ik_pos", "cm_pos")
ROT_KEYS = ("src_rot", "trans_rot", "ik_rot", "cm_rot")


def max_errors(a, b, keys, where=False):
    """{key: max abs difference of a[key] and b[key]} over (T, S, ...)
    outputs; with ``where``, [error, [frame, stream]] of the largest."""
    out = {}
    for k in keys:
        err = (a[k].float() - b[k].float()).abs()
        worst = float(err.max())
        if where:
            flat = int(err.reshape(err.shape[0] * err.shape[1], -1)
                       .amax(-1).argmax())
            out[k] = [worst, [flat // err.shape[1], flat % err.shape[1]]]
        else:
            out[k] = worst
    return out


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
    expected = expected_launches(cfg, [streams * frames], frames)
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
        check_launches(dev, launches >= expected,
              f"attention kernel launched {launches} times on the main path,"
              f" expected at least {expected}")
        runs.append((t_feat + t_run, t_feat, t_run, launches))
    launches = sorted(runs)[len(runs) // 2][3]
    result = {"streams": streams, "frames": frames, "repeats": repeats,
              "database_windows": int(consts.cha_encoded.shape[0]),
              **median_runs(runs, streams * frames),
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
    errs = max_errors(g, c, POS_KEYS)
    log(f"[parity] GPU vs CPU, {streams} streams x {frames} frames, NN picks "
        f"identical; max abs error per output with its (frame, stream): "
        f"{json.dumps(max_errors(g, c, POS_KEYS + ROT_KEYS, where=True))}")
    check(max(errs.values()) <= 1e-3, f"parity: positions differ {errs}")
    return errs


def check_picks(tag, consts, encoded, a, b):
    """NN picks a and b (T, S) must be identical; on a mismatch, print the
    distance gaps (a's pick minus b's) scored against ``consts``, with
    ``encoded`` (T, S, tokens, dim) the queries' source windows."""
    if torch.equal(a, b):
        return
    bad = (a != b).nonzero()
    f, s = bad[:, 0], bad[:, 1]
    gaps = nn_gaps(consts, encoded[f, s], a[f, s], b[f, s])
    log(f"[{tag}] NN picks differ at (frame, stream) {bad.tolist()}; "
        f"distance gaps first-pick minus second-pick: {gaps}")
    raise RuntimeError(f"{tag}: NN picks differ at {len(bad)} "
                       "(frame, stream)s")


def check_close(tag, a, b, keys, atol, rtol=0.0):
    """Every ``keys`` output of a within atol + rtol * |b| of b's; returns
    {key: [max abs, [frame, stream]]}."""
    errs = max_errors(a, b, keys, where=True)
    for k in keys:
        ok = bool(((a[k] - b[k]).abs() <= atol + rtol * b[k].abs()).all())
        check(ok, f"{tag}: {k} differs by {errs[k][0]:.3e} at (frame, "
              f"stream) {errs[k][1]}, over atol {atol} / rtol {rtol}")
    return errs


def expected_launches(cfg, windows_per_group, frames):
    """Attention launches of one featurize + runner pass: every 128-window
    encoder chunk of each featurize group, then 2 decodes a frame and 1 on
    frame 0, each layer of each decoder one launch."""
    chunks = sum(-(-n // 128) for n in windows_per_group)
    return (chunks * cfg.encoder_depth
            + ((frames - 1) * 2 + 1) * cfg.decoder_depth)


def median_runs(runs, n):
    """runs: (total s, featurize s, runner s, ...) per repeat -> the median
    repeat's rates with the range (host time varies run to run)."""
    runs = sorted(runs)
    total, t_feat, t_run = runs[len(runs) // 2][:3]
    return {"featurize_encode_s": t_feat, "runner_s": t_run,
            "e2e_frames_per_s": n / total,
            "e2e_frames_per_s_range": [n / runs[-1][0], n / runs[0][0]],
            "step_loop_frames_per_s": n / t_run,
            "step_loop_frames_per_s_range": [
                n / max(r[2] for r in runs), n / min(r[2] for r in runs)]}


# ---------------------------------------------------------------------------
# multi-character serving: 64 streams over a 30-character stack
# ---------------------------------------------------------------------------

MULTI_CHARACTERS = 30
MULTI_WINDOW_STEP = 16    # character c has DB_WINDOWS - 16c windows
MULTI_TCHUNK = 60


def multi_characters(gen, n, db_windows, dev):
    """n synthetic characters, each its own clip (seed 20000 + c, walk
    speed 40 + 2c cm/s) of db_windows - 16c windows, encoded on the card
    with its own norm stats.  Returns (consts per character, character 0's
    norm stats, parents)."""
    out, norm0, parents = [], None, None
    for c in range(n):
        clip = make_mocha_bvh_data(
            T=db_windows - MULTI_WINDOW_STEP * c + WINDOW_PAD,
            seed=20_000 + c, walk_speed=40.0 + 2.0 * c)
        norm, consts, parents = character_from_clip(gen, clip, dev)
        norm0 = norm if norm0 is None else norm0
        out.append(consts)
    return out, norm0, parents


def tensor_gb(consts):
    return sum(t.numel() * t.element_size() for t in consts) / 1e9


def multi_phase(cfg, cvae_cfg, dev, *, streams=STREAMS, frames=FRAMES,
                characters=MULTI_CHARACTERS, db_windows=DB_WINDOWS,
                repeats=REPEATS):
    """The slice's 64 x 240 streams, stream s served character s % 30 of a
    30-character stack; returns (result, attention launches)."""
    gen = init_generator(cfg, seed=0, device=dev)
    cvae = init_cvae(cvae_cfg, seed=1, device=dev)
    t0 = time.perf_counter()
    per_char, norm, parents = multi_characters(gen, characters, db_windows,
                                               dev)
    stack = stack_consts(per_char)
    rows = [c.cha_cnt_sq.shape[0] for c in per_char]
    dedicated = per_char[:2]
    del per_char
    sync(dev)
    setup_s = time.perf_counter() - t0
    stack_gb = tensor_gb(stack)
    C, M = stack.cha_cnt_sq.shape
    log(f"[multi] {characters} characters of {rows[-1]}..{rows[0]} windows "
        f"stacked to (C, M) = ({C}, {M}): {stack_gb:.2f} GB on the card; "
        f"set-up {setup_s:.1f} s (untimed)")
    clips = [make_mocha_bvh_data(T=frames + WINDOW_PAD, seed=i)
             for i in range(streams)]
    cids = np.arange(streams) % characters
    group = int(np.bincount(cids, minlength=characters).max())
    run_kw = dict(root_dtype=torch.float32, char_ids=cids)
    run_slice(gen, cvae, norm, stack, parents, clips, dev,
              deterministic=False, **run_kw)   # warm-up
    reset_peak_memory(dev)
    expected = expected_launches(cfg, [streams * frames], frames)
    local_rows = torch.as_tensor([rows[c] for c in cids], device=dev)
    runs = []
    for r in range(repeats):
        attention.fused_attention.launches = 0
        out, t_feat, t_run = run_slice(gen, cvae, norm, stack, parents, clips,
                                       dev, deterministic=False, seed=100 + r,
                                       **run_kw)
        launches = attention.fused_attention.launches
        check_outputs(out, frames, streams)
        check(bool(((out["nn_index"] >= 0)
                    & (out["nn_index"] < local_rows)).all()),
              "multi: an NN index outside its character's own rows")
        log(f"[multi] repeat {r}: featurize+encode {t_feat:.3f} s, stream "
            f"runner {t_run:.3f} s, attention launches {launches}")
        check_launches(dev, launches >= expected,
              f"multi: attention launched {launches} times, expected at "
              f"least {expected}")
        runs.append((t_feat + t_run, t_feat, t_run, launches))
    peak_f32 = peak_memory_gb(dev)
    launches = sorted(runs)[len(runs) // 2][3]

    # deterministic: chunked vs monolithic, then two streams of characters
    # 0 and 1 against dedicated single-character runners
    frame0, xs = rtf.batch_stream_features_device(clips, gen, norm,
                                                  emit_cnt=False, device=dev)
    encoded = torch.cat([frame0["encoded"][None], xs["encoded"]])
    runner = make_batch_runner(gen, cvae, stack, parents, deterministic=True,
                               multi_character=True, device=dev)
    det = runner(frame0, xs, char_ids=cids)
    chunked = runner.chunked({k: v.cpu() for k, v in frame0.items()},
                             {k: v.cpu() for k, v in xs.items()},
                             char_ids=cids, tchunk=MULTI_TCHUNK)
    check(torch.equal(det["nn_index"], chunked["nn_index"]),
          "multi: chunked picks differ from the monolithic run's")
    chunk_errs = check_close(f"multi chunked (tchunk {MULTI_TCHUNK})",
                             chunked, det, POS_KEYS + ROT_KEYS, 1e-4)
    dedicated_errs = {}
    for s in (0, 1):
        single = make_batch_runner(gen, cvae, dedicated[cids[s]], parents,
                                   deterministic=True, device=dev)(
            {k: v[s:s + 1] for k, v in frame0.items()},
            {k: v[:, s:s + 1] for k, v in xs.items()})
        mine = {k: v[:, s:s + 1] for k, v in det.items()}
        check_picks(f"multi stream {s}", dedicated[cids[s]],
                    encoded[:, s:s + 1], mine["nn_index"], single["nn_index"])
        dedicated_errs[f"stream {s} (character {cids[s]})"] = check_close(
            f"multi stream {s} vs its dedicated runner", mine, single,
            POS_KEYS, 1e-3)
    del runner, dedicated

    # the same session from a bf16 database stack
    stack16 = cast_database(stack, torch.bfloat16)
    del stack
    reset_peak_memory(dev)
    det16 = make_batch_runner(gen, cvae, stack16, parents, deterministic=True,
                              multi_character=True, device=dev)(
        frame0, xs, char_ids=cids)
    sync(dev)
    peak_bf16 = peak_memory_gb(dev)
    same = float((det16["nn_index"] == det["nn_index"]).float().mean())
    bf16_errs = max_errors(det16, det, POS_KEYS, where=True)
    log(f"[multi] bf16 database stack {tensor_gb(stack16):.2f} GB: peak "
        f"{peak_bf16:.2f} GB vs {peak_f32:.2f} GB in float32 "
        f"({peak_bf16 / peak_f32:.3f}); NN picks {same:.4f} identical to the"
        f" float32 stack's; max abs position differences "
        f"{json.dumps(bf16_errs)}")
    check(same >= 0.9, f"multi: bf16 stack picks only {same:.4f} identical")
    check(dev.type != "cuda" or peak_bf16 < peak_f32,
          "multi: the bf16 stack did not lower the peak memory")

    n = streams * frames
    result = {"streams": streams, "frames": frames, "characters": C,
              "group_size": group, "database_rows": [rows[-1], rows[0]],
              "stack_rows": M, "stack_gb_f32": stack_gb,
              "setup_s": setup_s, "repeats": repeats,
              **median_runs(runs, n),
              "peak_memory_gb_f32": peak_f32,
              "peak_memory_gb_bf16_database": peak_bf16,
              "bf16_database_picks_identical": same,
              "attention_launches": launches,
              "expected_launches_at_least": expected,
              "chunked_max_abs": chunk_errs,
              "dedicated_max_abs": dedicated_errs}
    log(f"[multi] {json.dumps(result)}")
    return result, launches


# ---------------------------------------------------------------------------
# the live frame-at-a-time session
# ---------------------------------------------------------------------------

LIVE_FRAMES = 1010        # the JAX package's bench.py --live
LIVE_HOLD_FRAMES = 12
BUDGET_MS = 1000.0 / 60.0


def live_phase(cfg, cvae_cfg, dev, *, frames=LIVE_FRAMES,
               db_windows=DB_WINDOWS):
    """One stream, frame at a time, against a 2048-window character; the
    first frames held to the batch runner at S = 1, then p50/p99 wall time
    of push_frame and of push_frame_pipelined.  Returns (result,
    attention launches of the push_frame run)."""
    gen = init_generator(cfg, seed=0, device=dev)
    cvae = init_cvae(cvae_cfg, seed=1, device=dev)
    norm, consts, parents = character_setup(gen, db_windows, dev)
    clip = make_mocha_bvh_data(T=frames + WINDOW_PAD, seed=60)
    feats = rtf.clip_stream_features_device(clip, gen, norm, device=dev)
    keys = LiveCharacterizer.FEAT_KEYS
    host = {k: feats[k].cpu().numpy() for k in keys}
    rows = [{k: host[k][i] for k in keys} for i in range(frames)]

    # deterministic: the session against the batch runner at S = 1
    n = LIVE_HOLD_FRAMES
    live = LiveCharacterizer(gen, cvae, consts, parents, deterministic=True,
                             device=dev)
    got = [live.push_frame(r) for r in rows[:n]]
    got = {k: torch.as_tensor(np.stack([g[k] for g in got]),
                              device=dev)[:, None] for k in got[0]}
    frame0, xs = stack_stream_inputs({k: feats[k][None, :n] for k in keys},
                                     device=dev)
    ref = make_batch_runner(gen, cvae, consts, parents, deterministic=True,
                            device=dev)(frame0, xs)
    check_picks("live", consts, feats["encoded"][:n, None], got["nn_index"],
                ref["nn_index"])
    hold = check_close("live vs batch runner", got, ref,
                       ("trans_pos", "ik_pos", "cm_pos"), 1e-5, 1e-4)

    live = LiveCharacterizer(gen, cvae, consts, parents, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(5))
    for r in rows[:4]:   # warm-up
        live.push_frame(r)
    live.reset()

    def pushes(push):
        times = []
        for r in rows[1:]:
            t0 = time.perf_counter()
            out = push(r)
            times.append(1e3 * (time.perf_counter() - t0))
        return np.asarray(times), out

    attention.fused_attention.launches = 0
    live.push_frame(rows[0])
    first = attention.fused_attention.launches
    attention.fused_attention.launches = 0
    direct, last = pushes(live.push_frame)
    launches = attention.fused_attention.launches
    check(np.isfinite(last["ik_pos"]).all(), "live: non-finite pose")
    check_launches(dev, first == cfg.decoder_depth
          and launches == 2 * cfg.decoder_depth * (frames - 1),
          f"live: attention launched {first} times on frame 0 and "
          f"{launches} on the next {frames - 1} frames; want "
          f"{cfg.decoder_depth} and {2 * cfg.decoder_depth * (frames - 1)}")
    live.reset()
    check(live.push_frame_pipelined(rows[0]) is None,
          "live: the first pipelined frame returned a pose")
    piped, out = pushes(live.push_frame_pipelined)
    t0 = time.perf_counter()
    tail = live.flush()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    check(out is not None and tail is not None and live.flush() is None,
          "live: the pipelined session lost a frame")

    def pct(a):
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean())}

    result = {"frames": frames, "database_windows": db_windows,
              "push_frame": pct(direct),
              "push_frame_pipelined": pct(piped), "flush_ms": flush_ms,
              "budget_ms": BUDGET_MS,
              "attention_launches_frame0": first,
              "attention_launches": launches,
              "hold_vs_batch_runner": hold}
    log(f"[live] {json.dumps(result)}")
    return result, first + launches


# ---------------------------------------------------------------------------
# bf16: the slice with bf16 weights, and the step's variants
# ---------------------------------------------------------------------------

BF16_POS_TOL = 2e-3       # tests/test_runtime.py:806-851
VARIANT_TOL = 1e-4        # tests/test_runtime.py:607-643
HOLD_KEYS = ("trans_pos", "ik_pos", "cm_pos")


def bf16_phase(cfg, cvae_cfg, dev, *, streams=STREAMS, frames=FRAMES,
               db_windows=DB_WINDOWS, repeats=REPEATS):
    """The slice on bf16 weights with compute_dtype=bf16 (the character
    encoded with the float32 weights, as the CLI's --bf16 does), timed;
    then, deterministic at 2 streams x 120 frames on the same float32
    stream features, the step in bf16, with cvae_dtype=bf16, lean_decode
    and fuse_decodes, each held to the float32 default.  Returns (result,
    bf16 attention launches)."""
    gen = init_generator(cfg, seed=0, device=dev)
    cvae = init_cvae(cvae_cfg, seed=1, device=dev)
    norm, consts, parents = character_setup(gen, db_windows, dev)
    gen16 = copy.deepcopy(gen).to(torch.bfloat16)
    cvae16 = copy.deepcopy(cvae).to(torch.bfloat16)
    bf16 = dict(compute_dtype=torch.bfloat16, root_dtype=torch.float32)
    clips = [make_mocha_bvh_data(T=frames + WINDOW_PAD, seed=i)
             for i in range(streams)]
    run_slice(gen16, cvae16, norm, consts, parents, clips, dev,
              deterministic=False, **bf16)   # warm-up
    expected = expected_launches(cfg, [streams * frames], frames)
    runs = []
    for r in range(repeats):
        attention.fused_attention.launches = 0
        attention.fused_attention.launches_bf16 = 0
        out, t_feat, t_run = run_slice(gen16, cvae16, norm, consts, parents,
                                       clips, dev, deterministic=False,
                                       seed=100 + r, **bf16)
        l16 = attention.fused_attention.launches_bf16
        l32 = attention.fused_attention.launches
        check_outputs(out, frames, streams)
        log(f"[bf16] repeat {r}: featurize+encode {t_feat:.3f} s, stream "
            f"runner {t_run:.3f} s, attention launches bf16 {l16}, "
            f"float32 {l32}")
        check_launches(dev, l16 >= expected and l32 == 0,
              f"bf16: {l16} bf16 and {l32} float32 attention launches; want "
              f"at least {expected} and 0")
        runs.append((t_feat + t_run, t_feat, t_run, l16))
    launches = sorted(runs)[len(runs) // 2][3]

    # deterministic holds of the step (tests/test_runtime.py:806-851): the
    # same float32 stream features through each variant's runner
    small = [make_mocha_bvh_data(T=120 + WINDOW_PAD, seed=50 + i)
             for i in range(2)]
    frame0, xs = rtf.batch_stream_features_device(small, gen, norm,
                                                  emit_cnt=False, device=dev)
    encoded = torch.cat([frame0["encoded"][None], xs["encoded"]])

    def det(g, c, **kw):
        return make_batch_runner(g, c, consts, parents, deterministic=True,
                                 root_dtype=torch.float32, device=dev,
                                 **kw)(frame0, xs)

    ref = det(gen, cvae)
    holds = {}
    for name, out, tol, same_picks in (
            ("bf16", det(gen16, cvae16, compute_dtype=torch.bfloat16),
             BF16_POS_TOL, False),
            ("cvae_dtype=bf16", det(gen, cvae16, cvae_dtype=torch.bfloat16),
             BF16_POS_TOL, True),
            ("lean_decode", det(gen, cvae, lean_decode=True), VARIANT_TOL,
             True),
            ("fuse_decodes", det(gen, cvae, fuse_decodes=True), VARIANT_TOL,
             True)):
        same = float((out["nn_index"] == ref["nn_index"]).float().mean())
        if same_picks:
            check_picks(f"bf16 phase {name}", consts, encoded,
                        out["nn_index"], ref["nn_index"])
        check(same >= 0.9, f"{name}: NN picks only {same:.3f} identical")
        rtol = VARIANT_TOL if tol == VARIANT_TOL else 0.0
        errs = check_close(f"{name} vs float32 default", out, ref, HOLD_KEYS,
                           tol, rtol)
        holds[name] = {"max_abs": errs, "picks_identical": same,
                       "tolerance": tol}
        log(f"[bf16] {name} vs the float32 default, 2 streams x 120 frames:"
            f" {json.dumps(holds[name])}")
    # the whole bf16 path, sources encoded in bf16 too: reported beside
    # the step's holds (the bound above is the step's)
    whole, _, _ = run_slice(gen16, cvae16, norm, consts, parents, small, dev,
                            deterministic=True, **bf16)
    holds["bf16 encode + step"] = {
        "max_abs": max_errors(whole, ref, HOLD_KEYS, where=True),
        "picks_identical": float(
            (whole["nn_index"] == ref["nn_index"]).float().mean())}
    log(f"[bf16] bf16 encode + step vs float32, 2 streams x 120 frames "
        f"(reported): {json.dumps(holds['bf16 encode + step'])}")
    n = streams * frames
    result = {"streams": streams, "frames": frames, "repeats": repeats,
              "database_windows": db_windows, **median_runs(runs, n),
              "attention_launches_bf16": launches,
              "expected_launches_at_least": expected, "holds": holds}
    log(f"[bf16] {json.dumps(result)}")
    return result, launches


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
    attention.fused_attention.launches_bf16 = 0
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


def cli_lengths(clips=CLI_CLIPS):
    """Raw frame counts of the cli phase's clips."""
    return [CLI_LENGTHS[i % len(CLI_LENGTHS)] for i in range(clips)]


def cli_expected_launches(cfg, lengths):
    """Attention launches of the clips' featurize groups and the runner
    over the longest clip (the character's encode not counted)."""
    n_w = {L: len(padded_window_indices(L, 60, 1)[0]) for L in lengths}
    return expected_launches(
        cfg, [lengths.count(L) * n for L, n in n_w.items()],
        max(n_w.values()))


def cli_phase(cfg, dev, root, *, clips=CLI_CLIPS, db_windows=DB_WINDOWS,
              repeats=CLI_REPEATS, config=None):
    """Phase 6.  ``config`` (a config file for ``cfg``) defaults to the
    port's own, which has the full widths."""
    lengths = cli_lengths(clips)
    src, cha = write_cli_inputs(root, lengths, db_windows, first_seed=200)
    n_w = [len(padded_window_indices(L, 60, 1)[0]) for L in lengths]
    frames = sum(n_w)
    cfg_args = ["--config", config] if config else []
    base = ["--src-dir", src, "--cha", cha, "--random-init",
            "--device", dev.type] + cfg_args

    def args(out, *extra):
        return base + ["--out", os.path.join(root, out), *extra]

    expected = cli_expected_launches(cfg, lengths)

    run_cli(args("warmup"))
    runs = []
    for r in range(repeats):
        out, wall, n_groups, launches = run_cli(
            args(f"run{r}", "--seed", str(100 + r)))
        log(f"[cli] repeat {r}: main() {wall:.3f} s for {frames} frames, "
            f"{n_groups} groups, attention launches {launches}")
        check(n_groups == len(CLI_LENGTHS),
              f"cli: {n_groups} featurize groups, want {len(CLI_LENGTHS)}")
        check_launches(dev, launches >= expected,
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


def cli_bf16_run(cfg, dev, root, *, clips=CLI_CLIPS, config=None):
    """``characterize.main([... "--bf16"])`` on the cli phase's files (in
    ``root``): every output finite with its clip's frame count.  The
    character is encoded with the float32 weights (float32 launches), the
    sources and the session in bf16.  Returns (result, bf16 launches)."""
    lengths = cli_lengths(clips)
    n_w = [len(padded_window_indices(L, 60, 1)[0]) for L in lengths]
    out_dir = os.path.join(root, "bf16")
    _, wall, n_groups, l32 = run_cli(
        ["--src-dir", os.path.join(root, "src"), "--cha",
         os.path.join(root, "cha.bvh"), "--random-init", "--bf16",
         "--device", dev.type, "--out", out_dir]
        + (["--config", config] if config else []))
    l16 = attention.fused_attention.launches_bf16
    expected = cli_expected_launches(cfg, lengths)
    outs = read_outputs(out_dir)
    check(len(outs) == 3 * clips, f"cli --bf16: {len(outs)} output files")
    for i, n in enumerate(n_w):
        for name in (f"Src_clip_{i:02d}.bvh", f"Ours_clip_{i:02d}_To_cha.bvh",
                     f"CM_clip_{i:02d}_To_cha.bvh"):
            d = outs[name]
            check(d["rotations"].shape[0] == n
                  and np.isfinite(d["rotations"]).all()
                  and np.isfinite(d["positions"]).all(),
                  f"cli --bf16: {name} has {d['rotations'].shape[0]} frames "
                  f"(want {n}) or is not finite")
    check_launches(dev, l16 >= expected and l32 > 0,
          f"cli --bf16: {l16} bf16 and {l32} float32 attention launches; "
          f"want at least {expected} bf16 and some float32 (the character)")
    result = {"main_s": wall, "frames": sum(n_w), "featurize_groups": n_groups,
              "attention_launches_bf16": l16,
              "attention_launches_float32": l32,
              "expected_bf16_launches_at_least": expected}
    log(f"[cli] --bf16: {json.dumps(result)}")
    return result, l16


# ---------------------------------------------------------------------------
# the offline dataset path: database build, norm stats, feature exports
# ---------------------------------------------------------------------------

DATASET_CLIPS = 60               # the 30 styles walking and running
DATASET_FRAMES = 1200            # 20 s a clip at 60 fps
DATASET_ACTIONS = ("Walk", "Run")
DATASET_STYLE = 17               # Neutral_Princess in configs/dataset.yaml
DATASET_CHARACTER_ACTIONS = (6, 7)   # Run, Walk
DATASET_CHARACTERIZE_CLIPS = 8
DATASET_SUBSET = 4               # clips held to the port on the CPU
DATASET_WINDOW, DATASET_STEP = 60, 20   # collect_features' windows
ENCODE_BATCH = 256               # runtime/features.encode_windows
CONTACT_FLIPS_MAX = 1e-3         # share of contact states


def dataset_names(clips=DATASET_CLIPS):
    """File stems: each style of the port's dataset.yaml walking and
    running, Neutral_Princess first, so that any first few hold the
    exported character."""
    styles = get_config(generate_database.DEFAULT_DATASET_CONFIG)[
        "mocha_style_names"]
    styles = styles[DATASET_STYLE:] + styles[:DATASET_STYLE]
    pairs = [(s, a) for s in styles for a in DATASET_ACTIONS][:clips]
    return [f"{a}_{s}_{i:03d}" for i, (s, a) in enumerate(pairs)]


def character_expected(cfg, style, clips=DATASET_CLIPS,
                       frames=DATASET_FRAMES):
    """Ranges, windows and float32 attention launches of ``collect_features
    character`` for ``style`` over DATASET_CHARACTER_ACTIONS: windows
    range(60, T) of each of the style's clips of those actions, both
    variants; one launch per encoder layer per batch of 256."""
    vocab = get_config(generate_database.DEFAULT_DATASET_CONFIG)
    name = vocab["mocha_style_names"][style]
    actions = [vocab["mocha_action_names"][a] + "_"
               for a in DATASET_CHARACTER_ACTIONS]
    character = [n for n in dataset_names(clips)
                 if f"_{name}_" in n and n.startswith(tuple(actions))]
    windows = 2 * len(character) * (frames - DATASET_WINDOW)
    return {"ranges": 2 * len(character), "windows": windows,
            "launches": encode_launches(cfg, windows)}


def encode_launches(cfg, windows):
    return -(-windows // ENCODE_BATCH) * cfg.encoder_depth


def dataset_expected(cfg, clips=DATASET_CLIPS, frames=DATASET_FRAMES):
    """Windows and float32 attention launches of the dataset phase's two
    exports: cnt-norm windows every 20 frames of each range (both
    variants of every clip), and the character's (character_expected)."""
    cnt_windows = 2 * clips * len(full_window_indices(
        frames, DATASET_WINDOW, DATASET_STEP))
    character = character_expected(cfg, DATASET_STYLE, clips, frames)
    return {"frames": 2 * clips * frames, "ranges": 2 * clips,
            "cnt_norm_windows": cnt_windows,
            "cnt_norm_launches": encode_launches(cfg, cnt_windows),
            "character_ranges": character["ranges"],
            "character_windows": character["windows"],
            "character_launches": character["launches"]}


def quiet(fn, *args):
    """fn(*args) with its printout captured; returns (result, seconds,
    printout)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, time.perf_counter() - t0, buf.getvalue()


@contextlib.contextmanager
def timed_savez():
    """Inside the block, np.savez_compressed adds its wall time to the
    yielded dict's "s" (the character export's file write, timed within
    the CLI's own call)."""
    real, spent = np.savez_compressed, {"s": 0.0}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            spent["s"] += time.perf_counter() - t0

    np.savez_compressed = timed
    try:
        yield spent
    finally:
        np.savez_compressed = real


def check_tuned_launches(dev, tag, expected):
    got = all_launches()
    check_launches(dev, got == {"launches": expected, "launches_bf16": 0,
                                "launches_general": 0},
                   f"{tag}: launch counts {got}, want exactly {expected} "
                   "float32 launches and no others")
    return got["launches"]


def dataset_phase(cfg, dev, root, *, clips=DATASET_CLIPS,
                  frames=DATASET_FRAMES,
                  characterize_clips=DATASET_CHARACTERIZE_CLIPS,
                  subset=DATASET_SUBSET, config=None):
    """The offline chain through the port's CLIs in-process: build the
    database of ``clips`` synthetic BVH clips (mirrored), MotionDataset
    (writes norm.npz), collect_features cnt-norm and character
    (Neutral_Princess running and walking), then characterize --src-dir on
    ``characterize_clips`` clips with the written norm files; then a
    ``subset`` of the clips held to the port on the CPU.  Returns (result,
    float32 launches of the two exports)."""
    t_phase = time.perf_counter()
    exp = dataset_expected(cfg, clips, frames)
    names = dataset_names(clips)
    bvh_dir, data = os.path.join(root, "bvh"), os.path.join(root, "data")
    os.makedirs(bvh_dir)
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        run = name.startswith("Run")
        bvh.save(os.path.join(bvh_dir, name + ".bvh"),
                 make_mocha_bvh_data(T=frames, seed=3000 + i,
                                     walk_speed=(150.0 if run else 60.0)
                                     + 2.0 * (i % 10)))
    write_s = time.perf_counter() - t0
    dev_args = ["--device", dev.type]
    cfg_args = ["--config", config] if config else []

    reset_launches()
    db, build_s, _ = quiet(generate_database.main,
                           ["--bvh-dir", bvh_dir, "--out", data, *dev_args])
    check(db["bone_positions"].shape[0] == exp["frames"]
          and len(db["range_starts"]) == exp["ranges"],
          f"dataset: database of {db['bone_positions'].shape[0]} frames in "
          f"{len(db['range_starts'])} ranges, want {exp}")
    vocab = get_config(generate_database.DEFAULT_DATASET_CONFIG)[
        "mocha_style_names"]
    styles = {i for i, st in enumerate(vocab) if any(st in n for n in names)}
    check(set(db["style_labels"].tolist()) == styles,
          f"dataset: style labels {sorted(set(db['style_labels'].tolist()))}"
          f", want {sorted(styles)}")
    db_mb = os.path.getsize(os.path.join(data, "database.bin")) / 1e6
    check_tuned_launches(dev, "dataset build", 0)
    log(f"[dataset] {clips} BVH clips of {frames} frames written in "
        f"{write_s:.2f} s; generate_database {build_s:.2f} s for "
        f"{exp['frames']} frames in {exp['ranges']} ranges ({db_mb:.1f} MB)")

    t0 = time.perf_counter()
    ds = MotionDataset(data, device=dev)
    dataset_s = time.perf_counter() - t0
    check(os.path.isfile(os.path.join(data, "norm.npz"))
          and len(ds) == exp["cnt_norm_windows"],
          f"dataset: MotionDataset has {len(ds)} windows, want "
          f"{exp['cnt_norm_windows']}, or wrote no norm.npz")
    del ds
    log(f"[dataset] MotionDataset {dataset_s:.2f} s for "
        f"{exp['cnt_norm_windows']} windows (norm.npz written)")

    common = ["--data-dir", data, "--random-init", *dev_args, *cfg_args]
    reset_launches()
    _, cnt_s, said = quiet(collect_features.main, ["cnt-norm", *common])
    cnt_launches = check_tuned_launches(dev, "cnt-norm",
                                        exp["cnt_norm_launches"])
    check(f"over {exp['cnt_norm_windows']} windows" in said,
          f"cnt-norm: {said.strip()}")
    log(f"[dataset] cnt-norm {cnt_s:.2f} s for {exp['cnt_norm_windows']} "
        f"windows, {cnt_launches} float32 launches")
    char_path = os.path.join(root, "princess_feature.npz")
    reset_launches()
    with timed_savez() as savez:
        feats, char_s, _ = quiet(collect_features.main, [
            "character", *common, "--styles", str(DATASET_STYLE),
            "--actions", *map(str, DATASET_CHARACTER_ACTIONS), "--out",
            char_path])
    char_launches = check_tuned_launches(dev, "character",
                                         exp["character_launches"])
    per = frames - DATASET_WINDOW
    n_char = exp["character_ranges"]
    check(feats["encoded"].shape[0] == exp["character_windows"]
          and feats["range_starts"].tolist() == [per * i
                                                 for i in range(n_char)]
          and feats["range_stops"].tolist() == [per * (i + 1)
                                                for i in range(n_char)],
          f"character: {feats['encoded'].shape[0]} windows, ranges "
          f"{feats['range_starts'].tolist()}-{feats['range_stops'].tolist()}")
    savez_s = savez["s"]
    feature_mb = os.path.getsize(char_path) / 1e6
    del feats
    log(f"[dataset] character {char_s:.2f} s for {exp['character_windows']}"
        f" windows, {char_launches} float32 launches; savez_compressed of "
        f"the export within it {savez_s:.2f} s ({feature_mb:.1f} MB)")

    src = os.path.join(root, "src")
    os.makedirs(src)
    for name in names[:characterize_clips]:
        shutil.copy(os.path.join(bvh_dir, name + ".bvh"), src)
    out_dir = os.path.join(root, "characterized")
    _, char_cli_s, n_groups, char_cli_launches = run_cli(
        ["--src-dir", src, "--cha", os.path.join(bvh_dir, names[0] + ".bvh"),
         "--random-init", "--norm", os.path.join(data, "norm.npz"),
         "--cnt-norm", os.path.join(data, "cnt_norm.npz"), *dev_args,
         "--out", out_dir, *cfg_args])
    n_out = len(padded_window_indices(frames, 60, 1)[0])
    want = cli_expected_launches(cfg, [frames] * characterize_clips)
    check_launches(dev, char_cli_launches >= want,
                   f"dataset characterize: {char_cli_launches} float32 "
                   f"launches, want at least {want}")
    outs = read_outputs(out_dir)
    check(len(outs) == 3 * characterize_clips,
          f"dataset characterize: {len(outs)} output files")
    for f, d in outs.items():
        check(d["rotations"].shape[0] == n_out
              and np.isfinite(d["rotations"]).all()
              and np.isfinite(d["positions"]).all(),
              f"dataset characterize: {f} has {d['rotations'].shape[0]} "
              f"frames (want {n_out}) or is not finite")

    log(f"[dataset] characterize --src-dir {char_cli_s:.2f} s for "
        f"{characterize_clips} x {n_out} frames, {char_cli_launches} float32"
        " launches; every output finite with its frame count")
    parity = dataset_parity(cfg, dev, root, bvh_dir, names[:subset])
    phase_s = time.perf_counter() - t_phase
    result = {
        "clips": clips, "frames_per_clip": frames, **exp,
        "database_mb": db_mb, "bvh_write_s": write_s,
        "build_s": build_s, "build_frames_per_s": exp["frames"] / build_s,
        "motion_dataset_s": dataset_s, "cnt_norm_s": cnt_s,
        "cnt_norm_windows_per_s": exp["cnt_norm_windows"] / cnt_s,
        "character_s": char_s,
        "character_windows_per_s": exp["character_windows"] / char_s,
        "character_savez_compressed_s": savez_s,
        "character_file_mb": feature_mb,
        "characterize_clips": characterize_clips,
        "characterize_frames": characterize_clips * n_out,
        "characterize_s": char_cli_s, "characterize_groups": n_groups,
        "characterize_float32_launches": char_cli_launches,
        "parity": parity, "phase_s": phase_s}
    log(f"[dataset] {json.dumps(result)}")
    return result, cnt_launches + char_launches


FEAT_ATOL = 2e-4   # the port's featurize tolerance (test_torch_features.py)
FPS = 60.0


def implied_velocity_gap(pos_a, pos_b, starts, stops, fps=FPS):
    """The velocity gap that two position blocks' gap implies, in float64:
    featurize's central difference (endpoints extrapolated, as
    data/preprocess.central_velocity takes it) of pos_a - pos_b within each
    range [start, stop).  The stencil is linear, so two builds whose
    velocities are each their own positions' central differences differ
    in velocity by this, up to the stencil's own float32 rounding."""
    gap = pos_a.astype(np.float64) - pos_b.astype(np.float64)
    out = np.empty_like(gap)
    for s, e in zip(np.asarray(starts).tolist(), np.asarray(stops).tolist()):
        inner = 0.5 * fps * (gap[s + 2:e] - gap[s:e - 2])
        out[s + 1:e - 1] = inner
        out[s] = inner[0] - (inner[2] - inner[1])
        out[e - 1] = inner[-1] + (inner[-1] - inner[-2])
    return out


def velocity_parity(g, c):
    """The database's velocity block, device (``g``) against CPU (``c``):
    the bar is FEAT_ATOL plus the largest gap the two sides' positions
    imply through the central difference (a 20 s clip carries its root
    12-30 m out, where one float32 spacing of a position is 1.9 um, and
    the difference times 60 fps turns it into 1e-4 m/s), and what the
    positions do not explain is held to FEAT_ATOL on its own."""
    diff = (g["bone_velocities"].astype(np.float64)
            - c["bone_velocities"])
    implied = implied_velocity_gap(g["bone_positions"], c["bone_positions"],
                                   c["range_starts"], c["range_stops"])
    err = np.abs(diff)
    out = {"max_abs": float(err.max()),
           "implied_by_positions": float(np.abs(implied).max()),
           "residual": float(np.abs(diff - implied).max()),
           "at_frame_bone": [int(i) for i in np.unravel_index(
               err.argmax(), err.shape)[:2]]}
    out["tolerance"] = FEAT_ATOL + out["implied_by_positions"]
    return out, (out["max_abs"] <= out["tolerance"]
                 and out["residual"] <= FEAT_ATOL)


def dataset_parity(cfg, dev, root, bvh_dir, names):
    """``names``' clips through generate_database and MotionDataset on
    ``dev`` and on the CPU, and the CPU database's windows every 20 frames
    encoded on both with the same seeded weights and the CPU's norm
    stats: integer blocks identical, float blocks within 2e-4 (velocities
    as velocity_parity holds them), contact flips at most 0.1% (printed with
    their frames), norm.npz within 1e-4, encoded within 5e-4 and cnt
    within 5e-3."""
    sub = os.path.join(root, "subset")
    os.makedirs(sub)
    for name in names:
        shutil.copy(os.path.join(bvh_dir, name + ".bvh"), sub)
    cpu = torch.device("cpu")
    dbs, norms = {}, {}
    for d in (dev, cpu):
        out = os.path.join(root, f"subset_{d.type}")
        dbs[d.type], _, _ = quiet(generate_database.main, [
            "--bvh-dir", sub, "--out", out, "--device", d.type])
        MotionDataset(out, device=d)
        norms[d.type] = dict(np.load(os.path.join(out, "norm.npz")))
    g, c = dbs[dev.type], dbs["cpu"]
    errs = {}
    for k in c:
        check(g[k].shape == c[k].shape and g[k].dtype == c[k].dtype,
              f"dataset parity: {k} is {g[k].dtype}{g[k].shape} on "
              f"{dev.type}, {c[k].dtype}{c[k].shape} on the CPU")
        if k == "contact_states":
            flips = np.argwhere(g[k] != c[k])
            errs[k] = {"flips": len(flips), "of": int(c[k].size),
                       "frames": flips[:, 0].tolist()[:50]}
            check(len(flips) <= CONTACT_FLIPS_MAX * c[k].size,
                  f"dataset parity: {len(flips)} contact flips")
        elif k == "bone_velocities":
            errs[k], ok = velocity_parity(g, c)
            check(ok, f"dataset parity: {k} differs by {errs[k]}")
        elif c[k].dtype == np.float32:
            err = np.abs(g[k] - c[k])
            errs[k] = {"max_abs": float(err.max()), "tolerance": FEAT_ATOL,
                       "at_frame_bone": [int(i) for i in np.unravel_index(
                           err.argmax(), err.shape)[:2]]}
            check(errs[k]["max_abs"] <= FEAT_ATOL, f"dataset parity: {k} "
                  f"differs by {errs[k]}")
        else:
            check(np.array_equal(g[k], c[k]), f"dataset parity: {k} differs")
    for k in norms["cpu"]:
        errs[f"norm {k}"] = float(np.abs(norms[dev.type][k]
                                         - norms["cpu"][k]).max())
        check(errs[f"norm {k}"] <= 1e-4, f"dataset parity: norm.npz {k} "
              f"differs by {errs[f'norm {k}']:.3e}")
    enc = {}
    for d in (dev, cpu):
        gen = init_generator(cfg, seed=1777, device=d)
        e, cn, _, _ = rtf.encode_database(c, gen, norms["cpu"], device=d)
        enc[d.type] = (e.cpu(), cn.cpu())
    errs["encoded"] = float((enc[dev.type][0] - enc["cpu"][0]).abs().max())
    errs["cnt"] = float((enc[dev.type][1] - enc["cpu"][1]).abs().max())
    errs["windows"] = int(enc["cpu"][0].shape[0])
    check(errs["encoded"] <= 5e-4 and errs["cnt"] <= 5e-3,
          f"dataset parity: encoded {errs['encoded']:.3e}, cnt "
          f"{errs['cnt']:.3e}")
    log(f"[dataset] {dev.type} vs cpu on {len(names)} clips: "
        f"{json.dumps(errs)}")
    return errs


# ---------------------------------------------------------------------------
# train: cli/train for an epoch on the dataset phase's files
# ---------------------------------------------------------------------------

TRAIN_EPOCHS = 1
LOSS_WINDOW = 5              # logged values averaged at each end of the run
STEP_WARMUP = 5              # steps left out of the step-time median
TRAIN_PARITY_BATCH = 8
TRAIN_LOSS_RTOL = 1e-4       # GPU vs CPU, one step
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-3, 1e-5   # atol x the tensor's max |g|
TRAIN_GRAD_VANISH = 1e-6     # float64 max |g| under this x the model's: the
                             # tensor's exact gradient vanishes
TRAIN_F64_RATIO = 8.0        # a tensor's (card / CPU distance to float64)
                             # over max(1, that ratio's median)
TRAIN_F64_SCALE = 1e-3       # the float64 step's bars: the float32 ones x this
TRAIN_DECIDES = 1.0 / (1.0 + TRAIN_F64_RATIO)   # the CPU's float32 within
                             # this share of a bar from float64: the float32
                             # comparison decides (see judge)
TRAIN_JITTERS = 3            # CPU float32 runs from jittered weights: with
                             # the CPU's own, the samples of float32's reach
TRAIN_JITTER_SEED = 4100
TRAIN_LOSSES = ("gen/loss_total", "gen/loss_recon", "gen/loss_nce_cnt",
                "gen/loss_cyc")
TRAIN_ACCURACIES = {"gen/cnt_acc_top1": 1, "gen/cnt_acc_top5": 5}
TRAIN_CHARACTERIZE_CLIPS, TRAIN_CHARACTERIZE_FRAMES = 4, 240
EPOCH_LINE = re.compile(r"epoch \d+/\d+ loss_total=\S+ \(([\d.]+)s\)")


@contextlib.contextmanager
def timed_train_steps(dev):
    """Inside the block, every GeneratorTrainer.train_step marks its start
    (a CUDA event on the card, the host clock on the CPU) and the last one
    its end too, and its host time is taken; the yielded lists of step
    periods and host times (ms) fill when the block ends.  A period runs
    from one step's start to the next's on the device's timeline: the
    device time of a step when the host keeps ahead, the host's when it
    does not."""
    real, marks, periods, host = GeneratorTrainer.train_step, [], [], []

    def mark():
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def timed(self, *args, **kw):
        marks.append(mark())
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kw)
        finally:
            host.append((time.perf_counter() - t0) * 1e3)

    GeneratorTrainer.train_step = timed
    try:
        yield periods, host
    finally:
        GeneratorTrainer.train_step = real
        marks.append(mark())
        sync(dev)
        periods.extend(a.elapsed_time(b) if dev.type == "cuda"
                       else (b - a) * 1e3 for a, b in zip(marks, marks[1:]))


TRAIN_PROFILE_STEPS = 3


def profile_train_steps(trainer, ds, dev, seed, steps=TRAIN_PROFILE_STEPS):
    """``steps`` train steps of ``trainer`` under torch.profiler on the
    card (after one unprofiled): wall, kernel time, device idle share,
    kernel launches and the top kernels.  Not measured on the CPU."""
    if dev.type != "cuda":
        return "not measured"
    batches = iterate_batches(ds, int(trainer.config["batch_size"]),
                              seed=seed)
    bs, bc = (trainer.on_device(next(batches)) for _ in range(2))
    norm = trainer.on_device(ds.norm)
    key = torch.Generator().manual_seed(seed)

    def run(n):
        for _ in range(n):
            trainer.train_step(bs, bc, norm, key)

    run(1)
    _, wall, rows, _ = profiled(lambda: run(steps))
    out = summarize(f"{steps} train steps", wall, rows)
    out["kernel_launches_per_step"] = out["kernel_launches"] / steps
    return out


def read_metrics(path):
    """{tag: [values in step order]} from a MetricsLogger JSONL file."""
    out = {}
    for line in open(path):
        rec = json.loads(line)
        out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return {k: [v for _, v in sorted(vals)] for k, vals in out.items()}


def near_ties(logits, k, tol):
    """Rows whose positive logit (column 0) lies within ``tol`` of the k-th
    largest negative: rows whose top-k hit a rounding of the logits within
    ``tol`` can flip."""
    kth = torch.topk(logits[:, 1:], k, dim=1).values[:, -1]
    return int((torch.abs(logits[:, 0] - kth) <= tol).sum())


class _SignedAbs(torch.autograd.Function):
    """|x| whose gradient is grad * s for the given signs s."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(s)
        return x.abs()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.saved_tensors[0], None


class PinnedChoices(TorchFunctionMode):
    """Within the block, each piecewise choice a forward makes (the sign of
    every torch.abs input: the L1 losses; the condition of every
    torch.where: leaky ReLU and the kinematics' branches; the mask of
    every ReLU) is recorded, in call order, or with ``choices`` replayed
    from another run; ``flips`` counts the elements whose own choice the
    replay overrode.  An element within rounding of a kink may fall on
    either side on two devices, and an L1 term's side moves that element's
    gradient by 2 w / N: with the choices pinned, two runs' gradients
    differ by rounding alone."""

    def __init__(self, choices=None):
        super().__init__()
        self.replay, self.choices, self.flips = choices, [], 0

    def choose(self, own):
        if self.replay is None:
            self.choices.append(own.cpu())
            return own
        pinned = self.replay[len(self.choices)].to(own.device)
        self.choices.append(pinned)
        self.flips += int((pinned != own).sum())
        return pinned

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.abs, torch.Tensor.abs):
            x = args[0]
            s = self.choose(torch.sign(x.detach()).to(torch.int8))
            return _SignedAbs.apply(x, s.to(x.dtype))
        if func is torch.where and len(args) == 3:
            return func(self.choose(args[0]), *args[1:])
        if func in (torch.relu, F.relu):
            x = args[0]
            return x * self.choose(x.detach() > 0).to(x.dtype)
        return func(*args, **kwargs)


@contextlib.contextmanager
def norm_spreads():
    """Within the block, every mean_variance_norm call of the layers (each
    AdaIN's input, the AdaIN attention's queries and keys) appends to the
    yielded list the least ratio, over samples and channels, of its
    tokens' spread to their offset, std / (|mean| + std): x - mean(x)
    keeps about that share of float32's digits.  Where a decoder AdaIN's
    gain 1 + gamma nears 0 (gamma, a linear layer's output, near -1), its
    output's spread is |1 + gamma| beside an offset beta, and float32
    keeps little of it: the step is ill-conditioned in float32 on every
    device, the JAX package's included."""
    real, seen = layers.mean_variance_norm, []

    def watched(x, eps=1e-5):
        a = x.detach().double().cpu().numpy()
        s = a.std(axis=-2, ddof=1)
        seen.append(float((s / (np.abs(a.mean(axis=-2)) + s + 1e-300))
                          .min()))
        return real(x, eps)

    layers.mean_variance_norm = watched
    try:
        yield seen
    finally:
        layers.mean_variance_norm = real


def jitter_weights(modules, seed):
    """Move every weight of ``modules`` one float spacing up or down, the
    side drawn from ``seed``: a perturbation of the size of one rounding,
    so that a backward from the moved weights samples the float error the
    step carries at these weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                up = torch.rand(p.shape, generator=g) < 0.5
                p.copy_(torch.nextafter(p, torch.where(
                    up, math.inf, -math.inf).to(p)))


def parity_backward(config, ckpt_path, bs, bc, norm, seed, device, dtype,
                    choices=None, step=False, jitter=None):
    """One backward of the checkpoint's weights on the batches ``bs`` and
    ``bc`` (dropout off) on ``device`` in ``dtype``, replaying the
    piecewise ``choices`` of another run (None: its own, recorded), the
    weights moved by :func:`jitter_weights` from the seed ``jitter`` if it
    is given.  Returns the metrics, the gradients and the NCE logits
    (float64, on the CPU), the PinnedChoices, the least norm_spreads ratio
    and, with ``step``, whether the weights are finite after update()."""
    t = GeneratorTrainer(dict(config, dropout=False), 1, seed=seed,
                         device=device)
    t.load(ckpt_path)
    if jitter is not None:
        jitter_weights((t.gen, t.prj), jitter)
    if dtype == torch.float64:
        t.gen.double()
        t.prj.double()
        bs, bc, norm = ({k: torch.as_tensor(v).double() for k, v in
                         tree.items()} for tree in (bs, bc, norm))
    with PinnedChoices(choices) as pin, norm_spreads() as spreads:
        metrics, logits = t.backward(bs, bc, norm)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {f"{part}.{n}": p.grad.detach().double().cpu()
                     for part, m in (("gen", t.gen), ("prj", t.prj))
                     for n, p in m.named_parameters()},
           "logits": logits.detach().double().cpu(), "pin": pin,
           "spread": min(spreads)}
    if step:
        t.update()
        out["finite"] = all(bool(torch.isfinite(p).all()) for p in
                            (*t.gen.parameters(), *t.prj.parameters(),
                             *t.gen_ema.parameters()))
    return out


def judge(d32, c32, c64, d64, bound32, bound64, jittered=()):
    """A quantity of the step against its bars (elementwise tensors of
    tolerances: ``bound32`` from the CPU's float32 values, ``bound64``
    from float64's): the float32 card-to-CPU gap (``of_bar``), the CPU's
    float32 distance to float64 (``cpu_f64_of_bar``), the farthest of the
    CPU's float32 runs from ``jittered`` weights (``jittered_f64_of_bar``)
    and the float64 card-to-CPU gap over TRAIN_F64_SCALE x ``bound64``
    (``f64_of_bar``), each as its largest share of the bar.  The float32
    comparison decides where every CPU float32 run lies within
    TRAIN_DECIDES = 1 / (1 + TRAIN_F64_RATIO) of its bar from float64:
    there the bar leaves the card at least TRAIN_F64_RATIO times the
    CPU's distance to float64, as the ratio gate does.  A CPU run farther
    off marks a quantity that float32 does not resolve at this step (two
    float32 runs land several times apart there), and the float64
    comparison decides it.  The float64 comparison always holds.  Returns
    (row, failed)."""
    row = {"of_bar": float(((d32 - c32).abs() / bound32).max()),
           "cpu_f64_of_bar": float(((c32 - c64).abs() / bound64).max()),
           "jittered_f64_of_bar": max(
               (float(((j - c64).abs() / bound64).max()) for j in jittered),
               default=0.0),
           "f64_of_bar": float(((d64 - c64).abs()
                                / (TRAIN_F64_SCALE * bound64)).max())}
    row["decided"] = max(row["cpu_f64_of_bar"],
                         row["jittered_f64_of_bar"]) <= TRAIN_DECIDES
    failed = ((row["decided"] and row["of_bar"] > 1.0)
              or row["f64_of_bar"] > 1.0)
    return row, failed


def gradient_gate(g_d, g_c, g64, g_d64, jit, dev, failures, undecided):
    """The training step's gradients (dicts of float64 tensors by name:
    ``dev``'s float32, the CPU's, float64 on the CPU and on ``dev``, and
    ``jit``, the CPU's float32 runs from jittered weights) against their
    bars, as :func:`train_parity` holds them.  Appends what fails to
    ``failures`` and what float64 alone decides to ``undecided``; returns
    the rows by tensor, the distance ratios and their median."""
    # the gradients: each tensor's bar scaled by its own largest |g|; a
    # tensor whose float64 gradient vanishes (decoder layer 0's ff.w2.bias,
    # removed by layer 1's instance norm) carries only rounding on every
    # device and takes its atol from the model's largest |g|
    gscale = max(float(g.abs().max()) for g in g_c.values())
    gscale64 = max(float(g.abs().max()) for g in g64.values())
    eps = float(torch.finfo(torch.float32).eps)
    per_tensor = {}
    for name, c in g_c.items():
        scale, scale64 = float(c.abs().max()), float(g64[name].abs().max())
        vanishes = scale64 < TRAIN_GRAD_VANISH * gscale64
        row, failed = judge(
            g_d[name], c, g64[name], g_d64[name],
            TRAIN_GRAD_RTOL * c.abs()
            + TRAIN_GRAD_ATOL * (gscale if vanishes else scale),
            TRAIN_GRAD_RTOL * g64[name].abs()
            + TRAIN_GRAD_ATOL * (gscale64 if vanishes else scale64),
            [j[name] for j in jit])
        row.update({
            "max_abs": float((g_d[name] - c).abs().max()), "max_g": scale,
            "max_g_f64": scale64, "vanishes": vanishes,
            "f64_" + dev: float((g_d[name] - g64[name]).abs().max()),
            "f64_cpu": float((c - g64[name]).abs().max()),
            "f64_cpu_jittered": max((float((j[name] - g64[name]).abs().max())
                                     for j in jit), default=0.0)})
        row["f64_cpu_reach"] = max(row["f64_cpu"], row["f64_cpu_jittered"])
        row["f64_ratio"] = None if vanishes else (
            row["f64_" + dev] / (row["f64_cpu_reach"] + eps * scale64))
        row["f64_ratio_to_cpu"] = None if vanishes else (
            row["f64_" + dev] / (row["f64_cpu"] + eps * scale64))
        per_tensor[name] = row
        if failed:
            failures.append(f"gradient {name} off (max |g| {scale:.3e}): "
                            f"{json.dumps(row)}")
        if not row["decided"]:
            undecided.append(f"gradient {name}")
    # against float64, each tensor's card distance over the farthest CPU
    # float32 run's (plus a float32 spacing at its scale): a fault hiding
    # within the bar, or in a tensor that float32 does not resolve, shows
    # as a tensor out of line with the rest.  One CPU run is one sample of
    # float32's error and may land far closer to float64 than float32's
    # reach at an ill-conditioned tensor (a decoder AdaIN near gain 0:
    # 1.2e-8 once, 4.2e-6 in another run); the jittered runs sample it
    # again.  The card's float32 may be uniformly less exact than the
    # CPU's, by a factor that moves with the kernels it picks; a uniformly
    # more exact card raises no bar
    ratios = {n: r["f64_ratio"] for n, r in per_tensor.items()
              if r["f64_ratio"] is not None}
    median = float(np.median(list(ratios.values())))
    for name, ratio in ratios.items():
        if ratio > TRAIN_F64_RATIO * max(1.0, median):
            failures.append(
                f"gradient {name} {per_tensor[name]['f64_' + dev]:.3e}"
                f" from float64 on {dev}, {ratio:.2f}x the farthest "
                f"CPU float32 run's {per_tensor[name]['f64_cpu_reach']:.3e},"
                f" over {TRAIN_F64_RATIO} x max(1, the median ratio "
                f"{median:.3f})")
    return per_tensor, ratios, median


def train_parity(config, ckpt_path, ds, dev, seed):
    """One step of the checkpoint's weights on ``dev`` and on the CPU on
    the same batch (dropout off), in float32 and in float64, and
    TRAIN_JITTERS CPU float32 backwards from jittered weights, the CPU's,
    the jittered and both float64 runs replaying the card's piecewise
    choices.  Held (see :func:`judge`): each loss within TRAIN_LOSS_RTOL,
    the NCE logits within TRAIN_LOSS_RTOL of the largest positive, each
    gradient before the clip within TRAIN_GRAD_RTOL / TRAIN_GRAD_ATOL x
    the tensor's largest |g|; no gradient's distance to float64 on the
    card over the farthest CPU float32 run's past TRAIN_F64_RATIO x
    max(1, the ratios' median); each top-k accuracy
    within the share of rows that the
    logits' measured gap can flip; the stepped weights finite on both.
    Returns (gaps, the failures)."""
    batches = iterate_batches(ds, TRAIN_PARITY_BATCH, seed=seed)
    common = (config, ckpt_path, next(batches), next(batches), ds.norm,
              seed)
    cpu = torch.device("cpu")
    d32 = parity_backward(*common, dev, torch.float32, step=True)
    choices = d32["pin"].choices
    c32 = (d32 if dev == cpu else
           parity_backward(*common, cpu, torch.float32, choices, step=True))
    jit = [parity_backward(*common, cpu, torch.float32, choices,
                           jitter=TRAIN_JITTER_SEED + k)
           for k in range(TRAIN_JITTERS)]
    c64 = parity_backward(*common, cpu, torch.float64, choices)
    d64 = (c64 if dev == cpu else
           parity_backward(*common, dev, torch.float64, choices))
    failures, undecided = [], []
    if not (d32["finite"] and c32["finite"]):
        failures.append("non-finite weights after the step")
    gaps = {"pinned_choices": {
        "elements": sum(c.numel() for c in choices),
        "flips": {"cpu": c32["pin"].flips, "float64": c64["pin"].flips,
                  f"float64 on {dev.type}": d64["pin"].flips,
                  "cpu jittered": [r["pin"].flips for r in jit]}},
        "least_norm_spread": {"float32": d32["spread"],
                              "float64": c64["spread"]}}

    def held(name, row, failed, what):
        if failed:
            failures.append(f"{name} {what}: {json.dumps(row)}")
        if not row["decided"]:
            undecided.append(name)

    # the losses, and the NCE logits that the accuracies rank
    for name in TRAIN_LOSSES:
        vals = [torch.tensor(r["metrics"][name], dtype=torch.float64)
                for r in (d32, c32, c64, d64)]
        row, failed = judge(*vals, TRAIN_LOSS_RTOL * vals[1].abs(),
                            TRAIN_LOSS_RTOL * vals[2].abs(),
                            [torch.tensor(r["metrics"][name],
                                          dtype=torch.float64) for r in jit])
        row.update({dev.type: float(vals[0]), "cpu": float(vals[1]),
                    "float64": float(vals[2])})
        gaps[name] = row
        held(name, row, failed, "off")
    logits = [r["logits"] for r in (d32, c32, c64, d64)]
    row, failed = judge(*logits, *(TRAIN_LOSS_RTOL * float(l[:, 0].abs()
                                                           .max())
                                   for l in logits[1:3]),
                        [r["logits"] for r in jit])
    noise = float((logits[0] - logits[1]).abs().max())
    row["max_abs"] = noise
    gaps["nce_logits"] = row
    held("NCE logits", row, failed, "off")
    for name, k in TRAIN_ACCURACIES.items():
        ties = near_ties(logits[1], k, 2 * noise)
        bar = 100.0 * ties / logits[1].shape[0]
        a, b = d32["metrics"][name], c32["metrics"][name]
        gaps[name] = {"abs": abs(a - b), "bar": bar, "near_ties": ties,
                      dev.type: a, "cpu": b}
        if gaps[name]["abs"] > bar + 1e-3:
            failures.append(f"{name} {a} on {dev.type}, {b} on the CPU, "
                            f"over its bar {bar} ({ties} rows within "
                            f"{2 * noise:.3e} of a flip)")
    g_d, g_c, g64, g_d64 = (r["grads"] for r in (d32, c32, c64, d64))
    per_tensor, ratios, median = gradient_gate(
        g_d, g_c, g64, g_d64, [r["grads"] for r in jit], dev.type, failures,
        undecided)
    gscale = max(float(g.abs().max()) for g in g_c.values())
    gaps["gradients"] = {
        "tensors": len(g_c), "max_g_all": gscale,
        "vanishing": sorted(n for n, r in per_tensor.items()
                            if r["vanishes"]),
        "f64_ratio_median": median, "jittered_runs": TRAIN_JITTERS}
    gaps["decided_in_float64_alone"] = undecided
    gaps["float32_misses"] = sorted(n for n, r in per_tensor.items()
                                    if r["of_bar"] > 1.0)
    for key, among in (("of_bar", per_tensor), ("f64_of_bar", per_tensor),
                       ("cpu_f64_of_bar", per_tensor),
                       ("jittered_f64_of_bar", per_tensor),
                       ("f64_ratio", ratios), ("f64_ratio_to_cpu", ratios)):
        worst = max(among, key=lambda n: per_tensor[n][key])
        gaps["gradients"]["worst_" + key] = {"tensor": worst,
                                             **per_tensor[worst]}
    log(f"[train] {dev.type} vs cpu, one step at batch "
        f"{TRAIN_PARITY_BATCH}: {json.dumps(gaps)}")
    log(f"[train] gradient gaps by tensor: {json.dumps(per_tensor)}")
    return gaps, failures


def train_phase(cfg, dev, root, *, config=None, epochs=TRAIN_EPOCHS,
                characterize_clips=TRAIN_CHARACTERIZE_CLIPS,
                characterize_frames=TRAIN_CHARACTERIZE_FRAMES):
    """Phase 11, on the dataset phase's files in ``root`` (``data/`` and
    ``bvh/``): cli/train.main for ``epochs`` epochs (every loss finite, the
    last LOSS_WINDOW logged loss_total values' mean under the first's, no
    attention launched), one step held to the CPU, then characterize
    --gen-ckpt on the written checkpoint (its EMA served through the
    kernel, exactly the launches its windows and frames imply).
    ``config`` defaults to the port's own, which has the full widths.
    Returns (result, float32 launches of the characterize call)."""
    t_phase = time.perf_counter()
    config = config or characterize.DEFAULT_CONFIG
    data = os.path.join(root, "data")
    work = os.path.join(root, "train")
    os.makedirs(work)
    reset_launches()
    reset_peak_memory(dev)
    with contextlib.chdir(work), timed_train_steps(dev) as (periods, host):
        trainer, main_s, said = quiet(train_cli.main, [
            "--config", config, "--data-dir", data, "--max-epochs",
            str(epochs), "--device", dev.type])
    peak_gb = peak_memory_gb(dev)
    training_launches = all_launches()
    check(not any(training_launches.values()),
          f"train: attention kernels launched while training: "
          f"{training_launches}")
    model = os.path.join(work, trainer.config["name"])
    metrics = read_metrics(os.path.join(model, "log", "train",
                                        "metrics.jsonl"))
    batch = int(trainer.config["batch_size"])
    steps = trainer.step
    check(steps == len(periods) and steps > STEP_WARMUP,
          f"train: {steps} steps, {len(periods)} timed")
    check(all(np.isfinite(v).all() for v in metrics.values()),
          "train: a logged metric is not finite")
    loss = metrics["gen/loss_total"]
    check(len(loss) >= LOSS_WINDOW,
          f"train: {len(loss)} logged losses, want {LOSS_WINDOW} or more")
    first, last = np.mean(loss[:LOSS_WINDOW]), np.mean(loss[-LOSS_WINDOW:])
    check(last < first, f"train: loss_total mean of the last {LOSS_WINDOW} "
          f"logged values {last:.4f} is not under the first's {first:.4f}")
    step_ms = float(np.median(periods[STEP_WARMUP:]))
    host_ms = float(np.median(host[STEP_WARMUP:]))
    epoch_s = [float(s) for s in EPOCH_LINE.findall(said)]
    ckpt_path = train_ckpt.latest_checkpoint(os.path.join(model, "pth"))
    check(ckpt_path is not None
          and train_ckpt.epoch_from_path(ckpt_path) == epochs,
          f"train: checkpoint {ckpt_path}")
    log(f"[train] cli/train {epochs} epoch(s), {steps} steps at batch "
        f"{batch}: step {step_ms:.2f} ms (median after {STEP_WARMUP}; host "
        f"{host_ms:.2f} ms in the call), "
        f"epoch wall {epoch_s} s, main() {main_s:.2f} s, peak "
        f"{peak_gb:.2f} GB; loss_total first {LOSS_WINDOW} {first:.4f}, "
        f"last {LOSS_WINDOW} {last:.4f}")

    seed = int(trainer.config.get("manualSeed", 1777))
    ds = MotionDataset(data, device=dev)
    profile_result = profile_train_steps(trainer, ds, dev, seed)
    log(f"[train] profile: {json.dumps(profile_result)}")
    parity, failures = train_parity(get_config(config), ckpt_path, ds, dev,
                                    seed)
    del ds, trainer

    src = os.path.join(work, "src")
    os.makedirs(src)
    for i in range(characterize_clips):
        bvh.save(os.path.join(src, f"clip_{i:02d}.bvh"),
                 make_mocha_bvh_data(T=characterize_frames, seed=4000 + i))
    cha = os.path.join(root, "bvh", dataset_names(1)[0] + ".bvh")
    out_dir = os.path.join(work, "characterized")
    _, char_s, _, char_launches = run_cli(
        ["--src-dir", src, "--cha", cha, "--gen-ckpt", ckpt_path,
         "--random-init", "--norm", os.path.join(data, "norm.npz"),
         "--device", dev.type, "--out", out_dir, "--config", config])
    cha_windows = len(padded_window_indices(bvh.load(cha)["positions"]
                                            .shape[0], 60, 1)[0])
    want = (cli_expected_launches(cfg, [characterize_frames]
                                  * characterize_clips)
            + -(-cha_windows // 128) * cfg.encoder_depth)
    check_launches(dev, char_launches == want,
                   f"train characterize: {char_launches} float32 launches, "
                   f"want {want}")
    n_out = len(padded_window_indices(characterize_frames, 60, 1)[0])
    outs = read_outputs(out_dir)
    check(len(outs) == 3 * characterize_clips,
          f"train characterize: {len(outs)} output files")
    for f, d in outs.items():
        check(d["rotations"].shape[0] == n_out
              and np.isfinite(d["rotations"]).all()
              and np.isfinite(d["positions"]).all(),
              f"train characterize: {f} has {d['rotations'].shape[0]} "
              f"frames (want {n_out}) or is not finite")
    log(f"[train] characterize --gen-ckpt {os.path.basename(ckpt_path)} "
        f"on {characterize_clips} clips: {char_s:.2f} s, {char_launches} "
        "float32 launches; every output parses back finite with its frame "
        "count")
    result = {
        "epochs": epochs, "steps": steps, "batch": batch,
        "step_ms_median": step_ms,
        "steps_per_s": 1e3 / step_ms, "samples_per_s": batch * 1e3 / step_ms,
        "step_ms_range": [float(min(periods)), float(max(periods))],
        "step_host_ms_median": host_ms,
        "epoch_s": epoch_s, "train_main_s": main_s,
        "peak_memory_gb": peak_gb,
        "loss_total_first": float(first), "loss_total_last": float(last),
        "logged_values": len(loss), "training_launches": training_launches,
        "profile": profile_result, "parity": parity,
        "characterize_s": char_s,
        "characterize_float32_launches": char_launches,
        "phase_s": time.perf_counter() - t_phase}
    log(f"[train] {json.dumps(result)}")
    check(not failures, "train parity: " + "; ".join(failures))
    return result, char_launches


CVAE_SOURCE_STYLE = 2           # Neutral_AverageJoe in configs/dataset.yaml
CVAE_ITERS = 40
CVAE_WARMUP = 5                 # iterations left out of the period median
CVAE_CHARACTERIZE_CLIPS = 4
CVAE_METRICS = ("cvae/encoded_loss", "cvae/kl_loss", "cvae/cnt_loss",
                "cvae/dist_loss")
# one rollout on the card against the CPU (tests/test_train.py:640-667):
# metric rtols, the mean parameter gap as a share of the mean update, and
# the largest gap in units of lr (R - 1)
CVAE_METRIC_RTOL = (2e-3, 5e-2, 1e-2, 1e-2)
CVAE_PARAM_SHARE = 0.2
CVAE_PARAM_MAX_LR = 10.0
CVAE_BF16_SHARE = 0.05          # bf16 metrics to float32 (:489-523)


@contextlib.contextmanager
def timed_cvae_iterations(dev):
    """Inside the block, every CVAETrainer.step_placed marks its start (a
    CUDA event on the card, the host clock on the CPU), the last one its
    end too, and its host time is taken; every sample_batch's host time
    is taken (in the prefetch thread).  The yielded lists of iteration
    periods, step host times and sample_batch times (ms) fill when the
    block ends."""
    step, sample = CVAETrainer.step_placed, CVAETrainer.sample_batch
    marks, periods, host, sampled = [], [], [], []

    def mark():
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def timed_step(self, *args, **kw):
        marks.append(mark())
        t0 = time.perf_counter()
        try:
            return step(self, *args, **kw)
        finally:
            host.append((time.perf_counter() - t0) * 1e3)

    def timed_sample(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return sample(self, *args, **kw)
        finally:
            sampled.append((time.perf_counter() - t0) * 1e3)

    CVAETrainer.step_placed, CVAETrainer.sample_batch = timed_step, \
        timed_sample
    try:
        yield periods, host, sampled
    finally:
        CVAETrainer.step_placed, CVAETrainer.sample_batch = step, sample
        marks.append(mark())
        sync(dev)
        periods.extend(a.elapsed_time(b) if dev.type == "cuda"
                       else (b - a) * 1e3 for a, b in zip(marks, marks[1:]))


@contextlib.contextmanager
def reparameterize_to_mu():
    """z = mu in every CVAE forward (the noise cannot be matched across
    devices)."""
    real = cvae_mod.reparameterize
    cvae_mod.reparameterize = lambda generator, mu, logvar: mu
    try:
        yield
    finally:
        cvae_mod.reparameterize = real


def cvae_trainer_like(trainer, files, tc, dev):
    """A CVAETrainer of config ``tc`` on ``dev`` over the feature arrays of
    ``trainer`` (the CLI's) and the labels and ranges of ``files`` (source
    features, character features, cnt_norm.npz)."""
    src, cha, cnt = (np.load(f) for f in files)
    return CVAETrainer(
        tc, src_cnt=trainer.src_cnt, src_action=src["action_label"],
        src_range_starts=src["range_starts"],
        src_range_stops=src["range_stops"], cha_cnt=trainer.cha_cnt,
        cha_encoded=trainer.cha_encoded, cha_action=cha["action_label"],
        cha_range_starts=cha["range_starts"],
        cha_range_stops=cha["range_stops"], cnt_mean=cnt["mean"],
        cnt_std=cnt["std"], target_actions=trainer.target_actions,
        device=dev)


def cvae_rollout(trainer, state, batch, student_p, anneal_w):
    """One rollout of ``trainer`` from the weights ``state`` (a fresh
    optimizer) on the host ``batch``; returns (metrics, float64 parameters
    after it, on the CPU)."""
    trainer.restart(state)
    m = trainer.rollout(*(torch.as_tensor(a, device=trainer.device)
                          for a in batch), student_p, anneal_w,
                        torch.Generator(device=trainer.device).manual_seed(0))
    flat = torch.cat([p.detach().double().cpu().ravel()
                      for p in trainer.cvae.parameters()])
    return m.double().cpu().numpy(), flat


def cvae_parity(trainer, files, dev):
    """One iteration from the trained weights and one batch on ``dev`` and
    on the CPU (dropout and condition dropout 0, z = mu), teacher-forced
    and student-forced, held to the bars of tests/test_train.py:640-667;
    then one iteration with bf16 forwards on ``dev`` against float32's
    (masters float32, finite, metrics within 5%)."""
    tc = trainer.tc._replace(dropout=0.0, condition_dropout=0.0)
    state = {k: v.detach().cpu() for k, v in
             trainer.cvae.state_dict().items()}
    batch = None
    while batch is None:
        batch = trainer.sample_batch(0)
    anneal_w = 0.7
    init = torch.cat([v.double().ravel() for v in state.values()])
    bound_max = CVAE_PARAM_MAX_LR * tc.lr * (tc.rollout_steps - 1)
    out, failures = {"batch": list(batch[0].shape)}, []
    card = cvae_trainer_like(trainer, files, tc, dev)
    cpu = cvae_trainer_like(trainer, files, tc, torch.device("cpu"))
    with reparameterize_to_mu():
        for student_p in (0.0, 1.0):
            m_dev, p_dev = cvae_rollout(card, state, batch, student_p,
                                        anneal_w)
            m_cpu, p_cpu = cvae_rollout(cpu, state, batch, student_p,
                                        anneal_w)
            rel = np.abs(m_dev - m_cpu) / np.abs(m_cpu)
            upd = float((p_cpu - init).abs().mean())
            gap = (p_dev - p_cpu).abs()
            row = {"metrics_card": m_dev.tolist(),
                   "metrics_cpu": m_cpu.tolist(),
                   "metric_rel": dict(zip(CVAE_METRICS, rel.tolist())),
                   "metric_rtol": dict(zip(CVAE_METRICS, CVAE_METRIC_RTOL)),
                   "param_mean_gap": float(gap.mean()),
                   "param_mean_update": upd,
                   "param_mean_gap_bar": CVAE_PARAM_SHARE * upd,
                   "param_max_gap": float(gap.max()),
                   "param_max_gap_bar": bound_max}
            tag = f"student_p {student_p:g}"
            out[tag] = row
            for name, r, bar in zip(CVAE_METRICS, rel, CVAE_METRIC_RTOL):
                if not r <= bar:
                    failures.append(f"{tag} {name} rel {r:.3g} > {bar}")
            if not upd > 1e-5:
                failures.append(f"{tag}: the rollout moved no weight")
            if not row["param_mean_gap"] < row["param_mean_gap_bar"]:
                failures.append(f"{tag}: mean parameter gap "
                                f"{row['param_mean_gap']:.3g} >= "
                                f"{row['param_mean_gap_bar']:.3g}")
            if not row["param_max_gap"] < bound_max:
                failures.append(f"{tag}: largest parameter gap "
                                f"{row['param_max_gap']:.3g} >= "
                                f"{bound_max:.3g}")
            log(f"[cvae] parity {tag}: metric rel "
                + ", ".join(f"{n.split('/')[1]} {r:.3g} (bar {b})" for n, r, b
                            in zip(CVAE_METRICS, rel, CVAE_METRIC_RTOL))
                + f"; parameters mean gap {row['param_mean_gap']:.3g} (bar "
                f"{row['param_mean_gap_bar']:.3g} = {CVAE_PARAM_SHARE} x mean "
                f"update {upd:.3g}), largest {row['param_max_gap']:.3g} (bar "
                f"{bound_max:.3g})")
        del cpu
        m32 = np.asarray(out["student_p 0"]["metrics_card"])
        bf16 = cvae_trainer_like(trainer, files,
                                 tc._replace(compute_dtype="bfloat16"), dev)
        mbf, pbf = cvae_rollout(bf16, state, batch, 0.0, anneal_w)
    masters = all(p.dtype == torch.float32 for p in bf16.cvae.parameters())
    share = {n: float(abs(a - b) / max(abs(a), 1.0))
             for n, a, b in zip(CVAE_METRICS, m32, mbf)}
    out["bf16"] = {"metrics_float32": m32.tolist(),
                   "metrics_bf16": mbf.tolist(), "share": share,
                   "bar": CVAE_BF16_SHARE, "masters_float32": masters,
                   "finite": bool(np.isfinite(mbf).all()
                                  and torch.isfinite(pbf).all())}
    if not (masters and out["bf16"]["finite"]):
        failures.append(f"bf16: masters float32 {masters}, finite "
                        f"{out['bf16']['finite']}")
    for n in ("cvae/encoded_loss", "cvae/cnt_loss", "cvae/dist_loss"):
        if not share[n] <= CVAE_BF16_SHARE:
            failures.append(f"bf16 {n}: {share[n]:.3g} of float32's > "
                            f"{CVAE_BF16_SHARE}")
    log(f"[cvae] bf16 iteration: " + ", ".join(
        f"{n.split('/')[1]} {share[n]:.3g}" for n in CVAE_METRICS)
        + f" of float32's (bar {CVAE_BF16_SHARE} on enc, cnt, dist); masters "
        f"float32 {masters}; finite {out['bf16']['finite']}")
    return out, failures


def cvae_phase(cfg, dev, root, *, config=None, iters=CVAE_ITERS,
               source_style=CVAE_SOURCE_STYLE,
               characterize_clips=CVAE_CHARACTERIZE_CLIPS,
               clips=DATASET_CLIPS, frames=DATASET_FRAMES):
    """Phase 12, on the dataset phase's files in ``root``: (a) the source
    style's collect_features character export over the character's
    actions, on the same --random-init generator; (b) cli/train_cvae at
    the config's cvae section for ``iters`` iterations: no attention
    kernel launched, every logged value finite, the iteration period by
    CUDA events, sample_batch's host time and its share, peak memory;
    (c, d) cvae_parity; (e) characterize --src-dir on
    ``characterize_clips`` of the phase's clips with --cvae-ckpt on the
    written checkpoint and its --cvae-norm, outputs finite and exactly
    the tuned launches its windows and frames imply.  Returns (result,
    float32 launches of the characterize call)."""
    t_phase = time.perf_counter()
    config = config or characterize.DEFAULT_CONFIG
    data, bvh_dir = os.path.join(root, "data"), os.path.join(root, "bvh")
    work = os.path.join(root, "cvae")
    os.makedirs(work)
    src_path = os.path.join(root, "source_feature.npz")
    cha_path = os.path.join(root, "princess_feature.npz")
    exp = character_expected(cfg, source_style, clips, frames)
    reset_launches()
    feats, export_s, _ = quiet(collect_features.main, [
        "character", "--data-dir", data, "--random-init", "--device",
        dev.type, "--config", config, "--styles", str(source_style),
        "--actions", *map(str, DATASET_CHARACTER_ACTIONS), "--out",
        src_path])
    export_launches = check_tuned_launches(dev, "cvae source export",
                                           exp["launches"])
    check(feats["encoded"].shape[0] == exp["windows"]
          and len(feats["range_starts"]) == exp["ranges"],
          f"cvae source export: {feats['encoded'].shape[0]} windows in "
          f"{len(feats['range_starts'])} ranges, want {exp}")
    del feats
    log(f"[cvae] source export (style {source_style}) {export_s:.2f} s for "
        f"{exp['windows']} windows, {export_launches} float32 launches")

    files = (src_path, cha_path, os.path.join(data, "cnt_norm.npz"))
    reset_launches()
    reset_peak_memory(dev)
    with timed_cvae_iterations(dev) as (periods, host, sampled):
        trainer, main_s, _ = quiet(train_cvae_cli.main, [
            "--config", config, "--src-features", src_path,
            "--cha-features", cha_path, "--cnt-norm", files[2], "--out",
            work, "--num-iters", str(iters), "--device", dev.type])
    peak_gb = peak_memory_gb(dev)
    training_launches = all_launches()
    check(not any(training_launches.values()),
          f"cvae: attention kernels launched while training: "
          f"{training_launches}")
    tc = trainer.tc
    check(len(periods) == iters > CVAE_WARMUP
          and trainer.updates == iters * (tc.rollout_steps - 1),
          f"cvae: {len(periods)} iterations timed, {trainer.updates} "
          f"updates, want {iters} and {iters * (tc.rollout_steps - 1)}")
    metrics = read_metrics(os.path.join(work, "log", "metrics.jsonl"))
    check(all(np.isfinite(v).all() for v in metrics.values()),
          "cvae: a logged metric is not finite")
    enc = metrics["cvae/encoded_loss"]
    ckpt_path = os.path.join(work, f"cvae_{iters:06d}.ckpt")
    check(os.path.isfile(ckpt_path)
          and train_ckpt.load_checkpoint(ckpt_path)["iteration"] == iters
          and os.path.isfile(os.path.join(work, "cvae_norm.npz")),
          f"cvae: no {ckpt_path} of iteration {iters} or no cvae_norm.npz")
    period_ms = float(np.median(periods[CVAE_WARMUP:]))
    host_ms = float(np.median(host[CVAE_WARMUP:]))
    sample_ms = float(np.median(sampled[CVAE_WARMUP:]))
    rate = 1e3 / period_ms
    windows = tc.batch_size * tc.rollout_steps
    log(f"[cvae] cli/train_cvae {iters} iterations (batch {tc.batch_size}, "
        f"rollout {tc.rollout_steps}, latent {tc.latent_dim}, depth "
        f"{tc.depth}): period {period_ms:.2f} ms (median after "
        f"{CVAE_WARMUP}; host {host_ms:.2f} ms in step_placed), "
        f"{rate:.3f} iterations/s, {rate * (tc.rollout_steps - 1):.2f} "
        f"updates/s, {rate * windows:.1f} rollout windows/s; sample_batch "
        f"{sample_ms:.2f} ms ({sample_ms / period_ms:.3f} of the period); "
        f"main() {main_s:.2f} s; peak {peak_gb:.2f} GB; encoded_loss first "
        f"{enc[0]:.4f}, last {enc[-1]:.4f} ({len(enc)} logged, all finite)")

    parity, failures = cvae_parity(trainer, files, dev)
    del trainer

    src = os.path.join(work, "src")
    os.makedirs(src)
    names = dataset_names(clips)
    for name in names[:characterize_clips]:
        shutil.copy(os.path.join(bvh_dir, name + ".bvh"), src)
    cha = os.path.join(bvh_dir, names[0] + ".bvh")
    out_dir = os.path.join(work, "characterized")
    _, char_s, _, char_launches = run_cli(
        ["--src-dir", src, "--cha", cha, "--random-init", "--cvae-ckpt",
         ckpt_path, "--cvae-norm", os.path.join(work, "cvae_norm.npz"),
         "--norm", os.path.join(data, "norm.npz"), "--cnt-norm", files[2],
         "--device", dev.type, "--out", out_dir, "--config", config])
    # every clip, the character's too, has ``frames`` frames
    n_out = len(padded_window_indices(frames, 60, 1)[0])
    want = (cli_expected_launches(cfg, [frames] * characterize_clips)
            + -(-n_out // 128) * cfg.encoder_depth)
    check_launches(dev, char_launches == want,
                   f"cvae characterize: {char_launches} float32 launches, "
                   f"want {want}")
    outs = read_outputs(out_dir)
    check(len(outs) == 3 * characterize_clips,
          f"cvae characterize: {len(outs)} output files")
    for f, d in outs.items():
        check(d["rotations"].shape[0] == n_out
              and np.isfinite(d["rotations"]).all()
              and np.isfinite(d["positions"]).all(),
              f"cvae characterize: {f} has {d['rotations'].shape[0]} frames "
              f"(want {n_out}) or is not finite")
    log(f"[cvae] characterize --cvae-ckpt {os.path.basename(ckpt_path)} on "
        f"{characterize_clips} clips: {char_s:.2f} s, {char_launches} "
        "float32 launches; every output parses back finite with its frame "
        "count")
    result = {
        "iterations": iters, "batch": tc.batch_size,
        "rollout_steps": tc.rollout_steps, "latent_dim": tc.latent_dim,
        "depth": tc.depth, "nheads": tc.nheads,
        "feedforward_dim": tc.feedforward_dim, "dropout": tc.dropout,
        "condition_dropout": tc.condition_dropout, "tokens": tc.nseq,
        "source_export_s": export_s, "source_windows": exp["windows"],
        "source_export_float32_launches": export_launches,
        "period_ms_median": period_ms,
        "period_ms_range": [float(min(periods)), float(max(periods))],
        "iterations_per_s": rate,
        "updates_per_s": rate * (tc.rollout_steps - 1),
        "rollout_windows_per_s": rate * windows,
        "step_host_ms_median": host_ms,
        "sample_batch_ms_median": sample_ms,
        "sample_batch_share": sample_ms / period_ms,
        "train_main_s": main_s, "peak_memory_gb": peak_gb,
        "encoded_loss_first": float(enc[0]),
        "encoded_loss_last": float(enc[-1]),
        "logged_values": len(enc), "training_launches": training_launches,
        "parity": parity, "characterize_s": char_s,
        "characterize_float32_launches": char_launches,
        "phase_s": time.perf_counter() - t_phase}
    log(f"[cvae] {json.dumps(result)}")
    check(not failures, "cvae parity: " + "; ".join(failures))
    return result, char_launches


def build_sources():
    """Every CUDA source of the port: one per tuned dtype, and the
    general kernel's."""
    return list(dict.fromkeys(src for kernels in attention.ROUTES.values()
                              for src, _, _ in kernels.values()))


def build_phase():
    """Every CUDA source of the port, one nvcc each, started together."""
    t0 = time.perf_counter()
    sources = build_sources()
    build.build_all(sources)
    for src in sources:
        info = build.BUILD_INFO[src]
        log(f"[build] {src}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            log(f"[build]   {line}")
    for route, kernels in attention.ROUTES.items():
        for dtype in kernels:
            attention.load_library(dtype, route)
    log(f"[build] phase {time.perf_counter() - t0:.2f} s")


T_START = time.perf_counter()


def phase(name, fn, *args, **kw):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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

    phase("build", build_phase)
    attn_rows, edge_max_abs = phase("kernels", kernel_phase, dev)
    bf16_rows, bf16_edge_max_abs = phase("kernels (bf16)", kernel_phase, dev,
                                         torch.bfloat16)
    general_rows, general_max_abs, _, wide_launches = phase(
        "kernels (general)", general_phase, dev)

    cfg = GeneratorConfig()
    cvae_cfg = CVAEConfig(output_seq=cfg.num_tokens)
    # the shipped config never leaves the tuned kernels: the general
    # kernel's counter stays at 0 through every serving phase
    reset_launches()
    serving_general = {}

    def no_general(name):
        serving_general[name] = attention.fused_attention.launches_general
        check(serving_general[name] == 0,
              f"{name}: {serving_general[name]} general-kernel launches on "
              "the shipped config")

    slice_result, launches = phase(
        "slice", slice_phase, cfg, cvae_cfg, dev, streams=STREAMS,
        frames=FRAMES, db_windows=DB_WINDOWS, repeats=REPEATS)
    lo, hi = slice_result["e2e_frames_per_s_range"]
    log(f"[slice] median of {REPEATS}: e2e "
        f"{slice_result['e2e_frames_per_s']:.1f} frames/s (range {lo:.1f}-"
        f"{hi:.1f}), step loop {slice_result['step_loop_frames_per_s']:.1f} "
        f"frames/s on {card}")

    no_general("slice")
    phase("parity", parity_phase, cfg, cvae_cfg, dev)
    no_general("parity")

    with tempfile.TemporaryDirectory() as root:
        cli_result, cli_launches = phase("cli", cli_phase, cfg, dev, root)
        _, cli_bf16_launches = phase("cli --bf16", cli_bf16_run, cfg, dev,
                                     root)
    no_general("cli")
    lo, hi = cli_result["cli_frames_per_s_range"]
    log(f"[cli] median of {CLI_REPEATS}: {cli_result['cli_frames_per_s']:.1f}"
        f" frames/s through main() (range {lo:.1f}-{hi:.1f}), slice e2e "
        f"{slice_result['e2e_frames_per_s']:.1f} frames/s; BVH parse "
        f"{cli_result['bvh_parse_s']:.3f} s + export "
        f"{cli_result['export_s']:.3f} s = "
        f"{cli_result['parse_export_share']:.3f} of main(); on {card}")

    multi_result, multi_launches = phase("multi", multi_phase, cfg, cvae_cfg,
                                         dev)
    lo, hi = multi_result["step_loop_frames_per_s_range"]
    log(f"[multi] median of {REPEATS}: step loop "
        f"{multi_result['step_loop_frames_per_s']:.1f} frames/s (range "
        f"{lo:.1f}-{hi:.1f}) over {multi_result['characters']} characters, "
        f"{multi_result['step_loop_frames_per_s'] / slice_result['step_loop_frames_per_s']:.3f}"
        f" of the slice's; peak {multi_result['peak_memory_gb_f32']:.2f} GB; "
        f"on {card}")
    no_general("multi")
    live_result, live_launches = phase("live", live_phase, cfg, cvae_cfg, dev)
    no_general("live")
    log(f"[live] push_frame p50 {live_result['push_frame']['p50_ms']:.2f} ms "
        f"p99 {live_result['push_frame']['p99_ms']:.2f} ms; pipelined p50 "
        f"{live_result['push_frame_pipelined']['p50_ms']:.2f} ms p99 "
        f"{live_result['push_frame_pipelined']['p99_ms']:.2f} ms; budget "
        f"{BUDGET_MS:.1f} ms; on {card}")
    bf16_result, bf16_launches = phase("bf16", bf16_phase, cfg, cvae_cfg, dev)
    no_general("bf16")
    lo, hi = bf16_result["e2e_frames_per_s_range"]
    log(f"[bf16] median of {REPEATS}: e2e "
        f"{bf16_result['e2e_frames_per_s']:.1f} frames/s (range {lo:.1f}-"
        f"{hi:.1f}), {bf16_result['e2e_frames_per_s'] / slice_result['e2e_frames_per_s']:.3f}"
        f" of the float32 slice's; on {card}")

    with tempfile.TemporaryDirectory() as root:
        dataset_result, dataset_launches = phase("dataset", dataset_phase,
                                                 cfg, dev, root)
        no_general("dataset")
        train_result, train_launches = phase("train", train_phase, cfg, dev,
                                             root)
        no_general("train")
        cvae_result, cvae_launches = phase("cvae", cvae_phase, cfg, dev,
                                           root)
    no_general("cvae")
    log(f"[dataset] build {dataset_result['build_frames_per_s']:.1f} "
        f"frames/s ({dataset_result['frames']} frames, "
        f"{dataset_result['database_mb']:.1f} MB); encode "
        f"{dataset_result['cnt_norm_windows_per_s']:.1f} windows/s "
        f"(cnt-norm, {dataset_result['cnt_norm_windows']} windows) and "
        f"{dataset_result['character_windows_per_s']:.1f} windows/s "
        f"(character, {dataset_result['character_windows']} windows, of "
        f"which savez_compressed "
        f"{dataset_result['character_savez_compressed_s']:.3f} s); "
        f"characterize {dataset_result['characterize_s']:.3f} s for "
        f"{dataset_result['characterize_frames']} frames; phase "
        f"{dataset_result['phase_s']:.1f} s; on {card}")
    log(f"[train] steps/s {train_result['steps_per_s']:.3f}, samples/s "
        f"{train_result['samples_per_s']:.1f} at batch "
        f"{train_result['batch']} (median step "
        f"{train_result['step_ms_median']:.2f} ms after {STEP_WARMUP}); on "
        f"{card}")
    log(f"[train] step peak memory {train_result['peak_memory_gb']:.2f} GB;"
        f" on {card}")
    log(f"[train] epoch wall {train_result['epoch_s']} s "
        f"({train_result['steps']} steps); on {card}")
    log(f"[train] loss_total mean of the first {LOSS_WINDOW} logged values "
        f"{train_result['loss_total_first']:.4f}, of the last {LOSS_WINDOW} "
        f"{train_result['loss_total_last']:.4f}; on {card}")
    log(f"[cvae] iterations/s {cvae_result['iterations_per_s']:.3f}, "
        f"updates/s {cvae_result['updates_per_s']:.2f}, rollout windows/s "
        f"{cvae_result['rollout_windows_per_s']:.1f} (median period "
        f"{cvae_result['period_ms_median']:.2f} ms after {CVAE_WARMUP}); "
        f"sample_batch {cvae_result['sample_batch_ms_median']:.2f} ms, "
        f"{cvae_result['sample_batch_share']:.3f} of the period; on {card}")
    log(f"[cvae] peak memory {cvae_result['peak_memory_gb']:.2f} GB; phase "
        f"{cvae_result['phase_s']:.1f} s; on {card}")
    log(f"[cvae] encoded_loss first logged "
        f"{cvae_result['encoded_loss_first']:.4f}, last "
        f"{cvae_result['encoded_loss_last']:.4f}; on {card}")

    def kernel_entry(name, rows, edge, source, launches_by_path,
                     main_launches, design, shape="decoder streams"):
        main_row = next(r for r in rows if r["shape"] == shape)
        return {
            "name": name,
            "route": "cuda",
            "source": f"mocha_sigasia2023_torch/ops/csrc/{source}",
            "replaces": "mocha_sigasia2023_tpu/ops/attention.py:37",
            "launches": main_launches,
            "launches_by_path": launches_by_path,
            "max_abs_err": max([r["max_abs_err"] for r in rows] + [edge]),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "roofline_share")},
            "design": design,
            "shapes": rows,
        }

    general_paths = dict(serving_general)
    kernels = [
        kernel_entry("attention", attn_rows, edge_max_abs, attention.SOURCE,
                     {"slice": launches, "cli": cli_launches,
                      "multi": multi_launches, "live": live_launches,
                      "dataset": dataset_launches,
                      "train_steps": train_result["training_launches"][
                          "launches"],
                      "train_characterize": train_launches,
                      "cvae_iterations": cvae_result["training_launches"][
                          "launches"],
                      "cvae_characterize": cvae_launches},
                     launches, DESIGN),
        kernel_entry("attention_bf16", bf16_rows, bf16_edge_max_abs,
                     attention.SOURCE_BF16,
                     {"bf16": bf16_launches, "cli_bf16": cli_bf16_launches},
                     bf16_launches, DESIGN_BF16),
    ]
    for (dtype, rows), edge in zip(general_rows.items(), general_max_abs):
        name = "attention_general" + ("" if dtype == torch.float32
                                      else "_bf16")
        kernels.append(kernel_entry(
            name, rows, edge, attention.SOURCE_GENERAL,
            {**general_paths, "wide": wide_launches[dtype]},
            wide_launches[dtype], DESIGN_GENERAL, shape=GENERAL_SHAPE[0]))
    log(f"[time] whole script {time.perf_counter() - T_START:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
