"""The CUDA build's cache key: a library is named by the hash of its source,
every local header the source includes, and the compiler flags, so an
edited header rebuilds instead of loading a stale library.  Also
chip_smoke.py's build list and the launch counts its ``kernels (general)``,
``dataset``, ``train`` and ``cvae`` phases expect, computed from the config and
checked against the launches those phases make when rehearsed on the CPU
at small widths, and the velocity bar of its dataset parity.  Nothing here
needs nvcc."""

import contextlib
import dataclasses
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from mocha_sigasia2023_torch.cli import collect_features, generate_database
from mocha_sigasia2023_torch.data.dataset import MotionDataset
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data
from mocha_sigasia2023_torch.io import bvh
from mocha_sigasia2023_torch.models import layers
from mocha_sigasia2023_torch.models.generator import GeneratorConfig
from mocha_sigasia2023_torch.ops import attention, build
from mocha_sigasia2023_torch.utils import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    (src / "sub").mkdir(parents=True)
    _write(src / "kern.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n'
           "int f() { return A; }\n")
    _write(src / "a.cuh", '#pragma once\n#  include "sub/b.cuh"\n'
           "#define A B\n")
    _write(src / "sub" / "b.cuh", "#define B 1\n")
    _write(src / "other.cuh", "#define C 1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(src))
    return src


def test_local_files_follow_includes(tmp_path, monkeypatch):
    src = _csrc(tmp_path, monkeypatch)
    assert build.local_files("kern.cu") == [
        str(src / "kern.cu"), str(src / "a.cuh"), str(src / "sub" / "b.cuh")]


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    src = _csrc(tmp_path, monkeypatch)
    first = build.library_path("kern.cu")
    assert build.library_path("kern.cu") == first
    _write(src / "other.cuh", "#define C 2\n")   # not included
    assert build.library_path("kern.cu") == first
    _write(src / "sub" / "b.cuh", "#define B 2\n")   # included by a.cuh
    second = build.library_path("kern.cu")
    assert second != first
    _write(src / "a.cuh", '#pragma once\n#include "sub/b.cuh"\n#define A 3\n')
    assert build.library_path("kern.cu") not in (first, second)
    assert os.path.dirname(second) == build.BUILD_DIR


@pytest.mark.parametrize("source", ["attention.cu", "attention_bf16.cu"])
def test_attention_source_hashes_its_header(source):
    files = build.local_files(source)
    assert [os.path.basename(f) for f in files] == [source, "ptx.cuh",
                                                    "tma.cuh"]


def test_general_source_stands_alone():
    """The general kernel has one C entry per dtype, with the tuned
    kernels' arguments and the plan; the local header it includes
    (ptx.cuh) is hashed into its library name; the ints it reads from the
    plan are GeneralPlan's fields in order; both products run on the
    tensor cores (3xTF32 and bf16 mma.sync) and the tiles are staged by
    cp.async into dynamic shared memory.  No shape is refused: the entry
    refuses only an empty dimension or a plan that does not cover the call
    (tests/test_torch_general.py checks that every plan covers its call)."""
    files = build.local_files(attention.SOURCE_GENERAL)
    assert [os.path.basename(f) for f in files] == [
        attention.SOURCE_GENERAL, "ptx.cuh"]
    with open(files[0]) as f:
        text = f.read()
    for _, entry, counter in attention.GENERAL.values():
        assert f"MOCHA_GENERAL_ENTRY({entry}," in text
        assert counter == "launches_general"
    read = re.findall(r"(\w+) = plan\[(\d+)\]", text)
    names = [f.name for f in dataclasses.fields(attention.GeneralPlan)]
    assert [name for name, _ in read] == names
    assert [int(i) for _, i in read] == list(range(len(names)))
    assert f"points at the {len(names)} ints" in text
    for needle in ("ptx::mma_tf32x3(", "ptx::mma_bf16(", "ptx::cp_async<16>(",
                   "ptx::cp_async_wait<0>(", "ptx::ldmatrix_x4_trans(",
                   "extern __shared__"):
        assert needle in text, needle
    assert "__shared__ Smem" not in text
    refusals = [line for line in text.splitlines()
                if "return (int)cudaErrorInvalidValue;" in line]
    assert len(refusals) == 4   # empty dims; the plan's fields, buffer, smem
    assert "if (B < 1 || H < 1 || N < 1 || M < 1 || D < 1 || plan == " \
        "nullptr)" in text


@pytest.mark.parametrize("source", ["attention.cu", "attention_bf16.cu"])
def test_attention_releases_stages_behind_a_proxy_fence(source):
    """Consumers hand a ring stage back only through mbar_release_stage,
    which fences their shared-memory reads against the producer's next TMA
    write: a bare arrive on an "empty" barrier let that write overtake an
    earlier bf16 kernel's ldmatrix reads on an H100.  Every arrive on an
    "empty" barrier in the source is a release; the source has no arrive
    of its own."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        text = f.read()
    arrivals = [name for name in re.findall(r"ptx::(\w+)\(&empty\[", text)
                if name not in ("mbar_init", "mbar_wait")]
    assert arrivals and set(arrivals) == {"mbar_release_stage"}
    assert "mbarrier.arrive" not in text
    with open(os.path.join(build.CSRC_DIR, "ptx.cuh")) as f:
        ptx = f.read()
    body = ptx[ptx.index("void mbar_release_stage"):]
    body = body[:body.index("\n}\n")]
    assert body.index("fence.proxy.async.shared::cta") < body.index(
        "mbar_arrive(bar)")


def test_build_all_starts_one_compile_per_source(tmp_path, monkeypatch):
    """build_all launches every missing library's nvcc before waiting on
    any, and skips a library that exists."""
    src = _csrc(tmp_path, monkeypatch)
    _write(src / "two.cu", "int g() { return 2; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    started, waited = [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            started.append(os.path.basename(cmd[-1]))

        def communicate(self):
            waited.append(len(started))
            with open(self.out, "w") as f:
                f.write("lib")
            return "ptxas info", None

        def poll(self):
            return 0

    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    paths = build.build_all(["kern.cu", "two.cu"])
    assert started == ["kern.cu", "two.cu"] and waited == [2, 2]
    assert all(os.path.isfile(p) for p in paths.values())
    assert build.BUILD_INFO["two.cu"]["log"] == "ptxas info"
    assert build.build_all(["two.cu"]) == {"two.cu": paths["two.cu"]}
    assert started == ["kern.cu", "two.cu"]   # cached: no second compile


def test_stress_patches_apply_to_the_kernels():
    """scripts/attention_stress.py patches the shared header; each patch
    still finds its text, so its "unfenced" variant is the committed
    kernel without the proxy fence."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "attention_stress.py")
    spec = importlib.util.spec_from_file_location("attention_stress", path)
    stress = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stress)
    assert set(stress.PATCHES) == {"committed", "unfenced"}
    for variant, patches in stress.PATCHES.items():
        for fname, old, new in patches:
            with open(os.path.join(build.CSRC_DIR, fname)) as f:
                text = f.read()
            assert text.count(old) == 1, (variant, fname, old)
            assert "fence.proxy.async" not in text.replace(old, new)


def test_ablation_patches_apply_to_the_kernel():
    """scripts/attention_ablation.py patches the kernels' source text; each
    patch of each of the three kernels still finds its text, so the script
    measures these kernels."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "attention_ablation.py")
    spec = importlib.util.spec_from_file_location("attention_ablation", path)
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    assert list(ablation.VARIANTS.values()) == [ablation.PATCHES,
                                                ablation.PATCHES_BF16]
    assert set(ablation.PATCHES_GENERAL) == {
        "library", "no_copies", "no_qk", "no_softmax", "no_pv", "no_store"}
    for variants in [*ablation.VARIANTS.values(), ablation.PATCHES_GENERAL]:
        for variant, patches in variants.items():
            for fname, old, _ in patches:
                with open(os.path.join(build.CSRC_DIR, fname)) as f:
                    assert old in f.read(), (variant, fname, old)


# ---------------------------------------------------------------------------
# chip_smoke.py's build list and expected launch counts
# ---------------------------------------------------------------------------

SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)
CVAE_SMALL = dict(latent_dim=32, depth=1, nheads=2, feedforward_dim=64)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_build_phase_lists_all_three_sources(smoke, monkeypatch):
    assert smoke.build_sources() == ["attention.cu", "attention_bf16.cu",
                                     "attention_general.cu"]
    built, loaded = [], []
    monkeypatch.setattr(smoke.build, "build_all",
                        lambda sources: built.append(list(sources)))
    monkeypatch.setattr(smoke.build, "BUILD_INFO", {
        s: {"seconds": 0.0, "log": "", "path": s}
        for s in smoke.build_sources()})
    monkeypatch.setattr(smoke.attention, "load_library",
                        lambda dtype, route: loaded.append((route, dtype)))
    smoke.build_phase()
    assert built == [smoke.build_sources()]
    assert sorted(loaded, key=str) == sorted(
        [(r, d) for r in ("tuned", "general")
         for d in (torch.float32, torch.bfloat16)], key=str)


def test_expected_counts_of_the_shipped_and_wide_configs(smoke):
    """The numbers the dataset phase holds the card to, from the shipped
    config: 60 clips of 1,200 frames, mirrored."""
    exp = smoke.dataset_expected(GeneratorConfig())
    assert exp == {"frames": 144_000, "ranges": 120,
                   "cnt_norm_windows": 6_960, "cnt_norm_launches": 56,
                   "character_ranges": 4, "character_windows": 4_560,
                   "character_launches": 36}
    names = smoke.dataset_names()
    assert len(names) == len(set(names)) == 60
    assert names[:2] == ["Walk_Neutral_Princess_000",
                         "Run_Neutral_Princess_001"]
    # the wide config: 4 encode chunks and 239 decodes, 2 layers each
    wide = GeneratorConfig(**smoke.WIDE_CONFIG)
    assert wide.num_tokens == 180
    assert smoke.wide_expected_launches(wide) == 4 * 2 + 239 * 2


@pytest.fixture
def counted(smoke, monkeypatch):
    """Launch checks that hold on the CPU, with every attention counted
    on the counter of the kernel the card would launch."""
    real = layers.fused_attention

    def counting(q, k, v, *, scale):
        counter = attention.ROUTES[attention._route(q, k, v)][q.dtype][2]
        setattr(attention.fused_attention, counter,
                getattr(attention.fused_attention, counter) + 1)
        return real(q, k, v, scale=scale)

    monkeypatch.setattr(layers, "fused_attention", counting)
    monkeypatch.setattr(smoke, "check_launches",
                        lambda dev, cond, msg: smoke.check(cond, msg))
    smoke.reset_launches()
    yield smoke
    smoke.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_general_cases_reach_the_general_kernel(smoke, dtype):
    """Every case of chip_smoke's general phase, and every shape it times,
    routes to the general kernel, and the cases at the plan's switch sit
    on each side of it."""
    cases = smoke.general_cases(np.random.RandomState(2),
                                torch.device("cpu"), dtype)
    for name, q, k, v in cases:
        assert attention._route(q, k, v) == "general", name
    for _, b, h, n, m, d in smoke.GENERAL_SHAPES:
        q = torch.empty(b, n, h, d, dtype=dtype).transpose(1, 2)
        kv = torch.empty(b, m, h, d, dtype=dtype).transpose(1, 2)
        assert attention._route(q, kv, kv) == "general"
    paths = {name: attention.general_plan(
        q.shape[2], k.shape[2], q.shape[3], dtype).resident
        for name, q, k, _ in cases}
    assert [r for name, r in paths.items() if "resident)" in name] == [1, 1]
    assert [r for name, r in paths.items() if "two-pass)" in name] == [0]


def test_wide_run_launches_what_its_layers_imply(counted):
    """The wide run at small widths on the CPU: every attention of the
    120-frame config goes to the general kernel, as many times as
    wide_expected_launches says (the run checks it, in float32 and in
    bf16)."""
    cfg = GeneratorConfig(**{**SMALL, **counted.WIDE_CONFIG})
    result, l32, l16 = counted.wide_run(
        CVAE_SMALL,
        torch.device("cpu"), streams=2, frames=20, db_windows=150, cfg=cfg)
    assert l32 == l16 == counted.wide_expected_launches(cfg, 2, 20) == 40
    assert result["launches"] == {"launches": 0, "launches_bf16": 0,
                                  "launches_general": 40}


def test_dataset_phase_launches_what_it_expects(counted, tmp_path):
    """The dataset phase at small widths on the CPU (6 clips of 140
    frames, heads of 64 so that the tuned kernel takes them): its exact
    launch checks hold, with the counts dataset_expected gives for that
    size."""
    widths = dict(SMALL, encoder_dim_head=64, decoder_dim_head=64)
    config = tmp_path / "config.yaml"
    config.write_text("".join(
        f"{section}:\n" + "".join(f"  {k}: {v}\n" for k, v in d.items())
        for section, d in (("model", widths), ("cvae", CVAE_SMALL))))
    cfg = GeneratorConfig(**widths)
    root = tmp_path / "run"
    root.mkdir()
    result, launches = counted.dataset_phase(
        cfg, torch.device("cpu"), str(root), clips=6, frames=140,
        characterize_clips=2, subset=2, config=str(config))
    exp = counted.dataset_expected(cfg, 6, 140)
    assert (exp["cnt_norm_windows"], exp["character_windows"]) == (60, 320)
    assert launches == exp["cnt_norm_launches"] + exp["character_launches"]
    assert launches == 1 + 2
    assert result["characterize_frames"] == 2 * 125


def test_pinned_choices_replay_a_runs_kinks(smoke):
    """chip_smoke.PinnedChoices records each torch.abs sign, torch.where
    condition and ReLU mask of one run; a replay on inputs that fall on
    the other side of a kink takes the recorded side, counts the flips,
    and its gradient is the recorded run's."""
    from mocha_sigasia2023_torch.models.layers import leaky_relu

    def loss(x):
        return (torch.abs(x).sum() + leaky_relu(x, 0.2).sum()
                + torch.nn.functional.relu(x).sum())

    def grad(x, choices=None):
        x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        with smoke.PinnedChoices(choices) as pin:
            loss(x).backward()
        return x.grad.tolist(), pin

    first, pin = grad([1e-9, -1.0, 2.0])
    assert first == [1 + 1 + 1, -1 + 0.2 + 0, 1 + 1 + 1]
    own, _ = grad([-1e-9, -1.0, 2.0])
    assert own == [-1 + 0.2 + 0, -1 + 0.2 + 0, 1 + 1 + 1]
    replayed, again = grad([-1e-9, -1.0, 2.0], pin.choices)
    assert replayed == first and again.flips == 3


def test_parity_judge_decides_in_float32_where_the_cpu_meets_float64(
        smoke):
    """chip_smoke.judge: the float32 card-to-CPU bar decides where the
    CPU's float32 lies within 1/9 of its bar from float64; a CPU farther off
    leaves the quantity to the float64 comparison, which always holds at
    a bar TRAIN_F64_SCALE times the float32 one.  norm_spreads reads the
    least spread-to-offset ratio at a mean_variance_norm input."""
    g64 = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    bar = torch.full_like(g64, 1e-3)

    def run(cpu_off, card_off, card64_off):
        c32 = g64 + cpu_off
        return smoke.judge(c32 + card_off, c32, g64, g64 + card64_off,
                           bar, bar)

    row, failed = run(1e-4, 5e-4, 0.0)
    assert row["decided"] and not failed
    assert row["of_bar"] == pytest.approx(0.5)
    row, failed = run(1e-4, 2e-3, 0.0)
    assert row["decided"] and failed
    row, failed = run(8e-4, 2e-3, 5e-7)
    assert not row["decided"] and not failed
    assert row["cpu_f64_of_bar"] == pytest.approx(0.8)
    row, failed = run(8e-4, 0.0, 2e-6)
    assert not row["decided"] and failed and row["f64_of_bar"] > 1.0

    from mocha_sigasia2023_torch.models import layers
    real = layers.mean_variance_norm
    x = 1.0 + 1e-4 * torch.randn(2, 90, 8, dtype=torch.float64)
    with smoke.norm_spreads() as seen:
        layers.mean_variance_norm(x)
    assert layers.mean_variance_norm is real and len(seen) == 1
    assert 5e-5 < seen[0] < 2e-4


@pytest.mark.parametrize("case", ["lucky_cpu", "card_offset"])
def test_gradient_gate_holds_the_card_to_the_farthest_cpu_run(smoke, case):
    """chip_smoke.gradient_gate on synthetic gradients: 12 tensors whose
    float32 runs scatter by rounding about float64.  ``lucky_cpu``: one
    tensor is ill-conditioned (the card and the jittered CPU runs 3e-7
    from float64), and the CPU's own run happens to land 1e-8 from it;
    held to that run alone, the tensor reads 30x out of line (the refused
    reading), held to the farthest CPU run it passes.  ``card_offset``:
    the card's float32 gradient of one tensor is off by 1e-4 of its
    values, inside the float32 bar, and the gate fails it with and
    without the jittered runs."""
    rng = np.random.RandomState(7)
    names = [f"t{i}" for i in range(12)]
    g64 = {n: torch.as_tensor(1e-2 * rng.randn(64)) for n in names}

    def near(sigma, **wide):
        return {n: g64[n] + wide.get(n, sigma) * torch.as_tensor(
            rng.randn(64)) for n in names}

    jit = [near(1e-9, t0=3e-7) for _ in range(3)]
    cpu = near(1e-9, t0=1e-8)
    card = near(1e-9, t0=3e-7)
    if case == "card_offset":
        card["t5"] = card["t5"] + 1e-4 * g64["t5"]
    card64 = near(1e-15)
    for sampled, want in ((jit, case == "card_offset"), ([], True)):
        failures, undecided = [], []
        rows, ratios, median = smoke.gradient_gate(
            card, cpu, g64, card64, sampled, "cuda", failures, undecided)
        assert bool(failures) == want, failures
        assert rows["t0"]["f64_ratio_to_cpu"] > 20.0
        if case == "card_offset":
            assert any("gradient t5 " in f for f in failures), failures
            assert rows["t5"]["of_bar"] < 1.0 and ratios["t5"] > 100.0
        if sampled:
            assert ratios["t0"] < 2.0 and rows["t0"]["f64_cpu_reach"] > 5e-7
            assert "gradient t0" in undecided
        else:
            assert ratios["t0"] > 20.0


def test_jitter_weights_moves_each_weight_one_spacing(smoke):
    """chip_smoke.jitter_weights: every weight moves to its float
    neighbour, up or down as the seed draws, the same for the same
    seed."""
    def moved(seed):
        torch.manual_seed(0)
        m = torch.nn.Linear(16, 8)
        before = [p.detach().clone() for p in m.parameters()]
        smoke.jitter_weights([m], seed)
        return before, [p.detach().clone() for p in m.parameters()]

    before, after = moved(3)
    for b, a in zip(before, after):
        up = torch.nextafter(b, torch.full_like(b, float("inf")))
        down = torch.nextafter(b, torch.full_like(b, -float("inf")))
        assert bool(((a == up) | (a == down)).all())
        assert 0 < int((a == up).sum()) < a.numel()
    again = moved(3)[1]
    assert all(torch.equal(a, b) for a, b in zip(after, again))
    assert not all(torch.equal(a, b) for a, b in zip(after, moved(4)[1]))


def test_parity_judge_reads_the_jittered_runs(smoke):
    """chip_smoke.judge: a jittered CPU float32 run farther than
    TRAIN_DECIDES of the bar from float64 leaves the quantity to float64,
    even where the CPU's own run meets float64."""
    g64 = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    bar = torch.full_like(g64, 1e-3)
    c32 = g64 + 1e-5
    row, failed = smoke.judge(c32 + 2e-3, c32, g64, g64, bar, bar,
                              [g64 - 1e-5, g64 + 5e-4])
    assert not row["decided"] and not failed
    assert row["jittered_f64_of_bar"] == pytest.approx(0.5)
    row, failed = smoke.judge(c32 + 2e-3, c32, g64, g64, bar, bar,
                              [g64 - 1e-5])
    assert row["decided"] and failed


def test_velocity_bar_follows_the_positions_gap(smoke):
    """chip_smoke's velocity parity: implied_velocity_gap is featurize's
    central difference of the positions' gap, range by range, so two
    blocks built by that difference pass with a residual near zero; a
    velocity off by more than 2e-4 beyond what its positions imply
    fails."""
    from mocha_sigasia2023_torch.data.preprocess import central_velocity

    rng = np.random.RandomState(5)
    starts, stops = np.array([0, 50, 120]), np.array([50, 120, 200])
    base = np.cumsum(0.02 * rng.randn(200, 3, 3), axis=0) + 20.0
    sides = []
    for shift in (0.0, 4e-6):
        pos = (base + shift * rng.randn(*base.shape)).astype(np.float32)
        vel = np.concatenate([central_velocity(
            torch.as_tensor(pos[s:e])[None])[0].numpy()
            for s, e in zip(starts, stops)])
        sides.append({"bone_positions": pos, "bone_velocities": vel,
                      "range_starts": starts, "range_stops": stops})
    a, b = sides
    implied = smoke.implied_velocity_gap(a["bone_positions"],
                                         b["bone_positions"], starts, stops)
    want = np.concatenate([central_velocity(torch.as_tensor(
        (a["bone_positions"].astype(np.float64)
         - b["bone_positions"])[s:e])[None])[0].numpy()
        for s, e in zip(starts, stops)])
    np.testing.assert_allclose(implied, want, atol=1e-12, rtol=0)
    errs, ok = smoke.velocity_parity(a, b)
    assert ok and errs["residual"] < 1e-5, errs
    assert errs["tolerance"] == smoke.FEAT_ATOL + errs["implied_by_positions"]
    a["bone_velocities"] = a["bone_velocities"].copy()
    a["bone_velocities"][60, 1, 2] += 3e-4
    errs, ok = smoke.velocity_parity(a, b)
    assert not ok and errs["residual"] > smoke.FEAT_ATOL, errs


def test_train_phase_rehearses_on_the_cpu(counted, tmp_path):
    """The train phase at small widths on the CPU (3 clips of 140 frames:
    30 windows, 7 steps an epoch at batch 4, two epochs): every loss
    finite and falling, no attention launched while training, one step
    held to the CPU, and characterize --gen-ckpt on the written checkpoint
    with exactly the tuned launches its windows and frames imply."""
    import yaml

    widths = dict(SMALL, encoder_dim_head=64, decoder_dim_head=64)
    config = get_config(os.path.join(REPO, "mocha_sigasia2023_torch",
                                     "configs", "config.yaml"))
    config["model"].update(widths, prj_dim=64)
    config["cvae"].update(CVAE_SMALL)
    config.update(batch_size=4, log_every=1)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    root = tmp_path / "run"
    (root / "bvh").mkdir(parents=True)
    for i, name in enumerate(counted.dataset_names(3)):
        bvh.save(str(root / "bvh" / f"{name}.bvh"),
                 make_mocha_bvh_data(T=140, seed=3000 + i))
    with contextlib.redirect_stdout(None):
        generate_database.main(["--bvh-dir", str(root / "bvh"), "--out",
                                str(root / "data"), "--device", "cpu"])
    cfg = GeneratorConfig(**widths)
    result, launches = counted.train_phase(
        cfg, torch.device("cpu"), str(root), config=str(path), epochs=2,
        characterize_clips=2, characterize_frames=100)
    assert result["steps"] == 14 and result["logged_values"] == 14
    assert result["training_launches"] == {
        "launches": 0, "launches_bf16": 0, "launches_general": 0}
    assert result["loss_total_last"] < result["loss_total_first"]
    # 2 clips x 85 windows in one encoder chunk, 85 frames of 2 decodes
    # (1 on frame 0), the 125-window character in one chunk
    assert launches == 2 + (84 * 2 + 1) + 1
    assert result["parity"]["gradients"]["tensors"] == 47


def test_cvae_phase_rehearses_on_the_cpu(counted, tmp_path):
    """The cvae phase at small widths on the CPU, on a dataset phase's
    files (4 clips of 140 frames: Neutral_Princess and Sad_Princess
    walking and running; the latter the source, 320 windows each): the
    source export's exact launches, 7 train_cvae iterations with no
    attention launched, the card-to-CPU and bf16 checks, and characterize
    --cvae-ckpt with exactly the tuned launches its windows and frames
    imply."""
    import yaml

    widths = dict(SMALL, encoder_dim_head=64, decoder_dim_head=64)
    config = get_config(os.path.join(REPO, "mocha_sigasia2023_torch",
                                     "configs", "config.yaml"))
    config["model"].update(widths, prj_dim=64)
    config["cvae"].update(CVAE_SMALL, rollout_steps=4, batch_size=4)
    config.update(log_every=2)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    root = tmp_path / "run"
    (root / "bvh").mkdir(parents=True)
    names = counted.dataset_names(4)
    assert [n.split("_", 1)[1][:-4] for n in names] == [
        "Neutral_Princess", "Neutral_Princess", "Sad_Princess",
        "Sad_Princess"]
    for i, name in enumerate(names):
        bvh.save(str(root / "bvh" / f"{name}.bvh"),
                 make_mocha_bvh_data(T=140, seed=3000 + i))
    data = str(root / "data")
    common = ["--data-dir", data, "--random-init", "--device", "cpu",
              "--config", str(path)]
    with contextlib.redirect_stdout(None):
        generate_database.main(["--bvh-dir", str(root / "bvh"), "--out",
                                data, "--device", "cpu"])
        MotionDataset(data, device="cpu")
        collect_features.main(["cnt-norm", *common])
        collect_features.main([
            "character", *common, "--styles", str(counted.DATASET_STYLE),
            "--actions", *map(str, counted.DATASET_CHARACTER_ACTIONS),
            "--out", str(root / "princess_feature.npz")])
    cfg = GeneratorConfig(**widths)
    exp = counted.character_expected(cfg, 18, 4, 140)
    assert exp == {"ranges": 4, "windows": 320, "launches": 2}
    result, launches = counted.cvae_phase(
        cfg, torch.device("cpu"), str(root), config=str(path), iters=7,
        source_style=18, characterize_clips=2, clips=4, frames=140)
    assert result["source_export_float32_launches"] == 2
    assert result["training_launches"] == {
        "launches": 0, "launches_bf16": 0, "launches_general": 0}
    assert result["logged_values"] == 7 and result["batch"] == 4
    for tag in ("student_p 0", "student_p 1"):
        row = result["parity"][tag]
        assert row["param_mean_gap"] == 0.0 and row["param_mean_update"] > 0
    assert result["parity"]["bf16"]["masters_float32"]
    # 2 clips x 125 windows in one encoder chunk, 125 frames of 2 decodes
    # (1 on frame 0), the 125-window character in one chunk
    assert launches == 2 + (124 * 2 + 1) + 1
