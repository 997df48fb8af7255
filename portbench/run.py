"""Run one cell of the benchmark and print its result as the last line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights from the seed, the character databases, the traffic's
inputs, a warm-up of every shape) counts as ``setup_s``, from process
start to the first timed step; in a checkout's first run it holds the
build of the port's kernels, whose seconds the result gives apart as
``build_s``.  Then the window runs for ``--seconds``
(closed loops finish the unit in flight).  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a profiled slice and synced spans.  After the window the
program's state is freed and the plain reference works out again what the
window produced; ``correct`` says whether every compared number is within
its limit, and each is printed beside its limit on the last lines of
standard error and under ``checks`` in the result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

THREADS = 4   # PyTorch's intra-op threads: the load comes from one process


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def build_seconds() -> float:
    """Seconds this process spent building the port's native libraries, by
    the port's own record (``ops/build.BUILD_INFO``: 0 for a library that
    was already built).  Nonzero only in a checkout's first run, whose
    ``setup_s`` holds the build."""
    build = sys.modules.get(f"{harness.PROGRAM}.ops.build")
    if build is None:
        return 0.0
    return float(sum(info.get("seconds", 0.0)
                     for info in build.BUILD_INFO.values()))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_precision(config, tf32: bool = False) -> None:
    import torch

    p = config["precision"]
    if p["dtype"] != "float32":
        raise ValueError(f"precision {p['dtype']}: only float32 is run")
    allow = bool(p["tf32"]) or tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def run_cell(cell, seed: int, seconds: float, traced: bool, dev,
             impl_name: str = harness.PROGRAM, tf32_window: bool = False):
    """Set up, measure and check one cell on ``dev``; returns the result
    line's object.  ``impl_name`` and ``tf32_window`` put another
    implementation, or the same in TF32, in the program's place (the
    control)."""
    import torch

    torch.set_num_threads(THREADS)
    kind = cell.kind
    impl = harness.implementation(impl_name)
    log(f"[portbench] cell {cell.name} seed {seed} seconds {seconds} "
        f"trace {int(traced)} impl {impl_name}")
    log(f"[portbench] host cpu: {harness.host_cpu()}; torch threads "
        f"{torch.get_num_threads()}; torch {torch.__version__}")
    if dev.type == "cuda":
        log(f"[portbench] card before: {harness.card_state()}")
    set_precision(cell.config, tf32_window)
    state = kind.setup(cell, seed, dev, impl)
    setup_s = process_age_s()
    build_s = build_seconds()
    log(f"[portbench] setup_s {setup_s!r}, of which building the port's "
        f"libraries {build_s!r}")
    rec = kind.window(cell, state, seconds, traced)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        log(f"[portbench] card after: {harness.card_state()}")
    else:
        peak = 0
    kind.release(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    set_precision(cell.config)
    t0 = time.perf_counter()
    numbers = kind.check(cell, seed, dev, rec, cell.limits)
    log(f"[portbench] check took {time.perf_counter() - t0:.3f} s")
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and len(checks) > 0

    if traced:
        metrics = per_layer(rec["trace"])
    else:
        metrics = {k: {"value": float(rec["e2e"][k]), "unit": u}
                   for k, u in kind.END_TO_END.items()}
        metrics["setup_s"] = {"value": float(setup_s), "unit": "s"}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": device, "build_s": build_s}
    if traced and rec["trace"].slice is not None:
        sl = rec["trace"].slice
        device["busy_s"] = sl.busy_s()
        device["window_s"] = sl.wall_s
        result["breakdown"] = {k: [[n, s] for n, s in v]
                               for k, v in sl.breakdown().items()}
    result["checks"] = checks
    return result


def per_layer(trace):
    out = {}
    for name, reader in harness.metric_readers().items():
        value = reader.read(trace)
        if value is not None:
            out[name] = {"value": float(value), "unit": reader.UNIT}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[portbench] cell {cell.name} needs {cell.chips} CUDA "
            f"device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = harness.forbidden_loaded()
    if found:
        log(f"[portbench] refused: the process holds {found}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
