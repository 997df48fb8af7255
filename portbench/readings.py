"""Readings of a cell's compared numbers over many seeds in one process:
the program's (sound runs, for the lower readings), the control's (the
plain reference in the program's place, in TF32), or the program's with a
fault planted (``portbench/faults.py``).  Each seed is a whole run at the
cell's own size; the benchmark's own runs never run this.

    python -m portbench.readings --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control] [--fault <name>]

Prints one JSON line a seed: its numbers against the cell's limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import faults, harness, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true",
                    help="the reference in TF32 in the program's place")
    ap.add_argument("--fault", help="a fault planted in the program")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[portbench] readings are taken on a CUDA device",
              file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    what = ("control" if args.control else
            f"fault {args.fault}" if args.fault else "program")
    for seed in args.seeds:
        plant = (faults.for_kind(cell.mix["kind"])[args.fault]()
                 if args.fault else contextlib.nullcontext())
        with plant:
            result = run.run_cell(
                cell, seed, args.seconds, False, torch.device("cuda", 0),
                impl_name=("portbench.reference" if args.control
                           else harness.PROGRAM),
                tf32_window=args.control)
        print(json.dumps({"workload": cell.name, "seed": seed, "run": what,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
