"""chip_smoke.py's parallel phase (13) alone, at full width.

    python3 scripts/parallel_phase.py

Builds the kernels, writes the synthetic BVH clips of the dataset phase
that the parallel phase reads (the first 6, 1,200 frames each), and runs
chip_smoke.parallel_phase on them: sharded serving on 2 gloo ranks of one
card against one process, the first training step and 10 steps of
cli/train --data-parallel 2 against one process (with float32's reach:
the 1-process run's repeat and 2 runs from weights moved one float
spacing) and against one process that sums the blocks' gradients as the
ranks do, one nccl rank, and characterize on the 2-rank checkpoint.  The
phase prints its readings; a failed check raises.  About 3 minutes on an
H100.
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.no_tf32()
    cs.log(f"[card] torch {torch.__version__}; {cs.card_line()}")
    cs.phase("build", cs.build_phase)
    cfg = cs.GeneratorConfig()
    cvae_cfg = cs.CVAEConfig(output_seq=cfg.num_tokens)
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "bvh"))
        for i, name in enumerate(cs.dataset_names(cs.DP_CLIPS)):
            speed = 150.0 if name.startswith("Run") else 60.0
            cs.bvh.save(os.path.join(root, "bvh", name + ".bvh"),
                        cs.make_mocha_bvh_data(
                            T=cs.DATASET_FRAMES, seed=3000 + i,
                            walk_speed=speed + 2.0 * (i % 10)))
        cs.phase("parallel", cs.parallel_phase, cfg, cvae_cfg, dev, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
