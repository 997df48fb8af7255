"""Where the PyTorch port's serving slice spends its time on one GPU.

    python3 scripts/torch_slice_profile.py

Builds the chip_smoke.py slice (full-width model, random weights from a
NumPy seed, 64 streams, 2048-window character database), warms it up, then
runs featurize+encode and the stream runner once each under torch.profiler.
Prints one JSON line: wall time of each stage, the summed device-kernel
time and the device's idle share over each stage, and the kernels that
take the most device time.  The full key_averages table goes to
chiprun_out/torch_slice_profile.txt.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocha_sigasia2023_torch.data.synthetic import make_mocha_bvh_data  # noqa: E402
from mocha_sigasia2023_torch.models.cvae import CVAEConfig, init_cvae  # noqa: E402
from mocha_sigasia2023_torch.models.generator import (  # noqa: E402
    GeneratorConfig, init_generator)
from mocha_sigasia2023_torch.ops import attention  # noqa: E402
from mocha_sigasia2023_torch.runtime import features as rtf  # noqa: E402
from mocha_sigasia2023_torch.runtime.stream import make_batch_runner  # noqa: E402

# Shorter than chip_smoke's 240 frames: the profiler adds host time to each
# of the runner's ~1,350 ops a frame, and every frame runs the same step, so
# 60 frames show the per-frame mix in a quarter of the time and trace.
PROFILED_FRAMES = 60


def main():
    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attention.load_library()
    cfg = GeneratorConfig()
    gen = init_generator(cfg, seed=0, device=dev)
    cvae = init_cvae(CVAEConfig(output_seq=cfg.num_tokens), seed=1,
                     device=dev)
    norm, consts, parents = cs.character_setup(gen, cs.DB_WINDOWS, dev)
    clips = [make_mocha_bvh_data(T=PROFILED_FRAMES + cs.WINDOW_PAD, seed=i)
             for i in range(cs.STREAMS)]
    runner = make_batch_runner(gen, cvae, consts, parents, device=dev)
    gen_rng = torch.Generator(device=dev).manual_seed(7)

    def featurize():
        return rtf.batch_stream_features_device(clips, gen, norm,
                                                emit_cnt=False, device=dev)

    frame0, xs = featurize()                       # warm-up
    runner(frame0, xs, gen_rng)
    (frame0, xs), w_feat, rows_feat, _ = cs.profiled(featurize)
    _, w_run, rows_run, prof = cs.profiled(
        lambda: runner(frame0, xs, gen_rng))

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_slice_profile.txt"),
              "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    result = {"card": cs.card_line(), "streams": cs.STREAMS,
              "frames": PROFILED_FRAMES,
              "stages": [cs.summarize("featurize+encode", w_feat, rows_feat),
                         cs.summarize("stream runner", w_run, rows_run)],
              "runner_ms_per_frame": 1e3 * w_run / PROFILED_FRAMES}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
