"""mocha_sigasia2023_torch — the PyTorch/CUDA port of mocha_sigasia2023_tpu.

The serving path of the JAX package, rebuilt on PyTorch for an NVIDIA
H100: BVH clips -> featurize -> stride-1 windows -> generator encode ->
batched per-frame stream step -> poses -> BVH.  The layout mirrors the
JAX package so each module's counterpart is easy to find:

cli         ``python -m mocha_sigasia2023_torch.cli.characterize``.
io          BVH read/write (the MOTION text through the C++ host codec,
            io/native), database.bin, msgpack and orbax checkpoints.
utils       the config reader (a YAML subset, no PyYAML), directories,
            metrics logging, tracing and stage timing.
kinematics  quaternion algebra, FK/IK, the foot-contact springs.
data        synthetic clips, windowing, clip featurization, window features.
models      skeleton graph tables, layers, generator, CVAE, weight import
            (JAX pytrees and the reference's .pt checkpoints).
runtime     context matching (one character or a stack), stream
            featurization (also ragged batches), the batched,
            multi-character and single-clip stream runners, the live
            frame-at-a-time session, BVH export.
ops         numerics guards and the hand-written CUDA attention kernels
            (float32 and bfloat16).
train       losses, the generator's and the CVAE's trainers, checkpoints.
parallel    data parallelism over ranks on torch.distributed: the mesh,
            placement by rank, the gradient reduction, process set-up.
viz         the matplotlib stick-figure animation (host only).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise.  This package
imports nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"
