"""The plain reference of the MOCHA model: featurize, encode, match, CVAE
sample, decode, root integration, foot-contact IK, and the generator's
training step, in plain PyTorch.

A frozen copy of the port's modules (``device``, ``ops/numerics``,
``models``, ``kinematics``, ``data``, ``runtime/stream``,
``runtime/features``, ``runtime/matching``, ``train``), importing nothing
of the port and nothing of JAX.  Departures from the code it was copied
from:

- attention: the plain formula everywhere (``ops/attention``); the port
  serves through its CUDA kernels (``fused_attention``);
- ``runtime/stream``: no sharded serving, no ``runner.chunked``, no
  ``characterize_clip``, ``pad_character_database``, ``cast_database`` or
  ``stack_stream_inputs``; the runner takes the program's picks in place
  of its own, and ``runtime/matching.pick_gaps`` (new) judges those
  picks; ``runtime/matching`` has no ``ContextIndex``;
- ``runtime/features``: no dataset exports and no ragged batching;
- ``data/dataset``: no ``MotionDataset`` (database files) and no
  ``prefetch_batches`` thread;
- ``train/trainer``: one device (no mesh, no all-reduce), no checkpoint
  files, initial weights taken as state dicts;
- ``models``: no ``convert`` (JAX checkpoint import).

The benchmark runs it in float32 with TF32 off for matmuls and cuDNN.
"""
