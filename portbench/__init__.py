"""The benchmark of mocha_sigasia2023_torch, the PyTorch and CUDA port of
MOCHA: one cell a run, ``python -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.  Cells, configurations, traffic mixes
and per-layer metrics are files of their own under this folder, found by
name (:mod:`portbench.harness`)."""
