"""No module loaded by a run of portbench.run, or by portbench/reference,
has the top-level name of JAX or of the JAX package, and the reference
loads nothing of the port: top-level names compared whole (the port's
name begins with the JAX package's letters)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import harness

REPO = os.path.dirname(harness.ROOT)
JAX_SIDE = {"jax", "jaxlib", "flax", "mocha_sigasia2023_tpu"}

RUN = """
import json, sys, torch
from portbench import harness, run
from portbench.tests import tiny
name = tiny.write(sys.argv[1], "cvae-offline-64x240")
r = run.run_cell(harness.load_cell(name, sys.argv[1]), 5, 0.1, True,
                 torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, pkgutil, importlib, sys
import portbench.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "portbench.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax(tmp_path):
    names = top_level(RUN, str(tmp_path))
    assert harness.PROGRAM in names          # the port did run
    assert not names & JAX_SIDE, names & JAX_SIDE


def test_the_reference_loads_nothing_of_the_port_or_jax():
    names = top_level(REFERENCE)
    assert "portbench" in names
    assert not names & (JAX_SIDE | {harness.PROGRAM})


def test_the_names_are_compared_whole():
    # the port's modules are not the JAX package's, though its name
    # begins with the same letters
    sys.modules.setdefault("mocha_sigasia2023_tpu_lookalike", sys)
    try:
        assert "mocha_sigasia2023_tpu_lookalike" not in \
            harness.forbidden_loaded()
    finally:
        sys.modules.pop("mocha_sigasia2023_tpu_lookalike", None)
    assert harness.PROGRAM.startswith("mocha_sigasia2023_t")
    assert harness.PROGRAM not in harness.FORBIDDEN_MODULES
