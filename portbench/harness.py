"""What the benchmark finds by name, and what every run reports.

- ``workloads/<cell>.json``: one cell (its configuration, traffic mix,
  chips, why, end-to-end metrics and the limits of its check);
- ``configs/<config>.json``: one configuration of the model, as it is run;
- ``traffic/<mix>.json``: one traffic mix, the parameters of a ``kind``;
- ``traffic/<kind>.py``: the code of a kind (set-up, the timed window, the
  check against the plain reference);
- ``metrics/<metric>.py``: one reader per per-layer metric.

A cell added as files only (a workload, a mix, a configuration) runs
without an edit here.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from types import ModuleType, SimpleNamespace
from typing import Dict, List

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mocha_sigasia2023_tpu")
PROGRAM = "mocha_sigasia2023_torch"


def _json(*parts) -> Dict:
    path = os.path.join(ROOT, *parts)
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: Dict        # workloads/<cell>.json
    config: Dict      # configs/<config>.json
    mix: Dict         # traffic/<mix>.json

    @property
    def kind(self) -> ModuleType:
        return importlib.import_module(f"portbench.traffic.{self.mix['kind']}")

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic mix."""
    spec = _json(root, "workloads", f"{name}.json")
    return Cell(name=name, spec=spec,
                config=_json(root, "configs", f"{spec['config']}.json"),
                mix=_json(root, "traffic", f"{spec['traffic']}.json"))


def cell_names(root: str = ROOT) -> List[str]:
    return sorted(os.path.basename(p)[:-5]
                  for p in glob.glob(os.path.join(root, "workloads", "*.json")))


def metric_readers(root: str = ROOT) -> Dict[str, ModuleType]:
    """{metric name: reader module} for every ``metrics/<metric>.py``
    (loaded by path: a metric's name may hold dots)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def implementation(root_package: str) -> SimpleNamespace:
    """The modules a kind drives, from the port (``PROGRAM``) or from the
    plain reference (``portbench.reference``), which keeps the port's
    module layout."""
    def m(sub):
        return importlib.import_module(f"{root_package}.{sub}")

    return SimpleNamespace(
        generator=m("models.generator"), cvae=m("models.cvae"),
        layers=m("models.layers"), preprocess=m("data.preprocess"),
        windows=m("data.windows"), dataset=m("data.dataset"),
        features=m("runtime.features"), stream=m("runtime.stream"),
        matching=m("runtime.matching"), trainer=m("train.trainer"),
        kinematics=m("kinematics.quat"),
        name=root_package)


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that a run may not hold, compared
    whole (the port's name begins with the JAX package's letters)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def host_cpu() -> str:
    """The host CPU's model name with its vendor, family and model (a
    virtual machine may give no name), and its logical CPU count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
                if not line.strip():
                    break
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} "
            f"({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}), {os.cpu_count()} logical CPUs")


def card_state() -> str:
    """The card's name, clocks, power draw and limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
