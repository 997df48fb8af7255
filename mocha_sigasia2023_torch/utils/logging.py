"""Metrics logging: JSONL always, TensorBoard when it can be imported.

Counterpart of mocha_sigasia2023_tpu/utils/logging.py: the same record
fields (``tag``, ``value``, ``step``, ``time``) and scalar names.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self.add_scalar(k, v, step)
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
