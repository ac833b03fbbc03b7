"""Training metrics: a JSONL log, and TensorBoard where importable
(counterpart of `faithdiff_tpu/training/logging.py`).

`metrics.jsonl` holds one row `{"step", "time", <metric>...}` per call
and is the source of truth; `torch.utils.tensorboard` writes `tb/` beside
it when its package is installed.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.jsonl_path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def read_metrics(log_dir: str):
    path = os.path.join(log_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
