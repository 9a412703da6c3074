"""Metrics logging to OUTPUT_DIR/metrics.jsonl, one JSON object per call
(`csbsr_tpu/utils/logging.py:MetricsLogger`, without wandb for now)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}), **metrics}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
