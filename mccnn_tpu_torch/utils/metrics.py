"""Structured training/matching metrics (copy of mccnn_tpu/utils/metrics.py).

The reference logs scalars to TensorBoard (reference: src/train.py:108-124)
and per-stage wall-clock to stdout (reference: src/match.py:126-176). We
emit structured JSONL (one record per event, machine-readable) plus — when
TensorFlow is importable — real TensorBoard scalar summaries in the same
directory, preserving the reference's TB contract. Per-scene runtime still
lands in ``timeMCCNN.txt`` via mccnn_tpu_torch.io.middlebury (the Middlebury
contract).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


def _try_tb_writer(log_dir: str):
    try:
        import tensorflow as tf

        return tf.summary.create_file_writer(log_dir)
    except ImportError:
        return None


class MetricsLogger:
    def __init__(
        self,
        path: Optional[str] = None,
        echo: bool = True,
        tensorboard_dir: Optional[str] = None,
    ):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
        else:
            self._file = None
        self._tb = _try_tb_writer(tensorboard_dir) if tensorboard_dir else None

    def log(self, step: Optional[int] = None, **record) -> None:
        record.setdefault("time", time.time())
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb is not None and step is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for key, value in record.items():
                    if key != "time" and isinstance(value, (int, float)):
                        tf.summary.scalar(key, value, step=step)
            self._tb.flush()
        if self.echo:
            pretty = " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "time"
            )
            print(pretty, flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class StageTimer:
    """Per-stage wall timing with device-sync via block_until_ready hooks."""

    def __init__(self, logger: Optional[MetricsLogger] = None):
        self.logger = logger
        self.stages = {}
        self._start = None
        self._name = None

    def start(self, name: str) -> None:
        self._name = name
        self._start = time.time()

    def stop(self) -> float:
        elapsed = time.time() - self._start
        self.stages[self._name] = elapsed
        if self.logger:
            self.logger.log(stage=self._name, seconds=elapsed)
        return elapsed
