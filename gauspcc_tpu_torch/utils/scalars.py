"""Training scalar streams: JSONL and TensorBoard: the port's copy of
gauspcc_tpu/utils/scalars.py (`ScalarLogger` :17).

The reference logs scalars to TensorBoard per iteration (HAC/train.py:
283-286). One ScalarLogger fans a metric dict out to every available
sink; a JSONL file is always written, so a run stays inspectable without
TensorBoard, which is imported only if present. The JAX package's
optional wandb mirror is not ported: nothing here sets it.
"""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    @property
    def sinks(self) -> list[str]:
        return ["jsonl"] + (["tensorboard"] if self._tb is not None else [])

    def log(self, step: int, metrics: dict) -> None:
        clean = {k: float(v) for k, v in metrics.items()
                 if _is_scalar(v)}
        self._jsonl.write(json.dumps(
            {"step": step, "time": time.time(), **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
