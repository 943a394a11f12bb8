"""Structured metrics and profiling (counterpart of `dclip_tpu/core/metrics.py`).

- `MetricsLogger`: CSV rows and stdout lines with the JAX package's
  columns (`step`, `time`, then the metrics in the order of the first
  call) and print format (`dclip_tpu/core/metrics.py:20-57`).
- `trace_span`: a `torch.profiler.record_function` range around a
  train-step or input-pipeline section; `start_trace` / `stop_trace`
  record a `torch.profiler` trace into a directory (TensorBoard's
  layout, one `.pt.trace.json` per stop).
"""
from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, Iterator, Optional

import torch


class MetricsLogger:
    def __init__(self, csv_path: Optional[str] = None, print_every: int = 10):
        self.csv_path = csv_path
        self.print_every = max(print_every, 1)
        self._writer = None
        self._file = None
        self._fields = None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        """Write a CSV row and print. Callers decide the cadence (the
        trainers log every `print_every` batches of an epoch)."""
        metrics = {k: float(v) for k, v in metrics.items()}
        row = {"step": step, "time": time.time() - self._t0, **metrics}
        if self.csv_path:
            if self._writer is None:
                os.makedirs(os.path.dirname(os.path.abspath(self.csv_path)) or ".",
                            exist_ok=True)
                self._file = open(self.csv_path, "a", newline="")
                self._fields = list(row)
                self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
                if self._file.tell() == 0:
                    self._writer.writeheader()
            self._writer.writerow({k: row.get(k, "") for k in self._fields})
            self._file.flush()
        parts = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"{prefix}step {step}: {parts}")

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = self._writer = None


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range in the torch.profiler timeline (a few microseconds
    outside a profile)."""
    with torch.profiler.record_function(name):
        yield


_PROFILER: Optional[torch.profiler.profile] = None


def start_trace(log_dir: str) -> None:
    """Start recording host and (with a card) device activity; the trace is
    written into `log_dir` by `stop_trace`."""
    global _PROFILER
    if _PROFILER is not None:
        raise RuntimeError("a trace is already being recorded")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _PROFILER = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _PROFILER.start()


def stop_trace() -> None:
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("no trace is being recorded")
    prof, _PROFILER = _PROFILER, None
    prof.stop()
