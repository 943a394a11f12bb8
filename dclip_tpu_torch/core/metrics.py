"""Structured metrics and profiling (counterpart of `dclip_tpu/core/metrics.py`).

- `MetricsLogger`: CSV rows and stdout lines with the JAX package's
  columns (`step`, `time`, then the metrics in the order of the first
  call) and print format (`dclip_tpu/core/metrics.py:20-57`).
- `trace_span`: a `torch.profiler.record_function` range around a
  train-step or input-pipeline section; `start_trace` / `stop_trace`
  record a `torch.profiler` trace into a directory (TensorBoard's
  layout, one `.pt.trace.json` per stop).
- `device_time_by_range`: a finished profile read per step: the device
  time and busy share, and the device and host time under each `dclip.*`
  range (the port's form of the JAX trace's perfetto drill-down).
"""
from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, Iterator, Optional

import torch

# The step's ranges (`record_function`), in the order a step runs them.
RANGES = ("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.teacher_text",
          "dclip.cross_attention", "dclip.student_step", "dclip.backward",
          "dclip.grad_all_reduce", "dclip.optimizer")


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


def stop_trace() -> torch.profiler.profile:
    """Stop the recording, write its trace, and return the profiler (for
    `device_time_by_range`)."""
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("no trace is being recorded")
    prof, _PROFILER = _PROFILER, None
    prof.stop()
    return prof


def device_time_by_range(prof: torch.profiler.profile, steps: int, wall_s: float) -> dict:
    """Per step of a finished profile over `steps` steps that took `wall_s`
    seconds on the host clock:

      device_ms  device time of the device-side events (kernels, copies);
                 0.0 when the profile holds none (the CPU)
      busy       device_ms over the wall's share of a step; None without
                 device time
      ranges     {name: {"device_ms", "host_ms"}} for each `dclip.*` range
                 the profile holds, in `RANGES` order: the device span of
                 the kernels launched inside it and outside any inner
                 range, first start to last end, idle gaps included (None
                 without device time), and its host time
      kernels    [(name, device ms, launches)] by device time, descending

    Device rows only count toward device_ms: the host rows of
    key_averages() also carry their children's device time, and the
    device rows of the `dclip.*` ranges span their kernels. The backward's
    kernels launch from autograd's own thread, outside every range, so
    `dclip.backward` spans next to nothing on the device."""
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
                      for e in events if e.device_type == cuda and e.self_device_time_total > 0
                      and not e.key.startswith("dclip.")), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    names = {e.key for e in events if e.key.startswith("dclip.")}
    order = [n for n in RANGES if n in names] + sorted(names - set(RANGES))
    ranges = {}
    for name in order:
        dev = sum(e.device_time_total for e in events if e.key == name and e.device_type == cuda)
        host = sum(e.cpu_time_total for e in events if e.key == name and e.device_type != cuda)
        ranges[name] = {"device_ms": dev / 1e3 / steps if device_ms else None,
                        "host_ms": host / 1e3 / steps}
    step_ms = 1e3 * wall_s / steps
    return {"device_ms": device_ms, "busy": device_ms / step_ms if device_ms else None,
            "ranges": ranges, "kernels": kernels}
