"""Structured metrics and profiling (counterpart of `dclip_tpu/core/metrics.py`).

- `MetricsLogger`: CSV rows and stdout lines with the JAX package's
  columns (`step`, `time`, then the metrics in the order of the first
  call) and print format (`dclip_tpu/core/metrics.py:20-57`).
- `trace_span`: a `torch.profiler.record_function` range around a
  train-step or input-pipeline section; `start_trace` / `stop_trace`
  record a `torch.profiler` trace into a directory (TensorBoard's
  layout, one `.pt.trace.json` per stop).
- `BackwardSpans`: ranges over the parts of a backward, opened and
  closed on the thread that runs it (autograd's device thread on a card),
  so the kernels it launches fall inside them; marked only while a
  profiler records.
- `device_time_by_range`: a finished profile read per step: the device
  time, busy share and the device time no range holds, and the device and
  host time under each `dclip.*` range (the port's form of the JAX
  trace's perfetto drill-down).
"""
from __future__ import annotations

import contextlib
import csv
import functools
import os
import time
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

# The step's ranges (`record_function`), in the order a step runs them.
RANGES = ("dclip.cache_lookup", "dclip.h2d", "dclip.crop", "dclip.region_encode",
          "dclip.teacher_text", "dclip.cross_attention", "dclip.pack_text",
          "dclip.student_step", "dclip.backward", "dclip.backward.loss", "dclip.backward.text",
          "dclip.backward.vision", "dclip.grad_all_reduce", "dclip.optimizer")


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


def profiling() -> bool:
    """True while a `torch.profiler` records on this process."""
    return torch._C._autograd._profiler_enabled()


class _OpenSpan(torch.autograd.Function):
    """The identity (a view) whose backward opens a span of `BackwardSpans`."""

    @staticmethod
    def forward(ctx, x, spans, name):
        ctx.spans, ctx.name = spans, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.spans.open(ctx.name)
        return grad, None, None


def _accumulator_hook(spans_ref, name, grad_inputs, grad_outputs) -> None:
    """An accumulator's hook: a weak reference, so that the accumulators a
    `BackwardSpans` keeps do not keep it, and their leaves, alive."""
    spans = spans_ref()
    if spans is not None:
        spans._written(name)


class BackwardSpans:
    """Named `record_function` ranges over the parts of a backward.

    `mark(x, name, leaves)` passes `x` through an identity whose backward
    opens `name`, closing the span open before it; the span closes once
    every one of `leaves` the backward reaches has written its gradient (a
    mark without leaves closes when the next span opens). Both run on the
    thread that runs the backward (autograd's device thread for CUDA
    tensors), so its kernels launch inside the span and the profiler gives
    the span their device time; a range on the caller's thread gets none of
    them. Spans open in the order autograd reaches the marks and never
    overlap.

    The closing hooks sit on the leaves' gradient accumulators, which this
    object keeps alive so that every later graph reuses them: they are
    hooked once, in the first backward that opens the span, and not in
    every step. Mark only while `profiling()`, and call `release()` before
    any forward that runs without a profiler: it drops the accumulators,
    and the graphs after it are built with fresh ones, without hooks."""

    def __init__(self):
        self._open: Optional[Tuple[str, object]] = None
        self._towers: Dict[str, dict] = {}

    def mark(self, x: torch.Tensor, name: str,
             leaves: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        if not x.requires_grad:
            return x
        if leaves and self._towers.get(name, {}).get("leaves") is not leaves:
            self._towers[name] = {"leaves": leaves, "nodes": None, "left": None}
        return _OpenSpan.apply(x, self, name)

    def release(self) -> None:
        if self._towers:
            self._towers = {}

    def open(self, name: str) -> None:
        self.close()
        self._open = (name, torch.ops.profiler._record_function_enter_new(name, None))
        tower = self._towers.get(name)
        if tower is None:
            return
        if tower["nodes"] is None:
            tower["nodes"] = [torch.autograd.graph.get_gradient_edge(p).node
                              for p in tower["leaves"]]
            hook = functools.partial(_accumulator_hook, weakref.ref(self), name)
            for node in tower["nodes"]:
                node.register_hook(hook)
        tower["left"] = sum(map(torch._C._will_engine_execute_node, tower["nodes"]))
        if not tower["left"]:
            self.close(name)

    def _written(self, name: str) -> None:
        tower = self._towers.get(name)
        if tower is None or not tower["left"]:
            return
        tower["left"] -= 1
        if not tower["left"]:
            self.close(name)

    def close(self, name: Optional[str] = None) -> None:
        """Close the open span (only if it is `name`, when given)."""
        if self._open is None or (name is not None and self._open[0] != name):
            return
        handle, self._open = self._open[1], None
        torch.ops.profiler._record_function_exit._RecordFunction(handle)


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


def _union_intervals(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def busy_and_unranged(ops, spans) -> Tuple[int, int]:
    """(busy, unranged) time of device operations' (start, end) intervals:
    busy is the length of their union (work on overlapping streams counts
    once), unranged the part of it outside every one of the `spans` (the
    device spans of the `dclip.*` ranges)."""
    busy, ranged = _union_intervals(ops), _union_intervals(spans)
    covered, j = 0, 0
    for s, e in busy:
        while j < len(ranged) and ranged[j][1] <= s:
            j += 1
        k = j
        while k < len(ranged) and ranged[k][0] < e:
            covered += min(e, ranged[k][1]) - max(s, ranged[k][0])
            k += 1
    total = sum(e - s for s, e in busy)
    return total, total - covered


def device_time_by_range(prof: torch.profiler.profile, steps: int, wall_s: float) -> dict:
    """Per step of a finished profile over `steps` steps that took `wall_s`
    seconds on the host clock:

      device_ms    summed device time of the device-side events (kernels,
                   copies); 0.0 when the profile holds none (the CPU)
      busy_ms      the length of the union of those events' intervals, so
                   work on overlapping streams counts once; None without
                   device time
      busy         busy_ms over the wall's share of a step; None without
                   device time
      unranged_ms  the part of busy_ms outside the device span of every
                   `dclip.*` range: device work no range holds; None
                   without device time
      ranges       {name: {"device_ms", "host_ms"}} for each `dclip.*` range
                   the profile holds, in `RANGES` order: the device span of
                   the kernels launched inside it and outside any inner
                   range, first start to last end, idle gaps included (None
                   without device time), and its host time
      kernels      [(name, device ms, launches)] by device time, descending

    The profiler gives a device span to the innermost range open on the
    launching thread only, so an outer range spans just its own kernels.
    The backward's kernels launch from autograd's own thread: the
    `dclip.backward.*` spans (`BackwardSpans`) open there and hold them,
    and the caller's `dclip.backward` spans next to nothing on the
    device."""
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
    busy_ms = unranged_ms = None
    if device_ms:
        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            if "CUDA" in str(e.device_type()):
                (spans if e.name().startswith("dclip.") else ops).append(
                    (int(e.start_ns()), int(e.end_ns())))
        busy_ns, unranged_ns = busy_and_unranged(ops, spans)
        busy_ms, unranged_ms = busy_ns / 1e6 / steps, unranged_ns / 1e6 / steps
    step_ms = 1e3 * wall_s / steps
    return {"device_ms": device_ms, "busy_ms": busy_ms,
            "busy": busy_ms / step_ms if busy_ms is not None else None,
            "unranged_ms": unranged_ms, "ranges": ranges, "kernels": kernels}
