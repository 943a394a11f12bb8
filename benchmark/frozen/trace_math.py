"""Reduction of a `torch.profiler` trace to the numbers the per-layer
metrics read: the benchmark's frozen copy of the range arithmetic of
`dclip_tpu_torch/core/metrics.py` `device_time_by_range` (commit
6dc6ebb3c2bb), with one repair.

Kept from the original: a `dclip.*` range's device time is the device span
of the work launched inside it, first start to last end, idle gaps
included (the profiler's `gpu_user_annotation` events), summed over its
occurrences; the step's ranges are named in `RANGES` order. The backward's
kernels launch from autograd's own thread, outside every range, so
`dclip.backward` spans next to nothing on the device and no metric reads
it.

The repair: the device's busy time is the length of the union of the
device operations' intervals (kernels, copies, sets), not the sum of their
durations, so work on overlapping streams counts once, and the idle time
is the traced window less that union. Each idle gap is named by the
innermost `dclip.*` range the host was in when the device started again
(the host was launching the work that ended the gap).

The trace comes in as plain `Event` tuples (`events_from_profiler`), so
the arithmetic runs without a card.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

RANGES = ("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.teacher_text",
          "dclip.cross_attention", "dclip.student_step", "dclip.backward",
          "dclip.grad_all_reduce", "dclip.optimizer")
WINDOW_RANGE = "bench.window"
NO_RANGE = "(outside every dclip range)"


class Event(NamedTuple):
    kind: str  # "device_op" | "device_range" | "host_range"
    name: str
    start_ns: int
    end_ns: int


def events_from_profiler(prof) -> List[Event]:
    """The kineto events of a finished `torch.profiler.profile` as `Event`s:
    on the device, the spans of the `dclip.*` ranges and every other event
    as an operation (kernels, copies, sets); on the host, the spans of the
    `dclip.*` ranges and of the window's own range."""
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ranged = name.startswith("dclip.") or name == WINDOW_RANGE
        start, end = int(e.start_ns()), int(e.end_ns())
        if "CUDA" in str(e.device_type()):
            out.append(Event("device_range" if ranged else "device_op", name, start, end))
        elif ranged:
            out.append(Event("host_range", name, start, end))
    return out


def union_intervals(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _innermost(host: List[Event], starts: List[int], t: int) -> str:
    """The innermost host range (latest start) that contains time t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if host[i].end_ns >= t:
            return host[i].name
        i -= 1
    return NO_RANGE


def summarize(events: List[Event], steps: int, top: int = 10) -> Optional[dict]:
    """The traced window's numbers, or None when it holds no device work.

    window_s      host span of the `bench.window` range (else first to last
                  event)
    busy_s        union of the device operations' intervals inside it
    ranges_s      {name: device span in seconds over the window} per
                  `dclip.*` range, `RANGES` order first
    device_ops    [[name, seconds]] the `top` device operations by summed
                  time
    idle_gaps     [[host range, seconds]] idle device time by the host
                  range that ended it, the `top` largest
    steps         as given"""
    ops = [e for e in events if e.kind == "device_op"]
    if not ops:
        return None
    window = [e for e in events if e.kind == "host_range" and e.name == WINDOW_RANGE]
    if window:
        w0, w1 = window[0].start_ns, window[0].end_ns
    else:
        w0 = min(e.start_ns for e in events)
        w1 = max(e.end_ns for e in events)
    busy = union_intervals((max(e.start_ns, w0), min(e.end_ns, w1)) for e in ops
                           if e.end_ns > w0 and e.start_ns < w1)
    busy_ns = sum(e - s for s, e in busy)

    spans: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.kind == "device_range" and e.name != WINDOW_RANGE:
            spans[e.name] += e.end_ns - e.start_ns
    order = [n for n in RANGES if n in spans] + sorted(set(spans) - set(RANGES))

    by_op: Dict[str, int] = defaultdict(int)
    for e in ops:
        by_op[e.name] += e.end_ns - e.start_ns

    host = sorted((e for e in events if e.kind == "host_range" and e.name != WINDOW_RANGE),
                  key=lambda e: e.start_ns)
    starts = [e.start_ns for e in host]
    idle: Dict[str, int] = defaultdict(int)
    cursor = w0
    for s, e in busy:
        if s > cursor:
            idle[_innermost(host, starts, s)] += s - cursor
        cursor = max(cursor, e)
    if w1 > cursor:
        idle[_innermost(host, starts, w1)] += w1 - cursor

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "ranges_s": {n: spans[n] / 1e9 for n in order},
            "device_ops": ranked(by_op), "idle_gaps": ranked(idle), "steps": steps}
