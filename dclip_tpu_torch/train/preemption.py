"""Cooperative preemption on SIGTERM (counterpart of
`dclip_tpu/train/preemption.py:34-126`).

Maintenance events and spot reclaims deliver SIGTERM with a short grace
window. `PreemptionGuard` turns the signal into a cooperative stop: the
handler only sets a flag; the trainer checks it at step boundaries and
raises `Preempted`, which `BaseTrainer.fit` turns into a tagged "preempt"
checkpoint before unwinding. The CLIs catch `Preempted` and exit 0, and a
later `--resume` restarts from the last epoch checkpoint.

Several processes: each gets its own signal, but a rank that stops alone
would hang the others inside the next collective. With more than one
process the guard honours the flag only at agreement points: every
`sync_every` steps all ranks all-gather their flags
(`parallel.multihost.allgather_flags`, a [P] gather) and stop together iff
any rank saw the signal; the agreement is sticky.
"""
from __future__ import annotations

import signal
from typing import Callable, Optional, Sequence


class Preempted(RuntimeError):
    """Raised at a step boundary after a preemption signal arrived."""


class PreemptionGuard:
    """Context manager: installs cooperative SIGTERM handling around fit().

    Previous handlers are chained (called after the flag is set) and
    restored on exit. Off the main thread it installs nothing and stays a
    no-op guard. `_allgather` and `_process_count` replace the real gather
    and process count in tests."""

    def __init__(
        self,
        signals: Sequence[int] = (signal.SIGTERM,),
        sync_every: int = 16,
        _allgather: Optional[Callable[[bool], Sequence[bool]]] = None,
        _process_count: Optional[int] = None,
    ):
        self.signals = tuple(signals)
        self.sync_every = max(int(sync_every), 1)
        self._flag = False
        self._agreed = False
        self._prev: dict = {}
        self._installed = False
        self._allgather = _allgather
        self._process_count = _process_count

    # -- signal plumbing --------------------------------------------------------

    def _handler(self, signum, frame):
        self._flag = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # Not the main thread: stay a no-op guard.
                self._prev.pop(s, None)
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._prev.clear()
        self._installed = False

    # -- queries ------------------------------------------------------------------

    @property
    def requested(self) -> bool:
        """This process saw a signal (no cross-process agreement)."""
        return self._flag

    def _processes(self) -> int:
        if self._process_count is not None:
            return self._process_count
        from dclip_tpu_torch.parallel.multihost import process_count

        return process_count()

    def _gather(self, flag: bool) -> Sequence[bool]:
        if self._allgather is not None:
            return self._allgather(flag)
        from dclip_tpu_torch.parallel.multihost import allgather_flags

        return allgather_flags(flag)

    def should_stop(self, step: int) -> bool:
        """Check at a step boundary; `step` is the 0-based step index.

        One process: the local flag, every step. Several: the sticky
        agreement, evaluated where `step % sync_every == 0`; every rank
        reaches the same gather in the same order."""
        if self._agreed:
            return True
        if self._processes() <= 1:
            return self._flag
        if step % self.sync_every == 0:
            self._agreed = any(self._gather(self._flag))
        return self._agreed
