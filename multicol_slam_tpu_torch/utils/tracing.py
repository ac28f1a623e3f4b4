"""Spans and counters at the port's layer boundaries, kept in memory.

    from multicol_slam_tpu_torch.utils import tracing
    tracing.enable()
    ...                              # run frames or solves
    records = tracing.records()      # completed spans, in completion order
    tracing.disable(); tracing.clear()

A span records its name, start and end (`time.perf_counter_ns()`), the
native id of its thread, its parent (the span open on the same thread when
it began) and a request: (kind, id), given by the span that starts the
request and inherited by the spans inside it. The tracker's spans carry
("frame", frame_id), the mapping worker's ("keyframe", slot) and a bundle
adjustment's ("solve", n), n counted by the tracer. A span opened with
`cpu=True` also records its thread's CPU time (`time.thread_time_ns()`).
Counters sit beside the spans: `span.count(name=value)` sets them in the
record's `counts`. A value may be a number, a device scalar or a callable
of no arguments that computes one when the counters are read
(`Record.read_counts`), so that counting launches no work inside the
traced stretch; nothing is read back while the program runs.

Off by default. Off, `span()` returns one shared no-op context manager:
nothing is allocated, no clock is read, nothing is recorded, and callers
compute no counter. On while a torch.profiler runs, each span also opens
`torch.profiler.record_function("mcs." + name)`, so the profiler's trace
shows the program's ranges on its own clock beside the kernels. (The
profiler records the ranges of the thread that started it only; the
records here cover every thread.)

`TracedLock` is a `threading.Lock` whose blocking acquisitions, while the
tracer is on, record a `lock.wait` span when the lock was held by another
thread (an uncontended acquisition records nothing).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch


class Record:
    """One completed span."""

    __slots__ = ("id", "name", "tid", "parent", "request", "start", "end", "cpu_ns", "counts")

    def __init__(self, id: int, name: str, tid: int, parent: int, request: Optional[Tuple[str, int]]):
        self.id, self.name, self.tid, self.parent, self.request = id, name, tid, parent, request
        self.start = self.end = 0
        self.cpu_ns: Optional[int] = None
        self.counts: Dict[str, object] = {}

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6

    def read_counts(self) -> Dict[str, float]:
        """The counters as plain numbers: callables called, device scalars
        read back (a host sync when they live on the card)."""
        out = {}
        for k, v in self.counts.items():
            if callable(v):
                v = v()
            out[k] = v.item() if hasattr(v, "item") else v
        return out

    def as_dict(self) -> dict:
        """The record as plain JSON values (counters read)."""
        return {"id": self.id, "name": self.name, "tid": self.tid, "parent": self.parent,
                "request": list(self.request) if self.request is not None else None,
                "start_ns": self.start, "end_ns": self.end, "cpu_ns": self.cpu_ns, "counts": self.read_counts()}


class _NoSpan:
    """The disabled span: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "rec", "cpu", "rf", "cpu0")

    def __init__(self, tracer: "Tracer", rec: Record, cpu: bool):
        self.tracer, self.rec, self.cpu, self.rf, self.cpu0 = tracer, rec, cpu, None, 0

    def count(self, **values):
        """Set counters of the record (numbers, or device scalars)."""
        self.rec.counts.update(values)

    def __enter__(self):
        self.tracer._stack().append(self.rec)
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("mcs." + self.rec.name)
            self.rf.__enter__()
        if self.cpu:
            self.cpu0 = time.thread_time_ns()
        self.rec.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.end = time.perf_counter_ns()
        if self.cpu:
            rec.cpu_ns = time.thread_time_ns() - self.cpu0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.tracer._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        self.tracer._records.append(rec)
        return False


class Tracer:
    """The process's spans and counters (module functions use one)."""

    def __init__(self):
        self.enabled = False
        self._records: List[Record] = []
        self._ids = itertools.count(1)
        self._requests: Dict[str, itertools.count] = {}
        self._local = threading.local()

    def _stack(self) -> List[Record]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name: str, kind: Optional[str] = None, rid: Optional[int] = None, cpu: bool = False):
        """A context manager around one layer's work. `kind` starts a request
        of that kind, identified by `rid` (None: the tracer's count of
        `kind`); without it the span joins its parent's request."""
        if not self.enabled:
            return NO_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else None
        if kind is not None:
            if rid is None:
                rid = next(self._requests.setdefault(kind, itertools.count(1)))
            request = (kind, rid)
        else:
            request = parent.request if parent is not None else None
        rec = Record(next(self._ids), name, threading.get_native_id(), parent.id if parent is not None else 0,
                     request)
        return _Span(self, rec, cpu)

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        self._records = []

    def records(self) -> List[Record]:
        return list(self._records)


TRACER = Tracer()
span = TRACER.span
enable = TRACER.enable
disable = TRACER.disable
clear = TRACER.clear
records = TRACER.records


class TracedLock:
    """A `threading.Lock`; while the tracer is on, a blocking acquisition
    that finds the lock held records the wait as a `lock.wait` span."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not TRACER.enabled or not blocking:
            return self._lock.acquire(blocking, timeout)
        if self._lock.acquire(False):
            return True
        with TRACER.span("lock.wait"):
            return self._lock.acquire(True, timeout)

    def __enter__(self):
        if TRACER.enabled:
            return self.acquire()
        return self._lock.acquire()

    def release(self):
        self._lock.release()

    def __exit__(self, *exc):
        self._lock.release()
        return False