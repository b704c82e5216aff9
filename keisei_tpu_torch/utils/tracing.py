"""Spans and counters at the layer boundaries of the self-play epoch.

A span records its name; its start and end on the span clock; its parent,
the span open around it on the same thread; its thread; the trainer's
epoch (given to the outermost span, inherited below it: the spans of one
epoch share it as their identifier); and an index (the ply, the
minibatch). The span clock is `time.monotonic_ns()` shifted onto
`time.time_ns()` by one offset taken when a stretch starts: durations are
monotonic, and a span lines up with the kernels launched inside it, whose
times a torch.profiler (CUPTI) trace gives in `time.time_ns()`'s
nanoseconds. A span given a CUDA `device` also records a CUDA event pair
around itself if its name is one the tracer times (`EVENTS` by default,
what a metric reads; `enable(events=...)` names others), whose elapsed time
`spans()` reads after a synchronize, never on the hot path. A span given
`sync=n` is a host sync: its code waits for the device n times, and it
counts them under `host_syncs` and `host_syncs.<name>`. Counters are named
integers, incremented at the same boundaries.

The tracer is on while a torch.profiler session is active (the flag the
profiler sets) and after `enable()` until `disable()`; off otherwise. Off,
`span()` returns one shared no-op context manager and `count()` returns at
once: nothing is allocated or recorded. A stretch is a time the tracer is
on without a break, seen from the first span or count after it turns on;
a new stretch clears the buffer, so it holds the latest stretch's spans
(at most MAX_SPANS, the oldest dropped first and counted under
`tracing.dropped`) and counters.

    with tracing.span("ply", index=t):
        ...
    tracing.count("plies")
    tracing.spans(); tracing.counters(); tracing.dump(path)
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import threading
import time

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16
EVENTS = frozenset({"engine.step"})  # the spans whose CUDA events a metric reads


class _NoSpan:
    """The span of a tracer that is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def close(self, end_ns: int | None = None) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One open or closed span; a context manager, or opened by `Tracer.open`
    and closed by `close(end_ns)`. Stamps given to it are `time.monotonic_ns()`'s."""

    __slots__ = ("tracer", "id", "name", "start", "end", "parent", "thread", "epoch", "index",
                 "sync", "events", "device_ms")

    def __init__(self, tracer: "Tracer", name: str, start: int | None, epoch, index,
                 device, sync: int):
        self.tracer, self.name, self.index, self.sync = tracer, name, index, sync
        self.id = next(tracer._ids)
        stack = tracer._stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        self.epoch = epoch if epoch is not None or parent is None else parent.epoch
        self.thread = threading.current_thread().name
        self.events = self.device_ms = None
        self.end = None
        if sync:
            tracer.count("host_syncs", kind=name, n=sync)
        if (device is not None and name in tracer._events
                and torch.device(device).type == "cuda"):
            stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        stack.append(self)
        self.start = (time.monotonic_ns() if start is None else start) + tracer._offset

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self, end_ns: int | None = None) -> None:
        self.end = (time.monotonic_ns() if end_ns is None else end_ns) + self.tracer._offset
        if self.events is not None:
            self.events[1].record(self.events[2])
        stack = self.tracer._stack()
        # spans left open above this one (an exception passed through them) close with it
        while stack:
            if stack.pop() is self:
                break
        self.tracer._keep(self)


class Tracer:
    """Spans and counters in a bounded in-memory buffer; see the module's
    docstring. The program records into the module's one tracer."""

    def __init__(self):
        self._enabled = False
        self._live = False  # whether the last span or count found the tracer on
        self._events = EVENTS
        self._offset = 0  # time_ns() - monotonic_ns() at the stretch's start
        self._spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self._counters: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    # -- on and off -----------------------------------------------------------

    def enable(self, events=EVENTS) -> None:
        """Turn the tracer on until `disable()`; a new stretch starts. Spans
        named in `events` and given a CUDA device record CUDA events."""
        self._enabled, self._live, self._events = True, False, frozenset(events)

    def disable(self) -> None:
        self._enabled, self._events = False, EVENTS

    def on(self) -> bool:
        """Whether the tracer records: after `enable()` or under torch.profiler."""
        if self._enabled or _profiler._is_profiler_enabled:
            if not self._live:
                self._new_stretch()
            return True
        if self._live:
            self._live = False
        return False

    def _new_stretch(self) -> None:
        with self._lock:
            if not self._live:
                self._spans.clear()
                self._counters.clear()
                self._local = threading.local()
                self._offset = time.time_ns() - time.monotonic_ns()
                self._live = True

    # -- recording ------------------------------------------------------------

    def span(self, name: str, *, epoch: int | None = None, index: int | None = None,
             device=None, sync: int = 0):
        """A context manager that records the span `name` while the tracer is
        on; the shared no-op `NO_SPAN` while it is off."""
        if not (self._enabled or _profiler._is_profiler_enabled):  # off: the hot path
            if self._live:
                self._live = False
            return NO_SPAN
        return self.open(name, epoch=epoch, index=index, device=device, sync=sync)

    def open(self, name: str, start_ns: int | None = None, *, epoch: int | None = None,
             index: int | None = None, device=None, sync: int = 0):
        """`span()` opened at the `time.monotonic_ns()` stamp `start_ns` (now
        by default); `close(end_ns)` ends it."""
        if not self.on():
            return NO_SPAN
        return Span(self, name, start_ns, epoch, index, device, sync)

    def count(self, name: str, kind: str | None = None, n: int = 1) -> None:
        """Add `n` to the counter `name` and, with `kind`, to `name.kind`."""
        if not (self._enabled or _profiler._is_profiler_enabled):  # off: the hot path
            if self._live:
                self._live = False
            return
        if not self._live:
            self._new_stretch()
        with self._lock:
            self._counters[name] += n
            if kind is not None:
                self._counters[f"{name}.{kind}"] += n

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._counters["tracing.dropped"] += 1
            self._spans.append(span)

    # -- reading --------------------------------------------------------------

    def spans(self) -> list[dict]:
        """The latest stretch's closed spans in the order they ended, each a
        dict: id, name, start_ns, end_ns, parent, thread, epoch, index, sync,
        self_ns (its duration less the union of its children's) and, where it
        recorded CUDA events, device_ms."""
        with self._lock:
            kept = list(self._spans)
        children: dict = collections.defaultdict(list)
        for s in kept:
            if s.parent is not None:
                children[s.parent].append((s.start, s.end))
        for s in kept:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        out = []
        for s in kept:
            covered, last = 0, s.start
            for a, b in sorted(children.get(s.id, ())):
                a, b = max(a, last), min(b, s.end)
                if b > a:
                    covered += b - a
                    last = b
            d = {"id": s.id, "name": s.name, "start_ns": s.start, "end_ns": s.end,
                 "parent": s.parent, "thread": s.thread, "epoch": s.epoch, "index": s.index,
                 "sync": s.sync, "self_ns": s.end - s.start - covered}
            if s.device_ms is not None:
                d["device_ms"] = s.device_ms
            out.append(d)
        return out

    def counters(self) -> dict[str, int]:
        """The latest stretch's counters."""
        with self._lock:
            return dict(self._counters)

    def dump(self, path: str) -> None:
        """Write the latest stretch as JSON lines: one a span, then one
        `{"counters": {...}}`."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps(s) + "\n")
            f.write(json.dumps({"counters": self.counters()}) + "\n")


class Phases:
    """Back-to-back spans that share their bounds: `next(name)` takes one
    stamp, closes the phase open before it there and opens `name` there;
    `next()` closes the last. Returns the stamp (`time.monotonic_ns()`),
    taken whether the tracer is on or off."""

    def __init__(self, tracer: "Tracer | None" = None):
        self.tracer = tracer or TRACER
        self._open = NO_SPAN

    def next(self, name: str | None = None) -> int:
        t = time.monotonic_ns()
        self._open.close(t)
        self._open = self.tracer.open(name, t) if name is not None else NO_SPAN
        return t


TRACER = Tracer()


def traced(name: str):
    """Decorate a function so that each of its calls is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with TRACER.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap

span = TRACER.span
open_span = TRACER.open
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
spans = TRACER.spans
counters = TRACER.counters
dump = TRACER.dump
