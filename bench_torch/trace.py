"""A device trace of a span of a run, reduced to what the per-layer metrics
and the breakdown read: the device's busy seconds (the union of its kernel,
copy and memset intervals) over the span's wall time, device seconds by
operation name, and the idle gaps, each named by the host span it fell in.

The span is traced with torch.profiler's CUDA activity alone (CUPTI), so
that no host operator is recorded. Its events carry wall-clock nanoseconds,
as `time.time_ns()` does; host spans are marked with that clock
(`HostSpans`). The union is utils/timing.py's `union_us`, copied.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

NAME_CHARS = 120


def union_ns(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class HostSpans:
    """Named host intervals in wall-clock ns, recorded while `on`."""

    def __init__(self):
        self.on = False
        self.spans: list[tuple[str, int, int]] = []

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, t0, time.time_ns()))
        return wrapped


class DeviceTrace:
    """with DeviceTrace(device) as tr: <span>; then tr.summary(spans)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.events: list[tuple[str, int, int]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        act = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            from torch.autograd import DeviceType
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                    continue
                s = e.start_ns()
                self.events.append((e.name(), s, s + e.duration_ns()))
        del self.prof
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self, spans: list[tuple[str, int, int]] = ()) -> dict:
        """busy_s, window_s, device seconds by name (`ops_s`), the ten
        longest (`device_ops`) and the ten longest idle gaps as [host span,
        seconds]. A gap lies in the host span that holds its midpoint, else in
        "other"."""
        t0, t1 = self.t0, self.t1
        inside = [(n, max(s, t0), min(e, t1)) for n, s, e in self.events if e > t0 and s < t1]
        ops_s: dict[str, float] = defaultdict(float)
        for n, s, e in inside:
            ops_s[n] += (e - s) / 1e9
        busy = union_ns([(s, e) for _, s, e in inside])
        gaps, last = [], t0
        for s, e in busy + [(t1, t1)]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)

        def host(mid: int) -> str:
            for name, s, e in spans:
                if s <= mid < e:
                    return name
            return "other"

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = [(host((s + e) // 2), (e - s) / 1e9) for s, e in longest]
        top = sorted(ops_s.items(), key=lambda x: -x[1])
        return {
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "ops_s": dict(ops_s),
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in named],
        }
