"""Timing on the card: the CUDA-event time of a call (cuda_ms; graph_ms with
the calls replayed from a CUDA graph, for kernels shorter than their launch
from Python), the device time of each kernel inside a call from a profiler
trace (trace_kernel_us, traced_kernel_ms), the device's busy share over a
window of calls (device_busy), and the card's name and power limit as
nvidia-smi reports them (a card set below 700 W runs slower under load, so
every recorded time stands beside this line)."""

from __future__ import annotations

import re
import subprocess
from collections import Counter

import torch


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls
    after `warmup` untimed ones."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counts(counter) -> Counter:
    """A launch counter's counts: a Counter as it is, a wrapper function
    through its integer `launches`."""
    return Counter(counter) if isinstance(counter, Counter) else Counter(n=counter.launches)


def _add_counts(counter, delta: Counter, sign: int) -> None:
    if isinstance(counter, Counter):
        for key, n in delta.items():
            counter[key] += sign * n
    else:
        counter.launches += sign * delta["n"]


def graph_ms(fn, iters: int = 20, counters: tuple = ()) -> float:
    """Mean device time of fn() in ms with no host in the loop: `iters`
    calls captured in one CUDA graph after a warm-up call, the graph
    replayed once untimed, then once between CUDA events. cuda_ms of a
    kernel that runs for less time than Python takes to launch it reads the
    host's launch rate instead.

    `counters` are the launch counters of the wrappers fn calls, each a
    Counter or a wrapper function that counts in an integer `launches`: a
    wrapper counts when it is called, and under capture nothing is
    launched, so the capture's counts are taken back and each replay adds
    them."""
    fn()
    torch.cuda.synchronize()
    before = [_counts(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    per_replay = [_counts(c) - b for c, b in zip(counters, before)]
    for c, d in zip(counters, per_replay):
        _add_counts(c, d, -1)

    def replay() -> None:
        graph.replay()
        for c, d in zip(counters, per_replay):
            _add_counts(c, d, 1)

    replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Calls made inside a trace before the ones that are measured. A trace lacks
# launches from just after its start (seen on an H100: between none and the
# first 4 of 21 calls, whole calls and part of one, never a later launch), so
# these are there to be lost and traced_kernel_ms reads the trace from its end.
TRACE_LEAD = 5


def trace_kernel_us(fn, calls: int) -> dict[str, list[float]]:
    """Device time in microseconds of every kernel launch, by kernel name
    and in launch order, in a torch.profiler (CUPTI) trace of TRACE_LEAD +
    calls calls of fn() after an untraced warm-up call (copies and memsets
    left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LEAD):
            fn()
            torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = sorted((e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.lower().startswith(("memcpy", "memset")))
    times: dict[str, list[float]] = {}
    for _, name, us in launches:
        times.setdefault(name, []).append(us)
    return times


def union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_busy(fn, calls: int) -> dict[str, float]:
    """The device's busy share over `calls` calls of fn() (after an untraced
    warm-up call and TRACE_LEAD traced lead calls) in a torch.profiler
    (CUPTI) trace: the union of its kernel, copy and memset intervals inside
    the window, over the window's length (the host's launches and the final
    synchronize included); and the kernels launched per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LEAD):
            fn()
        torch.cuda.synchronize()
        with record_function("device_busy_window"):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    # the window's range on the host; record_function also leaves a device-side
    # annotation of it (and autograd and the optimizer leave theirs): no
    # annotation is device work
    window = [e for e in events if e.name == "device_busy_window"
              and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} busy windows, not 1")
    t0, t1 = window[0].time_range.start, window[0].time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation
              and e.time_range.end > t0 and e.time_range.start < t1]
    kernels = [e for e in device if t0 <= e.time_range.start
               and not e.name.lower().startswith(("memcpy", "memset"))]
    busy = union_us([(max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in device])
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "kernels_per_call": len(kernels) / calls}


def traced_kernel_ms(trace: dict[str, list[float]], pattern: str, calls: int,
                     per_call: int = 1) -> tuple[float, int]:
    """Mean ms per launch over the last calls * per_call launches in `trace`
    (trace_kernel_us(fn, calls)) of the kernels whose name, spaces removed,
    matches the regular expression `pattern`, where fn launches them
    `per_call` times; and how many launches of them the trace holds, of the
    (TRACE_LEAD + calls) * per_call made. Raises if it holds fewer than the
    mean needs or more than were made, or if the pattern matches two kernels."""
    names = [name for name in trace if re.search(pattern, name.replace(" ", ""))]
    if len(names) > 1:  # two kernels' launches would not be in one launch order
        raise RuntimeError(f"{pattern} matches more than one traced kernel: {names}")
    us = trace[names[0]] if names else []
    used, made = calls * per_call, (TRACE_LEAD + calls) * per_call
    if not used <= len(us) <= made:
        raise RuntimeError(f"the trace holds {len(us)} launches of {pattern}, not {used} to "
                           f"{made}: {sorted(trace)}")
    return sum(us[-used:]) / used / 1e3, len(us)


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
