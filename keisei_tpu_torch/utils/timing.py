"""Timing on the card: the CUDA-event time of a call (cuda_ms; graph_ms with
the calls replayed from a CUDA graph, for kernels shorter than their launch
from Python), and the card's name and power limit as nvidia-smi reports them
(a card set below 700 W runs slower under load, so every recorded time
stands beside this line)."""

from __future__ import annotations

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


def graph_ms(fn, iters: int = 20, counters: tuple[Counter, ...] = ()) -> float:
    """Mean device time of fn() in ms with no host in the loop: `iters`
    calls captured in one CUDA graph after a warm-up call, the graph
    replayed once untimed, then once between CUDA events. cuda_ms of a
    kernel that runs for less time than Python takes to launch it reads the
    host's launch rate instead.

    `counters` are the launch counters of the wrappers fn calls: a wrapper
    counts when it is called, and under capture nothing is launched, so the
    capture's counts are taken back and each replay adds them."""
    fn()
    torch.cuda.synchronize()
    before = [Counter(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    per_replay = [Counter(c) - b for c, b in zip(counters, before)]
    for c, d in zip(counters, per_replay):
        c.subtract(d)

    def replay() -> None:
        graph.replay()
        for c, d in zip(counters, per_replay):
            c.update(d)

    replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
