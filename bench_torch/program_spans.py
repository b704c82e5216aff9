"""The program's own spans and counters in the traced stretch, for the
per-layer metrics that read inside the program.

The program's tracer (keisei_tpu_torch/utils/tracing.py) is on while a
torch.profiler session runs, so the traced span's DeviceTrace turns it on,
and a new stretch clears what it held: after the traced span it holds that
span's spans and counters alone. Each span is a dict with its name, start
and end (ns on time.time_ns()'s clock), parent, epoch, index, the host syncs it holds
(`sync`) and, where it recorded CUDA events, `device_ms`. A program without
the tracer, or a record without a traced span, gives nothing.
"""

from __future__ import annotations

from collections import defaultdict


def stretch(record: dict):
    """(spans, counters) of the traced stretch, or None."""
    if not record.get("traced"):
        return None
    try:
        from keisei_tpu_torch.utils import tracing
    except ImportError:  # a program that has no tracer
        return None
    return tracing.spans(), tracing.counters()


def named(record: dict, name: str) -> list[dict] | None:
    """The traced stretch's spans called `name`, or None if it has none."""
    got = stretch(record)
    if got is None:
        return None
    spans = [s for s in got[0] if s["name"] == name]
    return spans or None


def mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def ply_launch_ms(record: dict) -> float | None:
    """Mean host ms of a traced ply outside its host-sync spans: the time
    spent issuing the ply."""
    got = stretch(record)
    if got is None:
        return None
    spans = got[0]
    kids = defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)

    def sync_ms(span: dict) -> float:
        return sum(host_ms(k) if k["sync"] else sync_ms(k) for k in kids[span["id"]])

    return mean([host_ms(s) - sync_ms(s) for s in spans if s["name"] == "ply"])


def rollout_ms_per_ply(record: dict) -> float | None:
    """The traced `rollout` spans' host ms over the plies they hold: a ply's
    launches and every wait of the rollout, wherever it lands."""
    got = stretch(record)
    if got is None:
        return None
    rollouts = {s["id"]: s for s in got[0] if s["name"] == "rollout"}
    plies = sum(1 for s in got[0] if s["name"] == "ply" and s["parent"] in rollouts)
    return sum(map(host_ms, rollouts.values())) / plies if plies else None


def mean_host_ms(record: dict, name: str) -> float | None:
    spans = named(record, name)
    return mean([host_ms(s) for s in spans]) if spans else None


def mean_device_ms(record: dict, name: str) -> float | None:
    spans = named(record, name)
    return mean([s["device_ms"] for s in spans if "device_ms" in s]) if spans else None


def per_ply(record: dict, counter: str) -> float | None:
    """A counter of the traced stretch over its `plies` counter."""
    got = stretch(record)
    if got is None or not got[1].get("plies"):
        return None
    return got[1].get(counter, 0) / got[1]["plies"]
