"""The readers of the program's spans and counters (bench_torch/
program_spans.py and the metrics that use it): a number from a synthetic
traced stretch, nothing from a record without a traced span or from a
program without the tracer.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import builtins

import pytest

from bench_torch import spec

READERS = ["ply_launch_ms.train", "rollout_ms_per_ply.train", "engine_ms_per_ply.train",
           "minibatch_host_ms.train", "observer_ms_per_epoch.train", "ply_launch_ms.rollout",
           "rollout_ms_per_ply.rollout", "host_syncs_per_ply.rollout"]
MS = 1_000_000


def span(id_, name, start_ms, end_ms, parent=None, sync=0, **extra):
    return {"id": id_, "name": name, "start_ns": start_ms * MS, "end_ns": end_ms * MS,
            "parent": parent, "thread": "MainThread", "epoch": 1, "index": None,
            "sync": sync, **extra}


# a rollout of 30 ms holding two plies of 10 and 14 ms, each blocked 2 and
# 6 ms in its truncation check; engine steps of 3 and 5 device ms;
# minibatches of 20 and 40 ms; an observe phase of 7 ms; 3 host syncs over
# the 2 plies
SPANS = [
    span(1, "epoch", 0, 200),
    span(2, "rollout", 0, 30, parent=1),
    span(3, "ply", 0, 10, parent=2),
    span(4, "engine.step", 1, 4, parent=3, device_ms=3.0),
    span(5, "truncation.check", 5, 7, parent=3, sync=1),
    span(6, "ply", 10, 24, parent=2),
    span(7, "engine.step", 11, 16, parent=6, device_ms=5.0),
    span(8, "truncation.check", 16, 22, parent=6, sync=1),
    span(9, "update", 30, 100, parent=1),
    span(10, "minibatch", 30, 50, parent=9),
    span(11, "minibatch", 50, 90, parent=9),
    span(12, "phase.observe", 110, 117, parent=1),
]
COUNTERS = {"plies": 2, "host_syncs": 3}
WANT = {"ply_launch_ms.train": 8.0, "rollout_ms_per_ply.train": 15.0,
        "engine_ms_per_ply.train": 4.0, "minibatch_host_ms.train": 30.0,
        "observer_ms_per_epoch.train": 7.0, "ply_launch_ms.rollout": 8.0,
        "rollout_ms_per_ply.rollout": 15.0, "host_syncs_per_ply.rollout": 1.5}


def reader(name):
    cells = {m["name"]: m["workloads"][0] for m in spec.load_benchmark()["per_layer"]}
    return spec.resolve(cells[name]).reader(name)


@pytest.fixture
def stretch(monkeypatch):
    from keisei_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "spans", lambda: [dict(s) for s in SPANS])
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_synthetic_stretch(stretch, name):
    assert reader(name)({"traced": {"busy_s": 1.0}}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_traced_span(stretch, name):
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    real_import = builtins.__import__

    def no_tracer(mod, *args, **kwargs):
        if mod.startswith("keisei_tpu_torch"):
            raise ModuleNotFoundError(f"No module named {mod!r}")
        return real_import(mod, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert reader(name)({"traced": {"busy_s": 1.0}}) is None


def test_each_reader_is_in_the_benchmark_with_its_cells():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] and m["better"] == "lower"
        assert m["source"] in ("program_span", "program_counter")
