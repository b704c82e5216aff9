"""The reader of `bn_fused_share.train` (metrics/bn_fused_share__train.py):
100 x the program's `bn.train.fused` counter over `bn.train` in the traced
stretch; nothing from a program that does not count train-mode BatchNorm
calls (a parent without the counter), from a record without a traced span,
or from a program without the tracer.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import builtins

import pytest

from bench_torch import spec

NAME = "bn_fused_share.train"
TRACED = {"traced": {"busy_s": 1.0}}


def reader():
    return spec.resolve("b40c256.train").reader(NAME)


@pytest.mark.parametrize("counters,want", [
    ({"bn.train": 164, "bn.train.fused": 164}, 100.0),
    ({"bn.train": 164, "bn.train.fused": 41, "bn.train.plain": 123}, 25.0),
    ({"bn.train": 82, "bn.train.plain": 82}, 0.0),
    ({"plies": 16, "host_syncs": 17}, None),
])
def test_reader_reads_the_traced_counters(monkeypatch, counters, want):
    from keisei_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    got = reader()(TRACED)
    assert got == (None if want is None else pytest.approx(want))
    assert reader()({}) is None


def test_reader_reads_nothing_from_a_program_without_the_tracer(monkeypatch):
    real_import = builtins.__import__

    def no_tracer(mod, *args, **kwargs):
        if mod.startswith("keisei_tpu_torch"):
            raise ModuleNotFoundError(f"No module named {mod!r}")
        return real_import(mod, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert reader()(TRACED) is None


def test_the_metric_is_in_the_benchmark_with_the_training_cells():
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[NAME]
    assert m["workloads"] == ["b40c256.train", "b10c128.train"]
    assert (m["source"], m["better"], m["layer"], m["moves"]) == (
        "program_counter", "higher", "PPO update", "train_env_steps_per_s")
