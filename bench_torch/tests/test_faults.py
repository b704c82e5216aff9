"""A run driven on the CPU past the harness's look for a card, at a size a
test can hold, with the timed path sound and with each fault a cell can
have planted under it (bench_torch/faults.py): `correct` comes out true and
then false. The program runs in float32 here, so that its sound readings
are rounding alone and the cells' limits apply; the control's separation in
the configured precision is tests/test_control.py's.
"""

from __future__ import annotations

import time

import pytest

from bench_torch import faults, run, spec

TINY = dict(num_blocks=2, channels=32, se_reduction=16, global_pool_channels=16,
            policy_channels=8, value_fc_size=16, score_fc_size=8, obs_channels=50,
            dtype="float32")
CELL_FAULTS = {
    "b40c256.train": ["state_unchanged", "half_batch", "answer_altered", "engine_stale_action"],
    "b10c128.train": ["state_unchanged", "half_batch", "answer_altered", "engine_stale_action"],
    "b40c256.rollout-n1024": ["answer_altered", "engine_stale_action"],
}


def tiny(name: str) -> spec.Cell:
    cell = spec.resolve(name)
    cell.config["model"]["params"] = dict(TINY)
    cell.config["training"]["num_games"] = 8
    cell.config["training"].setdefault("algorithm_params", {})["batch_size"] = 16
    cell.traffic = {k: v for k, v in cell.traffic.items() if k != "training"}
    if cell.traffic["kind"] == "rollout_calls":
        cell.traffic["forward"] = "eager"
    return cell


def one_run(cell, fault=None) -> dict:
    if fault is None:
        return run.run_cell(cell, 2 ** 31 + 101, 0.5, False, "cpu", t0=time.monotonic())
    with faults.FAULTS[fault]():
        return run.run_cell(cell, 2 ** 31 + 101, 0.5, False, "cpu", t0=time.monotonic())


@pytest.mark.parametrize("name,fault", [(n, None) for n in CELL_FAULTS]
                         + [(n, f) for n, fs in CELL_FAULTS.items() for f in fs])
def test_correct_is_false_under_each_fault_and_true_without(name, fault):
    line = one_run(tiny(name), fault)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
