"""Each cell's control in the program's place, through the harness's own
verdict, at a size a test can hold, on the CPU: the reference computed in
float8 (training cells) and the program's int8 forward (the fused rollout
cell) make `correct` come out false, on a number of precision and not on an
exact one. At the cells' own size the readings that set the limits are
calibrate.py's, on the card (PERF.md §2).
"""

from __future__ import annotations

import time

import pytest

from bench_torch import run
from bench_torch.tests.test_faults import tiny

EXACT = ("minibatch_rows_off", "illegal_actions", "engine_off")


@pytest.mark.parametrize("name", ["b40c256.train", "b10c128.train", "b40c256.rollout-n1024"])
def test_the_control_in_the_programs_place_is_not_correct(name):
    cell = tiny(name)
    if cell.traffic["kind"] == "rollout_calls":
        # int8's distance from float32 grows with depth: at 2 blocks it stays
        # within the tolerance, at the cell's 40 it does not; batches of 32
        cell.config["model"]["params"].update(num_blocks=40, channels=64)
        cell.config["training"]["num_games"] = 32
    line = run.run_cell(cell, 2 ** 31 + 103, 0.5, False, "cpu", t0=time.monotonic(),
                        control=True)
    assert line["correct"] is False, line["checks"]
    failed = {k for k, c in line["checks"].items() if not c["value"] <= c["limit"]}
    assert failed and not failed & set(EXACT), line["checks"]
