"""The readings that the limits of `correct` are set from, on the card at a
cell's own size, each through a whole run of the harness (run.run_cell)
with a short window: the program's numbers on many seeds (the lower
reading), the control's in the program's place on a few (the reference one
precision down for a training cell, the program's int8 forward for a fused
rollout cell) and each planted fault's (faults.py) on a few, each with the
harness's verdict under the cell's limits. One JSON line a run.

    python3 bench_torch/calibrate.py --workload <name> --seeds 12 --seconds 10 \
        [--control-seeds 3] [--fault-seeds 3] [--faults half_batch,answer_altered] \
        [--no-program] [--out file.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import faults, run, spec  # noqa: E402


def one(cell, seed: int, seconds: float, control: bool, fault: str | None) -> dict:
    readings: dict = {}
    t0 = time.monotonic()
    if fault:
        with faults.FAULTS[fault]():
            line = run.run_cell(cell, seed, seconds, False, "cuda", t0=t0, readings=readings)
    else:
        line = run.run_cell(cell, seed, seconds, False, "cuda", t0=t0, control=control,
                            readings=readings)
    return {"workload": cell.name, "seed": seed, "side": "control" if control else fault
            or "program", "correct": line["correct"], "run_s": time.monotonic() - t0,
            "setup_s": line["metrics"]["setup_s"]["value"],
            "peak_gb": line["device"]["memory_peak_bytes"] / 1e9, "readings": readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_147_483_000)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--no-program", action="store_true", help="the control and faults only")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py reads the card; this machine has none", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    plan = [] if args.no_program else [(s, False, None) for s in seeds]
    plan += [(s, True, None) for s in seeds[:args.control_seeds]]
    for f in filter(None, args.faults.split(",")):
        plan += [(s, False, f) for s in seeds[:args.fault_seeds]]
    for seed, control, fault in plan:
        torch.cuda.reset_peak_memory_stats()
        line = json.dumps(one(cell, seed, args.seconds, control, fault), default=str)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
