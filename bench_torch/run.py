"""Run one cell of BENCHMARK.json once and print its result line.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the program's kernel library, the
weights from the seed, the warm-up unit) is timed from the start of this
process to the first timed unit (`setup_s`). Units (training epochs or
rollout calls, by the mix's `kind`) then run back to back until
`--seconds` have passed; the last one started finishes and counts, and a
rate is all the window's work over all its wall time. With `--trace 1` the
run then traces a further span and reports the cell's per-layer metrics
instead of its end-to-end ones. Last, with the program's state freed, the
plain reference checks what the timed path produced (`correct`).

The last line of stdout is one JSON object; the numbers compared for
`correct` close it (key "checks") and stderr. Without a card, or with
fewer cards than the cell asks for, it prints no result and exits 2. If
the process holds JAX or the JAX package once the window has closed, or
after the check, it names what it found on stderr, prints no result and
exits 3.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# the program's build and kernel caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402

from bench_torch import spec  # noqa: E402

KINDS = {"train_epochs": "bench_torch.train_cell", "rollout_calls": "bench_torch.rollout_cell"}
# top-level module names the measured process may not hold: JAX and the JAX package
FOREIGN = frozenset({"jax", "jaxlib", "flax", "keisei_tpu"})


class ForeignModules(RuntimeError):
    """The process holds a module of FOREIGN: the run has no result."""


def refuse_foreign(when: str) -> None:
    found = sorted({name.split(".")[0] for name in list(sys.modules)} & FOREIGN)
    if found:
        raise ForeignModules(f"{when}, the process holds {', '.join(found)}")


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, control: bool = False, readings: dict | None = None) -> dict:
    """One run of `cell` on `device`; the result line as a dict. With
    `control`, the cell's control takes the program's place in the check
    (calibrate.py, the tests); `readings` receives every reading of the
    check, those not compared too."""
    import importlib
    kind = importlib.import_module(KINDS[cell.traffic["kind"]])
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as tmp:
        out = kind.run(cell, seed, seconds, trace, device, t0, tmp)
    refuse_foreign("once the window had closed")
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["peak"]}
    line = {"correct": False, "attempted": out["units"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        tr = out["record"]["traced"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    gc.collect()  # the program's state, before the reference takes the card
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    try:
        args = (out["setup"], out["kept"]) if "kept" in out else (out["setup"],)
        got = kind.check(*args, cell.limits, control=control)
        if readings is not None:
            readings.update(got)
        # a number whose limit is null is read and not compared (PERF.md §2)
        checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in got.items()
                  if not k.startswith("_") and cell.limits[k] is not None}
    except Exception:  # the check itself failed: no reading, not correct
        traceback.print_exc()
        checks = {"check_error": {"value": 1, "limit": 0}}
    refuse_foreign("after the check")
    line["correct"] = all(within(c["value"], c["limit"]) for c in checks.values()) \
        and out["failed"] == 0
    line["checks"] = checks
    print(f"the check took {time.monotonic() - t_check:.1f} s", file=sys.stderr)
    units = out["record"]["unit_s"]
    print(f"{len(units)} units, seconds each: {' '.join(f'{u:.3f}' for u in units)}",
          file=sys.stderr)
    epochs = out["record"].get("epochs")
    if epochs:  # where a training window's time went, by EpochMetrics
        parts = {k: sum(e[k] for e in epochs) for k in ("rollout_time", "update_time",
                                                        "maint_time")}
        parts["after_upkeep"] = sum(units) - sum(parts.values())
        print("window seconds: " + " ".join(f"{k} {v:.4f}" for k, v in parts.items()),
              file=sys.stderr)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    readings: dict = {}
    try:
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                        readings=readings)
    except ForeignModules as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, v in readings.items():  # beside the compared numbers, not compared
        if name not in line["checks"] and isinstance(v, (int, float)):
            print(f"reading {name} = {v!r}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
