"""BENCHMARK.json and the files it names, resolved by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's `file` holds the shipped TOML plus a `[bench]` table
(source, reduced, assumed); the mix is `traffic/<name>.json`; a per-layer
metric is `metrics/<name>.py` with `read(record) -> float | None`; a cell's
limits for `correct` are `limits/<cell>.json` (a null limit: read, not
compared); the configuration's `model.architecture` names its plain
reference, `arch/<architecture>.py` (arch/__init__.py). Nothing here
imports the program.
"""

from __future__ import annotations

import importlib.util
import json
import tomllib
from dataclasses import dataclass
from pathlib import Path

from bench_torch.arch import load as load_arch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def metric_file_name(name: str) -> str:
    """metrics/<name>.py; a dot in the metric's name becomes '__'."""
    return name.replace(".", "__") + ".py"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the TOML without [bench]
    bench: dict             # [bench]: source, reduced, assumed
    traffic: dict
    limits: dict
    end_to_end: list        # entries of BENCHMARK.json this cell reports
    per_layer: list
    root: Path

    def reader(self, metric: str):
        path = self.root / "metrics" / metric_file_name(metric)
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def arch(self):
        """The configuration's architecture module, arch/<architecture>.py."""
        return load_arch(self.root, self.config["model"]["architecture"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, repo: Path = REPO) -> Cell:
    bench = load_benchmark(repo)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(repo / cfg["file"], "rb") as f:
        raw = tomllib.load(f)
    meta = raw.pop("bench")
    root = repo / bench["paths"][0]
    with open(root / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name=name, chips=w["chips"], config=raw, bench=meta, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)], root=root)
