"""CPU self-tests of the benchmark: the cells resolve by name, names and
units keep to the allowed characters, a cell added as files alone is found,
the FLOP counts follow the widths, the plain reference equals the port's
eager model, and the harness refuses to run without a card.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_torch import flops, reference as R, spec

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = dict(num_blocks=2, channels=32, se_reduction=16, global_pool_channels=16,
            policy_channels=8, value_fc_size=16, score_fc_size=8, obs_channels=50)
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_its_files_by_name(name):
    cell = spec.resolve(name)
    assert cell.traffic["kind"] in ("train_epochs", "rollout_calls")
    assert set(cell.bench) >= {"source", "reduced", "assumed"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert cell.reader(m["name"])({}) is None  # nothing to read: no number
    assert set(cell.limits) and all(isinstance(v, (int, float)) or v is None
                                    for v in cell.limits.values())


def test_names_and_units_keep_to_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 0 < len(x) <= 200 for x in layers)
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in ends for m in BENCH["per_layer"])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(REPO / "bench_torch", repo / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mix = json.loads((repo / "bench_torch/traffic/train-t16.json").read_text())
    (repo / "bench_torch/traffic/train-t8.json").write_text(
        json.dumps({**mix, "training": {"steps_per_epoch": 8}}))
    (repo / "bench_torch/limits/b40c256.train-t8.json").write_text(
        (repo / "bench_torch/limits/b40c256.train.json").read_text())
    (repo / "bench_torch/metrics/epochs_in_window.py").write_text(
        "def read(record):\n    return len(record.get('epochs', [])) or None\n")
    bench["workloads"].append({"name": "b40c256.train-t8", "config": "b40c256",
                               "traffic": "train-t8", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "epochs_in_window", "unit": "epochs", "better": "higher",
                               "source": "host_clock", "layer": "rollout",
                               "moves": "train_env_steps_per_s",
                               "workloads": ["b40c256.train-t8"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("b40c256.train-t8", repo)
    assert cell.traffic["training"] == {"steps_per_epoch": 8}
    assert [m["name"] for m in cell.per_layer] == ["epochs_in_window"]
    assert cell.reader("epochs_in_window")({"epochs": [1, 2]}) == 2


@pytest.mark.parametrize("config,trunk_gflop", [("b40c256", 7.66), ("b10c128", 0.478)])
def test_flop_counts_follow_the_widths(config, trunk_gflop):
    cfg = {c["name"]: c for c in BENCH["configs"]}[config]
    import tomllib
    w = R.Widths.from_params(tomllib.loads((REPO / cfg["file"]).read_text())["model"]["params"])
    trunk = flops.trunk_conv_flops(w)
    assert trunk == w.num_blocks * 2 * 81 * w.channels * w.channels * 9 * 2
    assert abs(trunk / 1e9 / trunk_gflop - 1) < 0.01
    assert trunk < flops.forward_flops(w) < 1.03 * trunk
    assert flops.training_flops(w, 10, 4) == 22 * flops.forward_flops(w)
    # the block's bound at B=1024 is its convs over the bf16 peak (0.198 ms for b40c256)
    if config == "b40c256":
        assert abs(flops.trunk_bound_s(w, 1024) / 40 * 1e3 - 0.198) < 0.003


@pytest.mark.parametrize("train", [False, True])
def test_the_plain_reference_equals_the_ports_eager_model(train):
    from keisei_tpu_torch.models.registry import build_model
    w = R.Widths.from_params(TINY)
    state = R.init_state(w, 2 ** 31 + 9, "cpu")
    model, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    model.load_state_dict(state, strict=True)
    model.train(train)
    obs = (torch.rand(6, 50, 81, generator=torch.Generator().manual_seed(3)) < 0.2).float()
    with torch.no_grad():
        out = model(obs.reshape(6, 50, 9, 9))
        ref = R.Net(w).forward(state, obs, train)
    for got, want in zip((out.policy_logits, out.value_logits, out.score_lead), ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_init_state_is_a_function_of_the_seed():
    w = R.Widths.from_params(TINY)
    a, b = R.init_state(w, 2 ** 31 + 1, "cpu"), R.init_state(w, 2 ** 31 + 1, "cpu")
    c = R.init_state(w, 2 ** 31 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_conv.weight"], c["input_conv.weight"])


def test_the_harness_exits_without_a_result_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0], "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_minibatch_rows_off_counts_rows_left_out_repeated_or_of_other_bits():
    from types import SimpleNamespace

    from bench_torch import train_cell
    hp = {"batch_size": 4, "epochs_per_batch": 2}
    g = torch.Generator().manual_seed(5)
    p1, p2 = torch.randperm(8, generator=g), torch.randperm(8, generator=g)
    zero = [torch.tensor(0)] * 4

    def rec(ix, rows_off=zero):
        return SimpleNamespace(ix=ix, rows_off=rows_off)
    sound = [p1[:4], p1[4:], p2[:4], p2[4:]]
    assert train_cell.minibatch_rows_off(rec(sound), 8, hp) == 0
    assert train_cell.minibatch_rows_off(rec(sound[:3]), 8, hp) == 8
    repeated = [p1[:4], p1[[0, 5, 6, 7]], p2[:4], p2[4:]]
    assert train_cell.minibatch_rows_off(rec(repeated), 8, hp) == 1
    bits = [torch.tensor(0), torch.tensor(2), torch.tensor(0), torch.tensor(0)]
    assert train_cell.minibatch_rows_off(rec(sound, bits), 8, hp) == 2


def test_the_rules_reference_plays_the_engines_games_transition_for_transition():
    from bench_torch import engine_check
    from keisei_tpu_torch.env.vec_env import EnvCore
    env = EnvCore(16, 60, 50, "cpu")
    tape = engine_check.Tape(16, 16, 2 ** 31 + 11, "cpu", 60)
    states, _, mask = env.init()
    g = torch.Generator().manual_seed(11)
    for _ in range(150):  # every env finishes at least two games
        a = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0).argmax(dim=1)
        states, eo = env.step(states, a)
        tape.record(a, eo)
        mask = eo.legal_mask
    got = engine_check.check(tape)
    assert got["engine_off"] == 0 and got["_engine_transitions"] == 16 * 150, got
    assert got["_engine_game_ends"] >= 32


def test_the_rules_reference_finds_a_move_applied_wrongly():
    from bench_torch import engine_check
    from keisei_tpu_torch.env.vec_env import EnvCore
    env = EnvCore(4, 60, 50, "cpu")
    tape = engine_check.Tape(4, 4, 2 ** 31 + 12, "cpu", 60)
    states, _, mask = env.init()
    g = torch.Generator().manual_seed(12)
    for t in range(20):
        a = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0).argmax(dim=1)
        states, eo = env.step(states, a)
        # what the tape is told was played: at ply 10, env 2's other legal move
        told = a.clone()
        if t == 10:
            told[2] = torch.nonzero(mask[2] & (torch.arange(mask.shape[1]) != a[2]))[0, 0]
        tape.record(told, eo)
        mask = eo.legal_mask
    assert engine_check.check(tape)["engine_off"] >= 1
