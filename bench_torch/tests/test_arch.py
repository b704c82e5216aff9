"""The architecture modules (bench_torch/arch/): every configuration of the
benchmark finds its plain reference by `model.architecture`, a cell of
another architecture comes in as files alone, and the reference's PPO step
taken in row blocks equals the step over the whole minibatch.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_torch import flops, reference as R, rollout_cell, spec, train_cell
from bench_torch.arch import load
from bench_torch.tests.test_se_resnet_golden import HP, TINY, transitions

REPO = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]

# A row-independent toy: one hidden layer over the board, three heads.
TOY_MLP = '''
"""A toy architecture: one hidden ReLU layer and three linear heads."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bench_torch.reference import SPATIAL_MOVE_TYPES

TRAIN_ROWS_PER_BLOCK = 5
ROLLOUT_CONTROL = None
HEADS = {"policy": 81 * SPATIAL_MOVE_TYPES, "value": 3, "score": 1}


@dataclass(frozen=True)
class Widths:
    hidden: int
    obs_channels: int

    @classmethod
    def from_params(cls, params):
        return cls(int(params["hidden"]), int(params["obs_channels"]))


def shapes(w):
    out = {"fc.weight": (w.hidden, w.obs_channels * 81), "fc.bias": (w.hidden,)}
    for name, n in HEADS.items():
        out[f"{name}.weight"], out[f"{name}.bias"] = (n, w.hidden), (n,)
    return out


def init_state(w, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    state = {}
    for name, shape in shapes(w).items():
        fan_in = w.obs_channels * 81 if name.startswith("fc.") else w.hidden
        u = torch.rand(math.prod(shape), generator=g, device=device) * 2 - 1
        state[name] = (u / math.sqrt(fan_in)).reshape(shape)
    return state


def parameter_names(w):
    return list(shapes(w))


class Net:
    def __init__(self, w, quant=None):
        self.w, self.q = w, quant or (lambda t: t)

    def forward(self, P, obs, train):
        h = F.relu(F.linear(self.q(obs.float()), self.q(P["fc.weight"]), P["fc.bias"]))
        pol, value, score = (F.linear(h, P[f"{n}.weight"], P[f"{n}.bias"]) for n in HEADS)
        return pol.reshape(-1, 9, 9, SPATIAL_MOVE_TYPES), value, score

    def eval_rows(self, P, obs, rows=512):
        with torch.no_grad():
            outs = [self.forward(P, obs[i:i + rows], False) for i in range(0, len(obs), rows)]
        return tuple(torch.cat(parts) for parts in zip(*outs))


def forward_flops(w):
    return 2.0 * w.hidden * (w.obs_channels * 81 + sum(HEADS.values()))
'''
TOY = dict(hidden=8, obs_channels=2)


def toy_root(tmp_path: Path) -> Path:
    root = tmp_path / "bench"
    (root / "arch").mkdir(parents=True)
    (root / "arch" / "toy_mlp.py").write_text(TOY_MLP)
    return root


@pytest.mark.parametrize("config", CONFIGS)
def test_every_configuration_resolves_to_its_architecture_module(config):
    cell = spec.resolve(next(w["name"] for w in BENCH["workloads"] if w["config"] == config))
    name = cell.config["model"]["architecture"]
    mod = cell.arch()
    assert Path(mod.__file__) == cell.root / "arch" / f"{name}.py"
    w = mod.Widths.from_params(cell.config["model"]["params"])
    assert dataclasses.is_dataclass(w) and w.obs_channels > 0
    assert mod.forward_flops(w) > 0 and hasattr(mod, "TRAIN_ROWS_PER_BLOCK")
    assert hasattr(mod, "ROLLOUT_CONTROL")
    assert callable(mod.init_state) and callable(mod.parameter_names) and callable(mod.Net)
    assert cell.arch() is mod  # each file runs once


def test_an_unknown_architecture_names_the_file_it_looked_for():
    cell = spec.resolve(BENCH["workloads"][0]["name"])
    cell.config["model"]["architecture"] = "no_such_net"
    with pytest.raises(ModuleNotFoundError, match=r"arch/no_such_net\.py"):
        cell.arch()


def test_the_se_resnets_names_stay_where_they_were():
    se = load(spec.ROOT, "se_resnet")
    for name in ("BN_EPS", "Widths", "weight_shapes", "batchnorm_names", "init_state",
                 "parameter_names", "Net"):
        assert getattr(R, name) is getattr(se, name)
    for name in ("Widths", "block_fc_macs", "trunk_conv_flops", "forward_flops",
                 "trunk_bound_s"):
        assert getattr(flops, name) is getattr(se, name)
    assert se.TRAIN_ROWS_PER_BLOCK is None and se.ROLLOUT_CONTROL == "int8"


def test_a_cell_of_another_architecture_added_as_files_alone_is_found(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(REPO / "bench_torch", repo / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = repo / "bench_torch"
    (root / "arch" / "toy_mlp.py").write_text(TOY_MLP)
    (root / "configs" / "toy.toml").write_text(
        '[model]\narchitecture = "toy_mlp"\n\n[model.params]\nhidden = 8\nobs_channels = 2\n\n'
        '[training]\nnum_games = 8\n\n[bench]\nsource = "test"\nreduced = []\nassumed = []\n')
    (root / "limits" / "toy.train.json").write_text(
        (root / "limits" / "b40c256.train.json").read_text())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test", "reduced": [], "why": "test",
                             "file": "bench_torch/configs/toy.toml"})
    bench["workloads"].append({"name": "toy.train", "config": "toy", "traffic": "train-t16",
                               "chips": 1, "why": "test"})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve("toy.train", repo)
    toy = cell.arch()
    assert Path(toy.__file__) == root / "arch" / "toy_mlp.py"
    w = toy.Widths.from_params(cell.config["model"]["params"])
    state = toy.init_state(w, 2 ** 31 + 21, "cpu")
    net, names = toy.Net(w), toy.parameter_names(w)
    tr = transitions(3, 8, w.obs_channels, 22, legal=0.001)
    rows = R.training_rows(tr, R.rollout_outputs(net, state, tr), HP)
    assert rows["obs"].shape == (24, 2 * 81) and torch.isfinite(rows["advantages"]).all()
    perm = torch.randperm(24, generator=torch.Generator().manual_seed(23))
    steps = R.follow_steps(net, state, rows, [perm[:12], perm[12:], perm[:12]], HP, 0.01,
                           names, block_rows=toy.TRAIN_ROWS_PER_BLOCK)
    assert len(steps.losses) == 3 and all(torch.isfinite(t).all() for t in steps.losses)
    assert [t.shape for t in steps.first_outputs] == [(12, 9, 9, 139), (12, 3), (12, 1)]
    assert all(not torch.equal(steps.params[n], state[n]) for n in names)
    # the window's model FLOPs come from the toy's per-board count
    hp = {"epochs_per_batch": 4, "batch_size": 16}
    epochs = [SimpleNamespace(truncated=3), SimpleNamespace(truncated=0)]
    boards, trained = 2 * 8 * (16 + 1) + 3, 2 * 4 * (8 * 16 // 16) * 16
    assert train_cell.window_flops(toy, w, hp, 8, 16, epochs) \
        == toy.forward_flops(w) * (boards + 3 * trained)


def test_the_reference_step_in_row_blocks_equals_one_block(tmp_path):
    toy = load(toy_root(tmp_path), "toy_mlp")
    w = toy.Widths.from_params(TOY)
    state = toy.init_state(w, 2 ** 31 + 31, "cpu")
    net, names = toy.Net(w), toy.parameter_names(w)
    tr = transitions(3, 12, w.obs_channels, 32, legal=0.001)
    rows = R.training_rows(tr, R.rollout_outputs(net, state, tr), HP)
    perm = torch.randperm(36, generator=torch.Generator().manual_seed(33))
    mbs = [perm[:12], perm[12:24], perm[24:]]
    assert all(((rows["value_cats"][ix] < 0).any() and (rows["value_cats"][ix] >= 0).any())
               for ix in mbs)  # labelled and unlabelled rows in every minibatch
    whole = R.follow_steps(net, state, rows, mbs, HP, 0.01, names)
    blocked = R.follow_steps(net, state, rows, mbs, HP, 0.01, names, block_rows=5)
    for a, b in zip(blocked.losses, whole.losses, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    for n in names:
        torch.testing.assert_close(blocked.first_grads[n], whole.first_grads[n],
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(blocked.params[n], whole.params[n], rtol=1e-5, atol=1e-7)
        assert not torch.equal(whole.params[n], state[n])
    for a, b in zip(blocked.first_outputs, whole.first_outputs, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_an_architecture_without_row_blocks_takes_the_whole_minibatch():
    se = load(spec.ROOT, "se_resnet")
    w = se.Widths.from_params(TINY)
    state = se.init_state(w, 2 ** 31 + 41, "cpu")
    net, names = se.Net(w), se.parameter_names(w)
    tr = transitions(3, 4, w.obs_channels, 42)
    rows = R.training_rows(tr, R.rollout_outputs(net, state, tr), HP)
    mbs = [torch.arange(12)] * 3
    whole = R.follow_steps(net, state, rows, mbs, HP, 0.01, names)
    same = R.follow_steps(net, state, rows, mbs, HP, 0.01, names,
                          block_rows=se.TRAIN_ROWS_PER_BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(same.losses, whole.losses, strict=True))
    assert all(torch.equal(same.params[n], whole.params[n]) for n in names)
    # BatchNorm's batch statistics mix rows: blocks of 5 would be another step
    split = R.follow_steps(net, state, rows, mbs, HP, 0.01, names, block_rows=5)
    assert not torch.allclose(split.losses[0], whole.losses[0], rtol=1e-3)


def test_a_rollout_control_without_a_program_path_is_the_reference_in_float8(tmp_path):
    """An architecture whose `ROLLOUT_CONTROL` is None: the rollout cell's
    control puts the reference in float8 in the program's place."""
    toy = load(toy_root(tmp_path), "toy_mlp")
    w = toy.Widths.from_params(TOY)
    state = toy.init_state(w, 2 ** 31 + 51, "cpu")
    tr = transitions(4, 16, w.obs_channels, 52, legal=0.05)
    kept = {"obs": tr.obs.reshape(64, -1), "masks": tr.masks.reshape(64, -1),
            "actions": tr.actions.reshape(64)}
    s = SimpleNamespace(arch=toy, widths=w, state=state, blend=0.5, N=16)
    kept["log_probs"], kept["values"] = rollout_cell.reference_answers(s, kept)
    sound = rollout_cell.readings(s, kept)
    control = rollout_cell.readings(s, kept, control=True)
    assert sound["_logp_gap"] == 0 and sound["_value_gap"] == 0
    assert control["_logp_gap"] > 0 and control["_answers"] == 64
    fp8 = rollout_cell.reference_answers(s, kept, quant=R.fp8_e4m3)
    assert control["_logp_gap"] == float((fp8[0] - kept["log_probs"]).abs().max())
