"""Guards of the port: no JAX and nothing of the JAX package anywhere in
keisei_tpu_torch or chip_smoke.py (the league's and parallel/'s modules
included), no silent device fallback, and clear refusals for what is not
ported yet."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.utils.device import resolve_device

TINY_MODEL = {"architecture": "se_resnet",
              "params": {"num_blocks": 1, "channels": 16, "global_pool_channels": 8,
                         "se_reduction": 4}}


REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """A fresh interpreter imports every keisei_tpu_torch module; none of
    jax, flax, optax or orbax, and no module of the JAX package (top-level
    name exactly keisei_tpu), may be loaded afterwards."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import keisei_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(keisei_tpu_torch.__path__,
                                                        "keisei_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        banned = ("jax", "flax", "optax", "orbax", "keisei_tpu")
        bad = sorted(k for k in sys.modules if k.split(".")[0] in banned)
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 30 else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py", *sorted(
    str(p.relative_to(REPO)) for p in (REPO / "keisei_tpu_torch").rglob("*.py"))])
def test_sources_import_neither_jax_nor_the_jax_package(path):
    """An AST scan of every import statement, including those inside
    functions, which a fresh interpreter would not reach."""
    bad = _imported_roots(REPO / path) & {"jax", "flax", "optax", "orbax", "keisei_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SelfPlayTrainer(config_from_dict({"model": TINY_MODEL}), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("what", ["EnvCore", "EngineTables"])
def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch, what):
    """Built with no device argument the engine resolves to the card; on a
    machine without CUDA that raises instead of running on the CPU."""
    from keisei_tpu_torch.engine.core import EngineTables
    from keisei_tpu_torch.env.vec_env import EnvCore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnvCore(2, 16, 46) if what == "EnvCore" else EngineTables()
    built = EnvCore(2, 16, 46, device="cpu") if what == "EnvCore" else EngineTables("cpu")
    assert built.device == torch.device("cpu")


@pytest.mark.parametrize("what", ["VecEnv", "OpponentStore"])
def test_vec_env_and_league_store_default_to_the_card(monkeypatch, tmp_path, what):
    """The host shim and the league's store (where league weights and the
    gauntlet's games live) resolve to the card when built without a
    device, and raise on a machine without CUDA."""
    from keisei_tpu_torch.env.vec_env import VecEnv
    from keisei_tpu_torch.league.store import OpponentStore

    def build(**kw):
        if what == "VecEnv":
            return VecEnv(2, 16, **kw)
        return OpponentStore(str(tmp_path / "l.db"), str(tmp_path / "l"), **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    built = build(device="cpu")
    device = built._core.device if what == "VecEnv" else built.device
    assert device == torch.device("cpu")


def test_cuda_kernels_refuse_cpu_fallback_on_other_devices():
    from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc

    x = torch.zeros(9, 9, 2, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_hwbc(x, torch.zeros(3, 3, 8, 128, dtype=torch.bfloat16, device="meta"))


def test_int8_forward_builds_and_refuses_an_undividable_batch(tmp_path):
    """rollout_forward="int8" is ported: it resolves to the quantized
    forward, and a batch the quantization tile cannot divide is refused when
    the trainer is built, not in its first rollout."""
    from keisei_tpu_torch.models.fused_infer import QuantizedForward

    def trainer(games):
        return SelfPlayTrainer(config_from_dict({"model": TINY_MODEL, "training": {
            "num_games": games, "rollout_forward": "int8",
            "checkpoint_dir": str(tmp_path)}}), device="cpu")

    with pytest.raises(ValueError, match="divisible by 32"):
        trainer(2)
    assert isinstance(trainer(32)._rollout_forward_fn("int8"), QuantizedForward)


def test_league_mode_builds_and_refuses_what_is_not_ported(tmp_path):
    """League mode is ported, its tournament included: an enabled [league]
    builds a league trainer, and `tournament_enabled = true` builds its
    in-process tournament or, with `tournament_mode = "sidecar"`, its
    dispatcher. A league over several devices loads (the ranks are started
    by the entry point, tests/test_torch_parallel.py); the fused and int8
    rollout forwards in league mode still refuse (the reference refuses
    those too)."""
    from keisei_tpu_torch.league.tournament import LeagueTournament, TournamentDispatcher

    league = {"opponents_per_epoch": 2, "tournament_enabled": False,
              "storage": {"league_dir": str(tmp_path / "league")}}
    training = {"num_games": 4, "checkpoint_dir": str(tmp_path / "ck")}
    trainer = SelfPlayTrainer(config_from_dict({"model": TINY_MODEL, "training": training,
                                                "league": league}), device="cpu")
    assert trainer.league_enabled and trainer.store.pool_size() == 1
    assert trainer.tournament is None and trainer.dispatcher is None
    for mode, cls in (("in_process", LeagueTournament), ("sidecar", TournamentDispatcher)):
        on = {**league, "tournament_enabled": True, "tournament_mode": mode,
              "storage": {"league_dir": str(tmp_path / mode)}}
        built = SelfPlayTrainer(config_from_dict({"model": TINY_MODEL, "training": training,
                                                  "league": on}), device="cpu")
        assert isinstance(built.tournament if mode == "in_process" else built.dispatcher, cls)
    # a tournament_device the machine lacks fails when the trainer is built
    with pytest.raises(ValueError, match="device spec '1'"):
        SelfPlayTrainer(config_from_dict({"model": TINY_MODEL, "training": training, "league": {
            **league, "tournament_enabled": True, "tournament_device": "1"}}), device="cpu")
    several = config_from_dict({"model": TINY_MODEL, "league": league,
                                "distributed": {"num_devices": 2}})
    assert several.league.enabled and several.distributed.num_devices == 2
    with pytest.raises(ValueError, match="not supported in league mode"):
        SelfPlayTrainer(config_from_dict({
            "model": TINY_MODEL, "league": league,
            "training": {**training, "rollout_forward": "fused"}}), device="cpu")
    disabled = config_from_dict({"model": TINY_MODEL, "league": {"enabled": False}})
    assert not disabled.league.enabled


@pytest.mark.parametrize("spec", [None, "default", "cuda", "0", 0, "cuda:0"])
def test_parse_device_defaults_to_the_card(monkeypatch, spec):
    """A device spec with no platform, or the card's, resolves to card 0,
    and without CUDA raises at once; "cpu" and a caller's own default stay
    on the CPU; a bad platform or an index past the cards raise."""
    from keisei_tpu_torch.utils.device import parse_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parse_device(spec) == torch.device("cuda", 0)
    for bad in ("1", "cuda:1", "tpu:0", "cuda:x"):
        with pytest.raises(ValueError):
            parse_device(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA is not available"):
        parse_device(spec)
    assert parse_device("cpu") == torch.device("cpu")
    if spec in (None, "default"):
        assert parse_device(spec, default="cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["worker_main", "TournamentWorker", "LeagueTournament",
                                   "evaluate_main"])
def test_tournament_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """The sidecar worker (its `--device` defaults to `cuda`, where the JAX
    worker's defaults to its CPU), a tournament on a store of the card, and
    the evaluation CLI resolve to the card unless told otherwise, and raise
    on a machine without CUDA instead of running on the CPU."""
    from keisei_tpu_torch.league import evaluate, worker
    from keisei_tpu_torch.league.config import LeagueConfig
    from keisei_tpu_torch.league.store import OpponentStore
    from keisei_tpu_torch.league.tournament import LeagueTournament

    db, ldir = str(tmp_path / "l.db"), str(tmp_path / "l")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "worker_main":
        with pytest.raises(ValueError, match="CUDA is not available"):
            worker.main(["--db", db, "--league-dir", ldir])
    elif entry == "TournamentWorker":
        with pytest.raises(ValueError, match="CUDA is not available"):
            worker.TournamentWorker(db, ldir)
        assert worker.TournamentWorker(db, ldir, device="cpu").device == torch.device("cpu")
    elif entry == "LeagueTournament":
        store = OpponentStore(db, ldir, device="cpu")
        assert LeagueTournament(store, LeagueConfig()).device == torch.device("cpu")
        with pytest.raises(ValueError, match="CUDA is not available"):
            LeagueTournament(store, LeagueConfig(), device="cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate.main(["--a", str(tmp_path), "--b", str(tmp_path)])


@pytest.mark.parametrize("entry", ["SpectatorEnv", "ShowcaseRunner", "showcase_main"])
def test_dashboard_feed_defaults_to_the_card(monkeypatch, tmp_path, entry):
    """The spectator env, the showcase runner and its entry point (whose
    `--device` defaults to `cuda`, where the JAX sidecar pins itself to
    its CPU) resolve to the card unless told otherwise, and raise on a
    machine without CUDA instead of running on the CPU."""
    from keisei_tpu_torch.env.spectator import SpectatorEnv
    from keisei_tpu_torch.showcase import runner

    db, ldir = str(tmp_path / "l.db"), str(tmp_path / "l")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "SpectatorEnv":
            SpectatorEnv()
        elif entry == "ShowcaseRunner":
            runner.ShowcaseRunner(db, ldir)
        else:
            runner.main(["--db", db, "--league-dir", ldir])
    if entry == "SpectatorEnv":
        assert SpectatorEnv(device="cpu").device == torch.device("cpu")
    elif entry == "ShowcaseRunner":
        assert runner.ShowcaseRunner(db, ldir, device="cpu").device == torch.device("cpu")
    else:
        ran = []
        monkeypatch.setattr(runner.ShowcaseRunner, "run", lambda self: ran.append(self.device))
        monkeypatch.setattr(runner.signal, "signal", lambda *a: None)  # keep pytest's handlers
        runner.main(["--db", db, "--league-dir", ldir, "--device", "cpu", "--no-auto"])
        assert ran == [torch.device("cpu")]


def test_multi_device_not_yet_ported(tmp_path):
    """Multi-device training is ported (parallel/): num_devices = 4 asks
    for four ranks, one per card, which the entry point starts; a trainer
    built without its rank's mesh refuses instead of training alone."""
    cfg = config_from_dict({"model": TINY_MODEL, "distributed": {"num_devices": 4},
                            "training": {"checkpoint_dir": str(tmp_path)}})
    with pytest.raises(ValueError, match="would train alone"):
        SelfPlayTrainer(cfg, device="cpu")


@pytest.mark.parametrize("name", ["katago-b40c256", "katago-b10c128"])
def test_loader_reads_the_repo_configs(name):
    """The port's loader reads the same TOML files into the same values as
    the JAX package's loader."""
    from keisei_tpu.training.config import load_config as jax_load_config
    from keisei_tpu_torch.training.config import load_config

    path = str(Path(__file__).resolve().parents[1] / "configs" / f"{name}.toml")
    ours, theirs = load_config(path), jax_load_config(path)
    for section in ("model", "training", "algorithm_params", "display", "run", "distributed"):
        assert vars(getattr(ours, section)) == vars(getattr(theirs, section)), section


def test_loader_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown key"):
        config_from_dict({"training": {"bogus": 1}})
    with pytest.raises(ValueError, match="rollout_forward"):
        config_from_dict({"training": {"rollout_forward": "tpu"}})
