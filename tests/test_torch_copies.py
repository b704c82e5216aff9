"""The port's own copies of the JAX package's framework-free modules against
the originals: engine tables, types, Zobrist keys and SFEN, the spectator
data, the observability database, and the league's modules (copied whole,
or ported with the functions they keep unchanged).

The port keeps copies so that it never imports keisei_tpu; these tests keep
the copies equal to what they copy: every constant array bit for bit, the
functions on the same inputs, the DDL and SCHEMA_VERSION byte for byte,
and a database the port's trainer wrote read back through keisei_tpu.db,
as the dashboard reads it.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from keisei_tpu import db as jax_db
from keisei_tpu.engine import sfen as jax_sfen
from keisei_tpu.engine import tables as jax_tables
from keisei_tpu.engine import types as jax_types
from keisei_tpu.engine import zobrist as jax_zobrist
from keisei_tpu.env import spectator_data as jax_spectator
from keisei_tpu_torch.db import schema
from keisei_tpu_torch.engine import sfen, tables, zobrist
from keisei_tpu_torch.engine import types as port_types
from keisei_tpu_torch.env import spectator_data
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer

torch.set_num_threads(2)


def _constants(mod) -> dict:
    """Module-level data of a module: arrays, numbers, strings, containers."""
    keep = (np.ndarray, np.generic, int, float, str, bool, tuple, list, dict)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and isinstance(v, keep)
            and not isinstance(v, (types.ModuleType, type))}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("port,orig", [(tables, jax_tables), (port_types, jax_types),
                                       (zobrist, jax_zobrist), (sfen, jax_sfen),
                                       (spectator_data, jax_spectator)],
                         ids=["tables", "types", "zobrist", "sfen", "spectator_data"])
def test_copied_constants_equal_the_originals(port, orig):
    ours, theirs = _constants(port), _constants(orig)
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert _equal(ours[name], theirs[name]), name


def test_zobrist_and_sfen_functions_agree():
    board, hands, stm = jax_sfen.parse_sfen(jax_sfen.STARTPOS_SFEN)
    ours = sfen.parse_sfen(sfen.STARTPOS_SFEN)
    for a, b in zip(ours, (board, hands, stm)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for _ in range(5):
        hands = rng.integers(0, 3, size=(2, 7)).astype(np.int8)
        s = int(rng.integers(0, 2))
        np.testing.assert_array_equal(zobrist.compute_hash(board, hands, s),
                                      jax_zobrist.compute_hash(board, hands, s))
        assert sfen.to_sfen(board, hands, s) == jax_sfen.to_sfen(board, hands, s)


def test_spectator_functions_agree():
    board, hands, _ = sfen.parse_sfen(sfen.STARTPOS_SFEN)
    for stm in (0, 1):
        kw = dict(reason=0, winner=-1, in_check=bool(stm))
        assert (spectator_data.build_spectator_dict(board, hands, stm, 3, **kw)
                == jax_spectator.build_spectator_dict(board, hands, stm, 3, **kw))
    for action in range(0, port_types.ACTION_SPACE, 97):
        for stm in (0, 1):
            assert spectator_data.move_usi(action, stm) == jax_spectator.move_usi(action, stm)


def test_db_schema_is_byte_identical():
    from keisei_tpu.db import schema as jax_schema

    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION
    assert schema.DDL == jax_schema.DDL


def test_a_database_the_port_wrote_reads_back_through_the_jax_package(tmp_path):
    db_path = str(tmp_path / "port.db")
    cfg = config_from_dict({
        "model": {"architecture": "se_resnet",
                  "params": {"num_blocks": 1, "channels": 16, "global_pool_channels": 8,
                             "se_reduction": 4}},
        "training": {"num_games": 4, "max_ply": 12, "steps_per_epoch": 4,
                     "checkpoint_dir": str(tmp_path / "ck"),
                     "algorithm_params": {"batch_size": 8, "epochs_per_batch": 1}},
        "display": {"db_path": db_path}})
    trainer = SelfPlayTrainer(cfg, device="cpu")
    trainer.run(2)

    jax_db.init_db(db_path)  # the dashboard's attach: the version matches, no DDL runs
    state = jax_db.read_training_state(db_path)
    assert state["status"] == "stopped" and state["current_epoch"] == 2
    assert state["model_arch"] == "se_resnet"
    metrics = jax_db.read_metrics_tail(db_path)
    assert [m["epoch"] for m in metrics] == [1, 2]
    assert all(np.isfinite(m["policy_loss"]) for m in metrics)
    snaps = jax_db.read_game_snapshots(db_path)
    assert len(snaps) == 4 and all(s["sfen"] for s in snaps)


# -- the league's copies ----------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("path", ["league/tiers.py", "league/scheduler.py",
                                  "league/historical.py", "db/league_tables.py",
                                  "league/features.py", "league/style.py", "db/queue.py",
                                  "db/analytics.py"])
def test_league_copies_are_byte_identical(path):
    """Framework-free modules copied whole: their relative imports resolve to
    the port's own store, match and db, so not even an import line differs."""
    ours = (REPO / "keisei_tpu_torch" / path).read_bytes()
    assert ours == (REPO / "keisei_tpu" / path).read_bytes()


def _same_source(port_mod, orig_mod, names):
    import inspect

    for name in names:
        obj = orig_mod
        ours = port_mod
        for part in name.split("."):
            obj, ours = getattr(obj, part), getattr(ours, part)
        assert inspect.getsource(ours) == inspect.getsource(obj), name


def test_league_config_parses_as_the_original():
    """league/config.py is the original but for comments that speak of
    the JAX package's platform: the same dataclasses, defaults and
    validation (their source), and the same values from the repo's league
    config and from a section that sets every sub-section."""
    import dataclasses
    import tomllib

    from keisei_tpu.league import config as orig
    from keisei_tpu_torch.league import config as port

    classes = [n for n, v in vars(orig).items() if dataclasses.is_dataclass(v)]
    assert classes == [n for n, v in vars(port).items() if dataclasses.is_dataclass(v)]
    for name in classes:
        ours, theirs = getattr(port, name), getattr(orig, name)
        assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
            [(f.name, f.type) for f in dataclasses.fields(theirs)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs()), name
    assert {k: v.__name__ for k, v in port._SUB_SECTIONS.items()} == \
        {k: v.__name__ for k, v in orig._SUB_SECTIONS.items()}
    _same_source(port, orig, ["league_config_from_dict",
                              *(f"{n}.__post_init__" for n in classes)])
    with open(REPO / "configs" / "katago-league.toml", "rb") as f:
        section = tomllib.load(f)["league"]
    full = {**section, "history": {"slots": 3}, "gauntlet": {"interval_epochs": 7},
            "elo": {"historical_k": 9.0}, "priority": {"repeat_penalty": -0.2},
            "scheduler": {"challenge_window": 50}}
    for raw in (section, full):
        assert dataclasses.asdict(port.league_config_from_dict(raw)) == \
            dataclasses.asdict(orig.league_config_from_dict(raw))
    for bad in ({"mode": "solo"}, {"recent": {"bogus": 1}}, {"dynamic": {"lr_scale": 2.0}}):
        with pytest.raises(ValueError) as ours:
            port.league_config_from_dict(bad)
        with pytest.raises(ValueError) as theirs:
            orig.league_config_from_dict(bad)
        assert str(ours.value) == str(theirs.value)


_STORE_SAME = [
    "Role", "EntryStatus", "display_name_for", "flavour_facts_for", "compute_elo_update",
    "OpponentEntry", *(f"OpponentStore.{m}" for m in (
        "reconcile_update_counts", "_weights_version", "_entry_dir", "clone_entry",
        "get_entry", "list_entries", "list_by_role", "count_unique_opponents", "elo_spread",
        "update_role", "retire_entry", "set_protection", "set_training_enabled",
        "bump_update_count", "wait_for_flushes", "record_result",
        "carry_forward_elo", "pool_size"))]


@pytest.mark.parametrize("which", ["store", "league_ops", "dynamic_trainer", "db"])
def test_league_trimmed_copies_keep_the_originals_source(which):
    """Where a module is ported (weight I/O in torch) or trimmed, every
    function it keeps from the original is the original's source."""
    import importlib

    port = lambda m: importlib.import_module(f"keisei_tpu_torch.{m}")  # noqa: E731
    orig = lambda m: importlib.import_module(f"keisei_tpu.{m}")  # noqa: E731
    if which == "store":
        _same_source(port("league.store"), orig("league.store"), _STORE_SAME)
    elif which == "league_ops":
        _same_source(port("league.league_ops"), orig("league.league_ops"),
                     ["record_epoch_results"])
    elif which == "dynamic_trainer":
        _same_source(port("league.dynamic_trainer"), orig("league.dynamic_trainer"), [
            "_plan_chunks", *(f"DynamicTrainer.{m}" for m in (
                "disabled_entries", "retain_only", "_rate_limited", "_globally_disabled",
                "begin_round", "should_update", "maybe_update"))])
    else:
        _same_source(port("db.core"), orig("db.core"),
                     ["connect", "fetch_all", "fetch_one", "execute", "write_row", "insert"])
        _same_source(port("db.telemetry"), orig("db.telemetry"),
                     ["read_training_state", "update_training_progress"])


def test_flat_action_tables_equal_the_originals():
    from keisei_tpu.env import vec_env as jax_vec_env
    from keisei_tpu_torch.env import vec_env

    for name in ("SPATIAL_TO_FLAT", "FLAT_TO_SPATIAL"):
        assert _equal(getattr(vec_env, name), getattr(jax_vec_env, name)), name


def test_dynamic_update_path_raises_until_the_tournament_is_ported(tmp_path):
    """The tournament is ported, and with it the Dynamic update path: none
    of record_rollout, _build_batch, maybe_update, _update_inner or
    _make_update_fn raises NotImplementedError any more; the gates and the
    cache sweep behave as before."""
    from keisei_tpu_torch.league.config import DynamicConfig
    from keisei_tpu_torch.league.dynamic_trainer import DynamicTrainer, _make_update_fn
    from keisei_tpu_torch.league.store import OpponentStore

    store = OpponentStore(str(tmp_path / "l.db"), str(tmp_path / "l"), device="cpu")
    trainer = DynamicTrainer(store, None, DynamicConfig())
    assert trainer._build_batch(1) is None
    model = _tiny_model()
    assert callable(_make_update_fn(model, DynamicConfig(), 1e-4))
    with pytest.raises(NotImplementedError, match="scalar-contract"):
        _make_update_fn(model, DynamicConfig(), 1e-4, contract="scalar")
    trainer._match_counts[7] = 4
    assert trainer.should_update(7) and not trainer.should_update(8)
    trainer.retain_only({8})
    assert not trainer.should_update(7)


def _tiny_model():
    from keisei_tpu_torch.models.registry import build_model

    return build_model("se_resnet", {"num_blocks": 1, "channels": 16,
                                     "global_pool_channels": 8, "se_reduction": 4})[0]
