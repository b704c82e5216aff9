"""The port's own copies of the JAX package's framework-free modules against
the originals: engine tables, types, Zobrist keys and SFEN, the spectator
data, and the observability database.

The port keeps copies so that it never imports keisei_tpu; these tests keep
the copies equal to what they copy: every constant array bit for bit, the
functions on the same inputs, the DDL and SCHEMA_VERSION byte for byte,
and a database the port's trainer wrote read back through keisei_tpu.db,
as the dashboard reads it.
"""

import types

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
