"""League mode through the port's trainer on the CPU: the learner against
the tiered pool for two epochs, with the maintenance that follows each
(results and Elo, learner snapshots into the pool, tier reviews, the
historical library and the gauntlet), read back through the JAX package.
"""

import copy
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from keisei_tpu import db as jax_db
from keisei_tpu.league.store import OpponentStore as JaxStore
from keisei_tpu_torch.training.config import config_from_dict, load_config
from keisei_tpu_torch.training.league_rollout import parity_colors
from keisei_tpu_torch.training.loop import SelfPlayTrainer, main

torch.set_num_threads(2)

RAW = {
    "model": {"architecture": "se_resnet",
              "params": {"num_blocks": 1, "channels": 16, "global_pool_channels": 8,
                         "se_reduction": 4}},
    "training": {"num_games": 8, "max_ply": 8, "steps_per_epoch": 8,
                 "checkpoint_interval": 100,
                 "algorithm_params": {"batch_size": 16, "epochs_per_batch": 1}},
    "league": {
        "opponents_per_epoch": 2, "snapshot_interval": 1, "epochs_per_seat": 100,
        "tournament_enabled": False,
        "storage": {"snapshot_dtype": "bfloat16"},
        "recent": {"slots": 3, "min_games_for_review": 0, "min_unique_opponents": 0},
        "dynamic": {"slots": 3, "min_games_before_eviction": 0},
        "history": {"refresh_interval_epochs": 2, "min_epoch_for_selection": 0},
        "gauntlet": {"interval_epochs": 2, "games_per_matchup": 2},
    },
}


def _config(tmp_path, **league):
    raw = copy.deepcopy(RAW)
    raw["training"]["checkpoint_dir"] = str(tmp_path / "ck")
    raw["league"]["storage"]["league_dir"] = str(tmp_path / "league")
    raw["league"].update(league)
    raw["display"] = {"db_path": str(tmp_path / "obs.db")}
    return config_from_dict(raw)


@pytest.mark.parametrize("async_maintenance", [True, False])
def test_two_league_epochs(tmp_path, async_maintenance):
    cfg = _config(tmp_path, async_maintenance=async_maintenance)
    seen = []
    trainer = SelfPlayTrainer(cfg, device="cpu", metrics_sink=seen.append)
    assert trainer.league_enabled and trainer.store.pool_size() == 1  # the bootstrap
    assert (trainer._maint_executor is not None) == async_maintenance
    torch.testing.assert_close(trainer.learner_color, parity_colors(8))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.observer.on_start(cfg, total_epochs=2)
    stats = []
    real = trainer._rollout

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        stats.append(out[3])
        return out

    trainer._rollout = spy
    for _ in range(2):
        trainer.run_epoch()
    trainer.drain_maintenance()

    assert [m["epoch"] for m in seen] == [1, 2]
    for m in seen:
        for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
            assert math.isfinite(m[k]), (k, m[k])
    assert all(s.parity_mismatch == 0 for s in stats)
    assert any(not torch.equal(before[k], v) for k, v in trainer.model.state_dict().items())

    db_path = trainer.store.db_path
    entries = JaxStore(db_path, str(tmp_path / "league")).list_entries()
    assert len(entries) == 3  # the bootstrap + a snapshot per epoch
    assert {e.created_epoch for e in entries} == {0, 1, 2}
    assert trainer.learner_entry_id == max(e.id for e in entries)
    assert jax_db.read_training_state(db_path)["learner_entry_id"] == trainer.learner_entry_id
    assert len(jax_db.read_elo_history(db_path)) >= 1 + 2  # carried forward per epoch
    data = jax_db.read_league_data(db_path)
    assert data["historical_library"] and data["gauntlet_results"]
    assert {r["epoch"] for r in data["gauntlet_results"]} == {2}
    # the reference's phases, "tournament" included (marked with the tournament off)
    assert set(trainer._maint_phase_s) == {"record_results", "snapshot", "elo_review",
                                           "historical_gauntlet", "tournament"}
    # snapshots are stored bf16 (storage.snapshot_dtype)
    snap = trainer.store.load_variables(trainer.store.get_entry(trainer.learner_entry_id))
    assert {v.dtype for v in snap.values()} == {torch.bfloat16}

    # a new trainer on the same league resumes the learner's entry
    again = SelfPlayTrainer(cfg, device="cpu")
    assert again.learner_entry_id == trainer.learner_entry_id


def test_cohort_swap_resets_swapped_blocks_only(tmp_path):
    cfg = _config(tmp_path, async_maintenance=False, snapshot_interval=2)
    trainer = SelfPlayTrainer(replace(cfg, training=replace(cfg.training, max_ply=12)),
                              device="cpu")
    trainer.run_epoch()  # 8 plies into games of 12: every env is mid-game
    states, obs, mask = trainer.env_carry
    ply_before = states.ply.clone()
    assert (ply_before > 0).any()
    trainer.learner_color = 1 - trainer.learner_color
    trainer._reset_swapped_blocks([1])  # slot 1 = envs [4, 8)
    states2, obs2, mask2 = trainer.env_carry
    assert (states2.ply[4:] == 0).all()
    assert torch.equal(states2.ply[:4], ply_before[:4])
    torch.testing.assert_close(trainer.learner_color[4:], parity_colors(8)[4:])
    _, fresh_obs, fresh_mask = trainer.env_core.init()
    assert torch.equal(obs2[4:], fresh_obs[4:]) and torch.equal(mask2[4:], fresh_mask[4:])

    # run_epoch resets exactly the blocks whose slot changed entries
    calls = []
    real = trainer._reset_swapped_blocks
    trainer._reset_swapped_blocks = lambda slots: (calls.append(slots), real(slots))
    trainer._cohort_slot_ids = (-1, trainer._cohort_slot_ids[1])
    sampled = trainer._sample_cohort()
    trainer._sample_cohort = lambda: sampled
    trainer.run_epoch()
    assert calls == [[0]]


def test_dynamic_fallback_trains(tmp_path):
    """Odd K (3 opponent blocks of 2 envs) takes the full-batch path."""
    cfg = _config(tmp_path, opponents_per_epoch=3, async_maintenance=False)
    cfg = replace(cfg, training=replace(cfg.training, num_games=6))
    trainer = SelfPlayTrainer(cfg, device="cpu")
    em = trainer.run_epoch()
    assert math.isfinite(em.policy_loss) and trainer.K == 3


def test_league_entry_point_on_the_cpu(tmp_path):
    path = tmp_path / "league.toml"
    path.write_text(f"""
[model]
architecture = "se_resnet"
[model.params]
num_blocks = 1
channels = 16
global_pool_channels = 8
se_reduction = 4
[training]
num_games = 4
max_ply = 8
steps_per_epoch = 4
checkpoint_dir = "{tmp_path / 'ck'}"
[training.algorithm_params]
batch_size = 8
epochs_per_batch = 1
[league]
opponents_per_epoch = 2
tournament_enabled = false
[league.storage]
league_dir = "{tmp_path / 'league'}"
""")
    assert load_config(str(path)).league.enabled
    main(["--config", str(path), "--epochs", "1", "--device", "cpu"])
    assert (tmp_path / "ck" / "epoch_000001" / "state.pt").exists()
    assert (tmp_path / "league" / "league.db").exists()
    assert np.isfinite([e.elo_rating for e in JaxStore(
        str(tmp_path / "league" / "league.db"), str(tmp_path / "league")).list_entries()]).all()
