"""The league tournament against the JAX package's: a round on stores
seeded with the same entries writes the same rows (results, Elo,
head-to-head, tournament stats, game features), read back through
`keisei_tpu.db`; the dispatcher enqueues the same queue rows; a sidecar
worker claims, plays, records and marks pairings done; `evaluate` runs on
the port's checkpoints; and a league trainer with the tournament on (in
process, and sidecar) runs epochs with rounds and drains.

JAX's draws are replayed: the JAX pool's chunks record the actions of
every env, and the port's tournament hands them to its pool through its
`sampler` hook, one pool call after another.
"""

import copy
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu import db as jax_db
from keisei_tpu.league import concurrent as JCP
from keisei_tpu.league import tournament as JT
from keisei_tpu.league.config import league_config_from_dict as jax_league_config
from keisei_tpu.league.dynamic_trainer import DynamicTrainer as JaxDynamicTrainer
from keisei_tpu.league.store import OpponentStore as JaxStore
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch.db import queue as dbq
from keisei_tpu_torch.league import evaluate, worker
from keisei_tpu_torch.league.concurrent import ConcurrentMatchPool
from keisei_tpu_torch.league.config import league_config_from_dict
from keisei_tpu_torch.league.dynamic_trainer import DynamicTrainer
from keisei_tpu_torch.league.store import OpponentStore, Role
from keisei_tpu_torch.league.tournament import LeagueTournament, TournamentDispatcher
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.training.checkpoint import save_checkpoint
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.training.ppo import KataGoPPOParams, make_optimizer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}
P, E, MAX_PLY, CHUNK = 4, 2, 24, 16
ROLES = [Role.DYNAMIC, Role.DYNAMIC, Role.RECENT_FIXED, Role.FRONTIER_STATIC]
LEAGUE = {"tournament_enabled": True, "tournament_num_envs": 2,
          "concurrency": {"parallel_matches": P, "envs_per_match": E},
          "dynamic": {"update_every_matches": 100}}


def _seed_stores(tmp_path):
    """A JAX store and a port store holding the same four bf16 entries."""
    jmodel, _ = jax_build_model("se_resnet", TINY)
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 50, 9, 9)), train=False))
    jstore = JaxStore(str(tmp_path / "jax.db"), str(tmp_path / "jl"))
    store = OpponentStore(str(tmp_path / "port.db"), str(tmp_path / "pl"), device="cpu")
    for i, role in enumerate(ROLES):
        v = jax.device_get(init(jax.random.key(i)))
        jstore.add_entry(jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), v),
                         architecture="se_resnet", model_params=TINY, created_epoch=i,
                         role=role)
        sd = flax_to_torch(v["params"], v["batch_stats"])
        store.add_entry({k: t.to(torch.bfloat16) for k, t in sd.items()},
                        architecture="se_resnet", model_params=TINY, created_epoch=i,
                        role=role)
    return jmodel, jstore, store


def _rows(db_path, table, order="id"):
    """A table's rows without wall-clock stamps, durations and weight paths."""
    rows = jax_db.connect(db_path).execute(f"SELECT * FROM {table} ORDER BY {order}")
    drop = ("checkpoint_path", "round_duration_s", "games_per_min")
    return [{k: r[k] for k in r.keys() if not k.endswith("_at") and k not in drop}
            for r in rows.fetchall()]


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """One tournament round on each side: the JAX one first, its draws
    recorded per pool call, then the port's replaying them."""
    tmp_path = tmp_path_factory.mktemp("round")
    jmodel, jstore, store = _seed_stores(tmp_path)
    jcfg, cfg = jax_league_config(LEAGUE), league_config_from_dict(LEAGUE)

    calls: list[list] = []
    orig_build, orig_run = JCP.ConcurrentMatchPool._build_chunk, JCP.ConcurrentMatchPool.run_round

    def build(self, mode="none"):
        fn = orig_build(self, mode)

        def chunk(*args):
            carry, ys = fn(*args)
            calls[-1].append(np.asarray(ys[1 if mode == "full" else 0]))
            return carry, ys

        return chunk

    def run_round(self, *args, **kwargs):
        calls.append([])
        return orig_run(self, *args, **kwargs)

    jt = JT.LeagueTournament(jstore, jcfg, dynamic_trainer=JaxDynamicTrainer(
        jstore, jmodel, jcfg.dynamic), min_epoch=0)
    key = jt._model_for(jstore.list_entries()[0])[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCP.ConcurrentMatchPool, "_build_chunk", build)
        mp.setattr(JCP.ConcurrentMatchPool, "run_round", run_round)
        jt._runners[("__pool__", key)] = JCP.ConcurrentMatchPool(
            jmodel, parallel_matches=P, envs_per_match=E, max_ply=MAX_PLY, chunk_steps=CHUNK)
        jstats = jt.run_round(epoch=3)
    draws = [np.concatenate(c) for c in calls]

    tt = LeagueTournament(store, cfg, dynamic_trainer=DynamicTrainer(
        store, None, cfg.dynamic), min_epoch=0)
    tt.max_ply, tt.chunk_steps = MAX_PLY, CHUNK
    replay = iter(draws)
    current = {}

    def sampler(step, masks):
        if step == 0:
            current["actions"] = next(replay)
        return torch.from_numpy(current["actions"][step].astype(np.int64))

    tt.sampler = sampler
    before = ConcurrentMatchPool.rounds_run
    stats = tt.run_round(epoch=3)
    assert next(replay, None) is None, "the port made fewer pool calls than the reference"
    return {"jax": (jt, jstats), "port": (tt, stats), "pool_calls": (
        ConcurrentMatchPool.rounds_run - before, len(draws))}


def test_round_stats_match_jax(rounds):
    (jt, jstats), (tt, stats) = rounds["jax"], rounds["port"]
    assert rounds["pool_calls"][0] == rounds["pool_calls"][1] == 2  # 6 pairings, P=4
    for k in ("pairings_requested", "pairings_completed", "total_games", "total_plies",
              "active_slots", "elo_ceiling_margin", "elo_ceiling_streak"):
        assert stats[k] == jstats[k], k
    assert stats["pairings_completed"] == stats["pairings_requested"] == 6
    assert set(stats["phase_s"]) == set(jstats["phase_s"])
    assert {"schedule", "load_weights", "play", "record", "features", "dyn_fetch"} <= set(
        stats["phase_s"])
    assert tt.rounds_played == jt.rounds_played == 1


@pytest.mark.parametrize("table", ["league_entries", "league_results", "elo_history",
                                   "head_to_head", "tournament_stats", "game_features"])
def test_round_rows_match_jax(rounds, table):
    """Each table the round writes, row for row, read through keisei_tpu.db's
    connection; the entries' Elo columns included."""
    jt, tt = rounds["jax"][0], rounds["port"][0]
    order = "entry_a_id, entry_b_id" if table == "head_to_head" else "id"
    ours = _rows(tt.store.db_path, table, order)
    assert ours == _rows(jt.store.db_path, table, order)
    assert ours, table
    if table == "game_features":  # two rows (one a side) per finished game
        assert len(jax_db.read_all_game_features(tt.store.db_path)) == 2 * 6 * E


def test_round_fed_the_dynamic_trainer(rounds):
    """The training pairings' rollouts were buffered for the Dynamic entries
    on both sides (the update itself is gated off here; it is held in
    tests/test_torch_dynamic_trainer.py)."""
    jt, tt = rounds["jax"][0], rounds["port"][0]
    jd, td = jt.dynamic_trainer, tt.dynamic_trainer
    assert td._match_counts == jd._match_counts and td._match_counts
    assert {k: len(v) for k, v in td._buffers.items()} == \
        {k: len(v) for k, v in jd._buffers.items()}
    for eid, buf in td._buffers.items():
        for got, want in zip(buf, jd._buffers[eid]):
            for k in want:
                np.testing.assert_array_equal(got[k].reshape(want[k].shape), want[k])


def test_dispatcher_enqueues_the_rows_jax_enqueues(tmp_path):
    _, jstore, store = _seed_stores(tmp_path)
    jd = JT.TournamentDispatcher(jstore, jax_league_config(LEAGUE))
    td = TournamentDispatcher(store, league_config_from_dict(LEAGUE))
    for epoch in (4, 5):
        assert td.enqueue_round(epoch) == jd.enqueue_round(epoch) == 6
    rows = _rows(store.db_path, "tournament_pairing_queue")
    assert rows == _rows(jstore.db_path, "tournament_pairing_queue")
    assert {r["round_id"] for r in rows} == {1, 2} and {r["status"] for r in rows} == {"pending"}


def test_worker_claims_plays_records_and_marks_done(tmp_path):
    _, _, store = _seed_stores(tmp_path)
    cfg = league_config_from_dict(LEAGUE)
    assert TournamentDispatcher(store, cfg).enqueue_round(2) == 6
    w = worker.TournamentWorker(store.db_path, store.league_dir, config=cfg,
                                parallel_matches=2, store=store, device="cpu")
    w._tourney.max_ply = MAX_PLY
    assert w.device == torch.device("cpu")
    assert w.run_once() == 4  # 2 x parallel_matches claimed
    queue = _rows(store.db_path, "tournament_pairing_queue")
    assert [r["status"] for r in queue].count("done") == 4
    assert {r["worker_id"] for r in queue if r["status"] == "done"} == {w.worker_id}
    data = jax_db.read_league_data(store.db_path)
    assert len(data["results"]) == 4 and all(
        r["match_type"] == "tournament" for r in data["results"])
    assert sum(r["games"] for r in jax_db.read_head_to_head(store.db_path)) == 4 * 2
    health = dbq.get_worker_health(store.db_path)
    assert [h["worker_id"] for h in health] == [w.worker_id] and health[0]["is_healthy"]
    assert health[0]["device"] == "cpu" and health[0]["pairings_done"] == 4
    assert w.run_once() == 2 and w.run_once() == 0


def test_worker_main_on_the_cpu(tmp_path, monkeypatch):
    """The entry point with `--device cpu` builds its worker there and runs
    it (its loop replaced by one claim)."""
    _, _, store = _seed_stores(tmp_path)
    TournamentDispatcher(store, league_config_from_dict(LEAGUE)).enqueue_round(1)
    ran = []

    def run(self):
        self._tourney.max_ply = MAX_PLY
        ran.append((self.device, self.run_once()))

    monkeypatch.setattr(worker.TournamentWorker, "run", run)
    worker.main(["--db", store.db_path, "--league-dir", store.league_dir,
                 "--parallel-matches", "1", "--device", "cpu"])
    assert ran == [(torch.device("cpu"), 2)]


def test_evaluate_main_on_the_cpu(tmp_path, capsys):
    paths = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        model = build_model("se_resnet", TINY)[0]
        path = str(tmp_path / f"ck{seed}")
        save_checkpoint(path, model, make_optimizer(model, KataGoPPOParams()), epoch=seed,
                        architecture="se_resnet", generator=torch.Generator(),
                        extra_meta={"model_params": TINY})
        paths.append(path)
    evaluate.main(["--a", paths[0], "--b", paths[1], "--games", "4", "--max-ply", "12",
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["games"] == 4 and out["wins_a"] + out["wins_b"] + out["draws"] == 4
    assert 0.0 <= out["wilson_low"] <= out["win_rate_a"] <= out["wilson_high"] <= 1.0
    assert evaluate.elo_delta(0.5) == 0.0 and evaluate.wilson_interval(0.5, 0) == (0.0, 1.0)


RAW = {
    "model": {"architecture": "se_resnet",
              "params": {"num_blocks": 1, "channels": 16, "global_pool_channels": 8,
                         "se_reduction": 4}},
    "training": {"num_games": 8, "max_ply": 24, "steps_per_epoch": 8,
                 "checkpoint_interval": 100,
                 "algorithm_params": {"batch_size": 16, "epochs_per_batch": 1}},
    "league": {
        "opponents_per_epoch": 2, "snapshot_interval": 1, "epochs_per_seat": 100,
        "tournament_enabled": True, "tournament_interval_epochs": 1,
        "tournament_num_envs": 2,
        "storage": {"snapshot_dtype": "bfloat16"},
        "concurrency": {"parallel_matches": 2, "envs_per_match": 2},
        "gauntlet": {"enabled": False},
    },
}


def _raw(tmp_path, **league):
    raw = copy.deepcopy(RAW)
    raw["training"]["checkpoint_dir"] = str(tmp_path / "ck")
    raw["league"]["storage"]["league_dir"] = str(tmp_path / "league")
    raw["league"].update(league)
    raw["display"] = {"db_path": str(tmp_path / "obs.db")}
    return raw


@pytest.mark.parametrize("mode", ["in_process", "sidecar"])
def test_league_trainer_with_the_tournament(tmp_path, mode):
    """Two league epochs with the tournament on and its min_epoch lowered:
    in process, a round runs in the maintenance after epoch 2 (the pool
    then holds 3 entries) and writes its stats and features; sidecar, the
    dispatcher enqueues a round after each epoch."""
    trainer = SelfPlayTrainer(config_from_dict(_raw(tmp_path, tournament_mode=mode)),
                              device="cpu")
    if mode == "in_process":
        assert isinstance(trainer.tournament, LeagueTournament) and trainer.dispatcher is None
        assert trainer.tournament.device == trainer.device == torch.device("cpu")
        assert trainer.tournament.dynamic_trainer is trainer.dyn_trainer
        assert trainer._tournament_blocks()
        trainer.tournament.min_epoch = 1
        trainer.tournament.max_ply, trainer.tournament.chunk_steps = 16, 8
    else:
        assert isinstance(trainer.dispatcher, TournamentDispatcher)
        assert trainer.tournament is None
    trainer.run(2)
    db_path = trainer.store.db_path
    if mode == "in_process":
        stats = jax_db.read_tournament_stats(db_path)
        assert stats["pairings_completed"] == stats["pairings_requested"] == 3
        assert len(jax_db.read_all_game_features(db_path)) == 2 * 3 * 2
        assert trainer._maint_phase_s["tournament"] > 0
    else:
        queue = _rows(db_path, "tournament_pairing_queue")
        assert {r["enqueued_epoch"] for r in queue} == {1, 2}
        assert {r["status"] for r in queue} == {"pending"}


def test_the_shipped_league_config_builds_its_tournament(tmp_path):
    """configs/katago-league.toml as shipped (tournament on, in process)
    builds a league trainer with its tournament, at a tiny model and with
    its paths under tmp_path."""
    import tomllib

    with open(REPO / "configs" / "katago-league.toml", "rb") as f:
        raw = tomllib.load(f)
    raw["model"]["params"].update(RAW["model"]["params"])
    raw["training"]["checkpoint_dir"] = str(tmp_path / "ck")
    raw["display"]["db_path"] = str(tmp_path / "obs.db")
    raw["league"]["storage"]["league_dir"] = str(tmp_path / "league")
    trainer = SelfPlayTrainer(config_from_dict(raw), device="cpu")
    lc = trainer.config.league
    assert lc.tournament_enabled and lc.tournament_mode == "in_process"
    assert isinstance(trainer.tournament, LeagueTournament) and trainer.dispatcher is None
    assert trainer.tournament.device == torch.device("cpu") and trainer.tournament.max_ply == 512
    assert trainer.dyn_trainer.device == torch.device("cpu")
    assert trainer.store.pool_size() == 1


def test_gauntlet_keeps_the_reference_max_ply(tmp_path):
    """A league trainer whose training max_ply is 24 plays its gauntlet at
    the same max_ply as the JAX trainer built from the same dict (the
    gauntlet's default, 512)."""
    from keisei_tpu.training.config import config_from_dict as jax_config_from_dict
    from keisei_tpu.training.loop import SelfPlayTrainer as JaxTrainer

    raw = _raw(tmp_path / "port", tournament_enabled=False)
    trainer = SelfPlayTrainer(config_from_dict(raw), device="cpu")
    jraw = _raw(tmp_path / "jax", tournament_enabled=False)
    jtrainer = JaxTrainer(jax_config_from_dict(jraw))
    assert raw["training"]["max_ply"] == 24
    assert trainer.gauntlet.max_ply == jtrainer.gauntlet.max_ply == 512
    assert os.path.isdir(str(tmp_path / "jax" / "league"))
