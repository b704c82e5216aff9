"""The port's showcase sidecar and demonstrator (keisei_tpu_torch/showcase/)
on the CPU against the JAX package's (keisei_tpu/showcase/).

A full exhibition game is played by both runners on pools that hold the
same tiny float32 se_resnet weights (models/convert.py), from the same
seeded `_rng`: the showcase_moves rows are equal field for field (action,
notation, USI, board and hands JSON exactly; the value estimate and the
heatmap's and top candidates' probabilities within rtol = atol = 1e-4, the
float32 bound of tests/test_torch_models.py; move_time_ms excluded), and
the port's rows read back through keisei_tpu.db.showcase. The JAX
package's own showcase tests use an mlp entry; the port has no scalar
models yet, so both pools hold se_resnet entries here, in float32 (in
bfloat16 the two frameworks' probabilities drift far enough apart to
change a seeded draw).

The control cases of tests/test_showcase.py and the demonstrator cases of
tests/test_evaluate_demonstrator.py run on the port's runner. Games that
go through a model stop at max_ply 12 or less."""

import json
import sqlite3
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keisei_tpu.showcase.runner as jax_runner_mod
import keisei_tpu_torch.showcase.runner as runner_mod
from keisei_tpu.db import showcase as jax_sc
from keisei_tpu.league.store import OpponentStore as JaxOpponentStore
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch import db
from keisei_tpu_torch.db import core as dbcore
from keisei_tpu_torch.db import showcase as sc
from keisei_tpu_torch.league.store import OpponentStore, Role
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.showcase.demonstrator import Demonstrator
from keisei_tpu_torch.showcase.runner import ModelCache, ShowcaseRunner, build_heatmap

torch.set_num_threads(2)

TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4,
        "dtype": "float32"}
NO_DELAY = {"slow": 0, "normal": 0, "fast": 0}
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_variables(seed: int) -> dict:
    model, _ = jax_build_model("se_resnet", TINY)
    return jax.device_get(model.init(jax.random.key(seed), jnp.zeros((1, 50, 9, 9)),
                                     train=False))


def _port_pool(tmp_path, seeds=(0, 1), name="port"):
    """A port store on the CPU with one se_resnet entry per seed, the
    converted weights of `_jax_variables(seed)`."""
    db_path = str(tmp_path / f"{name}.db")
    store = OpponentStore(db_path, str(tmp_path / f"{name}_league"), device="cpu")
    for seed in seeds:
        v = _jax_variables(seed)
        store.add_entry(flax_to_torch(v["params"], v["batch_stats"]),
                        architecture="se_resnet", model_params=TINY, created_epoch=0,
                        role=Role.DYNAMIC)
    return db_path, store


@pytest.fixture
def pool2(tmp_path, monkeypatch):
    """DB + port store with two entries, zeroed move delays."""
    monkeypatch.setattr(runner_mod, "SPEED_DELAYS", NO_DELAY)
    return _port_pool(tmp_path)


class TestHeatmap:
    def test_filters_by_from_square(self):
        legal = [(1, "7g7f"), (2, "7g7e"), (3, "2g2f"), (4, "P*5e")]
        probs = {1: 0.5, 2: 0.2, 3: 0.25, 4: 0.05}
        assert build_heatmap("7g7f", legal, probs) == {"7g7f": 0.5, "7g7e": 0.2}
        assert build_heatmap("P*5e", legal, probs) == {"P*5e": 0.05}

    def test_drops_zero_and_nonfinite(self):
        legal = [(1, "7g7f"), (2, "7g7e")]
        assert build_heatmap("7g7f", legal, {1: 0.0, 2: float("nan")}) == {}

    def test_equals_the_jax_heatmap(self):
        rng = np.random.default_rng(0)
        legal = [(i, u) for i, u in enumerate(["7g7f", "7g7e", "7g6f", "2g2f", "P*5e",
                                                "P*5d", "8h2b+"])]
        probs = {i: float(p) for i, p in enumerate(rng.dirichlet(np.ones(7)))}
        probs[1] = float("inf")
        for usi in ("7g7f", "P*5e", "8h2b+", "2g2f"):
            assert build_heatmap(usi, legal, probs) == \
                jax_runner_mod.build_heatmap(usi, legal, probs)


def _moves(sc_mod, db_path, gid=1):
    return sc_mod.read_all_showcase_moves(db_path, gid)


def test_exhibition_game_equals_the_jax_runner(tmp_path, monkeypatch):
    """One game of max_ply 12 by each runner, the same draws from one seed."""
    monkeypatch.setattr(runner_mod, "SPEED_DELAYS", NO_DELAY)
    monkeypatch.setattr(jax_runner_mod, "SPEED_DELAYS", NO_DELAY)
    jdb = str(tmp_path / "jax.db")
    jstore = JaxOpponentStore(jdb, str(tmp_path / "jax_league"))
    for seed in (0, 1):
        jstore.add_entry(_jax_variables(seed), architecture="se_resnet",
                         model_params=TINY, created_epoch=0, role=Role.DYNAMIC)
    pdb, pstore = _port_pool(tmp_path)
    games = {}
    for name, mod, sc_mod, path, store in (
            ("jax", jax_runner_mod, jax_sc, jdb, jstore),
            ("port", runner_mod, sc, pdb, pstore)):
        qid = sc_mod.queue_match(path, "1", "2", "fast")
        runner = mod.ShowcaseRunner(path, str(tmp_path / name), max_ply=12,
                                    auto_showcase=False, store=store)
        runner._rng = np.random.default_rng(7)
        runner.play_match(sc_mod.claim_next_match(path))
        sc_mod.complete_queue_entry(path, qid)
        assert sc_mod.get_queue_status(path, qid) == "done"
        games[name] = sc_mod.read_showcase_game(path, 1)
    jg, pg = games["jax"], games["port"]
    assert pg["status"] in ("black_win", "white_win", "draw")
    volatile = {"started_at", "completed_at", "updated_at", "created_at"}
    assert {k: v for k, v in pg.items() if k not in volatile} == \
        {k: v for k, v in jg.items() if k not in volatile}

    jm, pm = _moves(jax_sc, jdb), _moves(sc, pdb)
    assert len(pm) == len(jm) == pg["total_ply"] >= 1
    # the port's rows through the JAX package's reader
    assert _moves(jax_sc, pdb) == pm
    for a, b in zip(pm, jm):
        assert a.keys() == b.keys()
        for k in a:
            if k in ("move_time_ms", "created_at", "id"):
                continue
            if k == "value_estimate":
                np.testing.assert_allclose(a[k], b[k], **TOL)
            elif k == "move_heatmap_json":
                ha, hb = json.loads(a[k]), json.loads(b[k])
                assert ha.keys() == hb.keys() and a["move_usi"] in ha
                np.testing.assert_allclose([ha[u] for u in hb], list(hb.values()), **TOL)
            elif k == "top_candidates":
                ta, tb = json.loads(a[k]), json.loads(b[k])
                assert sorted(u for u, _ in ta) == sorted(u for u, _ in tb)
                np.testing.assert_allclose(sorted(p for _, p in ta), sorted(p for _, p in tb),
                                           **TOL)
            else:
                assert a[k] == b[k], k
    assert all(m["value_estimate"] is not None and np.isfinite(m["value_estimate"])
               for m in pm)


def test_model_cache_is_an_lru_of_two_keyed_by_update_count(tmp_path):
    db_path, store = _port_pool(tmp_path, seeds=(0, 1, 2))
    cache = ModelCache(store)
    m1 = cache.get(1)
    assert not m1.training and next(m1.parameters()).device == store.device
    assert cache.get(1) is m1
    cache.get(2)
    cache.get(3)
    assert cache.get(1) is not m1  # evicted: two entries at most
    m1 = cache.get(1)
    store.bump_update_count(1)
    assert cache.get(1) is not m1  # a new generation is a new key


def test_a_scalar_contract_entry_raises_not_yet_ported(tmp_path):
    db_path, store = _port_pool(tmp_path, seeds=())
    store.add_entry({}, architecture="mlp", model_params={"hidden_sizes": [16]},
                    created_epoch=0, role=Role.DYNAMIC)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ModelCache(store).get(1)


class TestShowcaseControl:
    """Cancellation, speed changes, bad entries, orphan sweeps, the run
    loop: tests/test_showcase.py's cases on the port's runner."""

    def test_cancel_before_first_poll_abandons_game(self, pool2):
        db_path, store = pool2
        qid = sc.queue_match(db_path, "1", "2", "fast")
        runner = ShowcaseRunner(db_path, str(store.league_dir), max_ply=12,
                                auto_showcase=False, store=store)
        match = sc.claim_next_match(db_path)
        sc.cancel_match(db_path, qid)  # user cancels while claimed
        runner.play_match(match)
        game = sc.read_showcase_game(db_path, 1)
        assert game["status"] == "abandoned"
        assert game["abandon_reason"] == "cancelled by user"
        sc.complete_queue_entry(db_path, qid)
        assert sc.get_queue_status(db_path, qid) == "cancelled"

    def test_speed_change_mid_game_is_picked_up(self, pool2, monkeypatch):
        db_path, store = pool2
        qid = sc.queue_match(db_path, "1", "2", "fast")
        monkeypatch.setattr(runner_mod, "SPEED_DELAYS", {"slow": 111, "normal": 0, "fast": 0})
        sleeps = []
        monkeypatch.setattr(runner_mod.time, "sleep", lambda s: sleeps.append(s))
        runner = ShowcaseRunner(db_path, str(store.league_dir), max_ply=12,
                                auto_showcase=False, store=store)
        match = sc.claim_next_match(db_path)
        sc.update_queue_speed(db_path, qid, "slow")
        runner.play_match(match)
        assert 111 in sleeps, "speed change never reached the move loop"

    def test_unknown_entries_cancel_queue_entry(self, pool2):
        db_path, store = pool2
        qid = sc.queue_match(db_path, "777", "888", "fast")
        runner = ShowcaseRunner(db_path, str(store.league_dir), auto_showcase=False,
                                store=store)
        runner.play_match(sc.claim_next_match(db_path))
        assert sc.get_queue_status(db_path, qid) == "cancelled"
        assert sc.read_showcase_game(db_path, 1) is None

    def test_play_db_failure_requeues_entry(self, pool2, monkeypatch):
        """play_match dying on a DB error requeues the entry, which is
        replayed, not marked done with no game."""
        db_path, store = pool2
        sc.queue_match(db_path, "1", "2", "fast")
        runner = ShowcaseRunner(db_path, str(store.league_dir), max_ply=8,
                                auto_showcase=False, store=store)
        calls = {"n": 0}
        real_play = runner.play_match

        def flaky_play(row):
            calls["n"] += 1
            if calls["n"] == 1:
                raise sqlite3.OperationalError("database is locked")
            real_play(row)

        monkeypatch.setattr(runner, "play_match", flaky_play)
        monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)  # the 5 s backoff
        status = _run_until_done(runner, db_path, 1)
        assert status == "done"
        assert calls["n"] == 2, "entry was not replayed after the requeue"
        game = sc.read_showcase_game(db_path, 1)
        assert game is not None and game["status"] != "in_progress"

    def test_orphan_cleanup_sweeps_stale_games(self, pool2):
        db_path, _ = pool2
        qid = sc.queue_match(db_path, "1", "2", "normal")
        sc.claim_next_match(db_path)
        sc.create_showcase_game(db_path, queue_id=qid, entry_id_black="1",
                                entry_id_white="2")
        dbcore.write_row(db_path, "showcase_heartbeat", {
            "id": 1, "runner_pid": 99, "last_heartbeat": "2020-01-01T00:00:00Z",
        }, replace=True)
        assert sc.cleanup_orphaned_games(db_path) == 1
        assert sc.read_showcase_game(db_path, 1)["status"] == "abandoned"
        assert sc.get_queue_status(db_path, qid) == "cancelled"

    def test_orphan_cleanup_noop_when_runner_alive(self, pool2):
        db_path, _ = pool2
        qid = sc.queue_match(db_path, "1", "2", "normal")
        sc.claim_next_match(db_path)
        sc.create_showcase_game(db_path, queue_id=qid, entry_id_black="1",
                                entry_id_white="2")
        sc.write_heartbeat(db_path, 123)  # fresh
        assert sc.cleanup_orphaned_games(db_path) == 0
        assert sc.read_showcase_game(db_path, 1)["status"] == "in_progress"

    def test_auto_showcase_queues_match(self, pool2):
        db_path, store = pool2
        runner = ShowcaseRunner(db_path, str(store.league_dir), auto_showcase=True,
                                store=store)
        runner._last_activity = time.monotonic() - runner_mod.AUTO_SHOWCASE_INTERVAL_S - 1.0
        runner._maybe_auto_showcase()
        q = sc.read_queue(db_path)
        assert len(q) == 1 and q[0]["status"] == "pending"

    def test_requeue_preserves_cancellation(self, pool2):
        db_path, _ = pool2
        qid = sc.queue_match(db_path, "1", "2", "fast")
        sc.claim_next_match(db_path)
        sc.cancel_match(db_path, qid)
        sc.requeue_entry(db_path, qid)  # must not resurrect
        assert sc.get_queue_status(db_path, qid) == "cancelled"

    def test_claimed_entry_completes_after_transient_db_error(self, pool2, monkeypatch):
        """A failed complete_queue_entry must not wedge the queue: the
        runner completes the claimed id before claiming again."""
        db_path, store = pool2
        sc.queue_match(db_path, "1", "2", "fast")
        runner = ShowcaseRunner(db_path, str(store.league_dir), auto_showcase=False,
                                store=store)
        played = []
        monkeypatch.setattr(runner, "play_match", lambda row: played.append(row["id"]))
        calls = {"n": 0}
        real_complete = sc.complete_queue_entry

        def flaky_complete(path, qid):
            calls["n"] += 1
            if calls["n"] == 1:
                raise sqlite3.OperationalError("database is locked")
            real_complete(path, qid)

        monkeypatch.setattr(sc, "complete_queue_entry", flaky_complete)
        monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)
        status = _run_until_done(runner, db_path, 1)
        assert played, "match was never claimed/played"
        assert status == "done", f"queue stuck in {status!r}"
        assert calls["n"] >= 2

    def test_run_loop_claims_plays_and_stops(self, pool2):
        """run(): startup sweep -> heartbeat -> claim -> play -> complete,
        then a clean stop from another thread (SIGTERM's request_stop)."""
        db_path, store = pool2
        qid = sc.queue_match(db_path, "1", "2", "fast")
        runner = ShowcaseRunner(db_path, str(store.league_dir), max_ply=8,
                                auto_showcase=False, store=store)
        assert _run_until_done(runner, db_path, qid) == "done"
        game = sc.read_showcase_game(db_path, 1)
        assert game["status"] in ("black_win", "white_win", "draw")
        assert sc.read_heartbeat(db_path) is not None


def _run_until_done(runner, db_path, qid, timeout=60.0):
    """runner.run() on a thread until queue entry `qid` is done (or the
    timeout), then stopped and joined; returns the entry's last status."""
    t = threading.Thread(target=runner.run, daemon=True)
    t.start()
    deadline = time.monotonic() + timeout
    status = None
    while time.monotonic() < deadline:
        status = sc.get_queue_status(db_path, qid)
        if status == "done":
            break
        time.sleep(0.05)
    runner.request_stop()
    t.join(timeout=30)
    assert not t.is_alive()
    return status


class TestDemonstrator:
    def test_pick_prefers_frontier_vs_dynamic(self, pool2):
        db_path, store = pool2
        store.update_role(store.list_entries()[0].id, Role.FRONTIER_STATIC)
        demo = Demonstrator(db_path, store)
        for _ in range(5):
            a, b = demo._pick_matchup()
            assert a.role == Role.FRONTIER_STATIC and b.role == Role.DYNAMIC

    def test_pick_falls_back_to_any_two_distinct(self, pool2):
        db_path, store = pool2
        a, b = Demonstrator(db_path, store)._pick_matchup()
        assert a.id != b.id

    def test_pick_none_with_fewer_than_two(self, tmp_path):
        db_path, store = _port_pool(tmp_path, seeds=(0,))
        assert Demonstrator(db_path, store)._pick_matchup() is None

    def test_play_one_writes_demo_snapshots(self, pool2):
        db_path, store = pool2
        demo = Demonstrator(db_path, store, demo_slot=2, moves_per_minute=60_000, max_ply=6)
        entries = store.list_entries()
        demo._play_one(entries[0], entries[1])
        rows = [r for r in db.read_game_snapshots(db_path) if r.get("game_type") == "demo"]
        assert rows, "demonstrator wrote no demo snapshots"
        r = rows[-1]
        assert r["game_id"] == 1002 and r["demo_slot"] == 2
        assert len(json.loads(r["board_json"])) == 81
        assert 1 <= len(json.loads(r["move_history_json"])) <= 6
        assert r["ply"] >= 1 and r["is_over"] == 1

    def test_stop_without_start_is_safe(self, pool2):
        db_path, store = pool2
        Demonstrator(db_path, store).stop()

    def test_start_stop_lifecycle(self, pool2):
        db_path, store = pool2
        demo = Demonstrator(db_path, store, moves_per_minute=60_000, max_ply=4)
        demo.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(r.get("game_type") == "demo" for r in db.read_game_snapshots(db_path)):
                break
            time.sleep(0.05)
        demo.stop()
        demo._thread.join(timeout=30)
        assert not demo._thread.is_alive()
        assert any(r.get("game_type") == "demo" for r in db.read_game_snapshots(db_path))
