"""Demonstrator: daemon playing slow exhibition games into game_snapshots
(counterpart of keisei_tpu/showcase/demonstrator.py).

A background thread picks role-aware matchups from the pool, plays them
via SpectatorEnv at a watchable pace (temperature 0.5), and upserts
`game_snapshots` rows (game_type='demo') the WS server streams to the UI.
Models and games run on the store's device, through the runner's
ModelCache.
"""

from __future__ import annotations

import json
import logging
import threading

import numpy as np

from .. import db
from ..env.spectator import SpectatorEnv
from ..league.store import OpponentStore, Role
from .runner import ModelCache, policy_and_value

logger = logging.getLogger(__name__)


class Demonstrator:
    def __init__(self, db_path: str, store: OpponentStore, *,
                 demo_slot: int = 0, moves_per_minute: int = 30,
                 max_ply: int = 512):
        self.db_path = db_path
        self.store = store
        self.demo_slot = demo_slot
        self.move_delay = 60.0 / max(moves_per_minute, 1)
        self.max_ply = max_ply
        self.cache = ModelCache(store)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._rng = np.random.default_rng(demo_slot + 1)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"demonstrator-{self.demo_slot}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _pick_matchup(self):
        """Role-aware: prefer a frontier-vs-dynamic pairing, else any two."""
        frontier = self.store.list_by_role(Role.FRONTIER_STATIC)
        dynamic = self.store.list_by_role(Role.DYNAMIC)
        pool = self.store.list_entries()
        if frontier and dynamic:
            return (frontier[int(self._rng.integers(len(frontier)))],
                    dynamic[int(self._rng.integers(len(dynamic)))])
        if len(pool) >= 2:
            i, j = self._rng.choice(len(pool), 2, replace=False)
            return pool[int(i)], pool[int(j)]
        return None

    def _run(self) -> None:
        while not self._stop.is_set():
            matchup = self._pick_matchup()
            if matchup is None:
                self._stop.wait(10)
                continue
            try:
                self._play_one(*matchup)
            except Exception:
                logger.exception("demonstrator game failed — continuing")
                self._stop.wait(5)

    def _play_one(self, black, white) -> None:
        env = SpectatorEnv(max_ply=self.max_ply, action_mode="spatial",
                           device=self.store.device)
        game_id = 1000 + self.demo_slot  # demo slots live above live-game ids
        while not env.is_over() and not self._stop.is_set():
            mover = black if env.current_player() == "black" else white
            logits, _ = policy_and_value(self.cache.get(mover.id), env)
            legal = np.array(env.legal_actions())
            masked = np.full(logits.shape, -np.inf, np.float32)
            masked[legal] = logits[legal] / 0.5
            z = np.exp(masked - masked.max())
            d = env.step(int(self._rng.choice(len(z), p=z / z.sum())))
            try:
                db.write_game_snapshots(self.db_path, [{
                    "game_id": game_id,
                    "board_json": json.dumps(d["board"]),
                    "hands_json": json.dumps(d["hands"]),
                    "current_player": d["current_player"],
                    "ply": d["ply"],
                    "is_over": int(d["is_over"]),
                    "result": d["result"],
                    "sfen": d["sfen"],
                    "in_check": int(d["in_check"]),
                    "move_history_json": json.dumps(d["move_history"][-30:]),
                    "game_type": "demo",
                    "demo_slot": self.demo_slot,
                }])
            except Exception:
                logger.exception("demo snapshot write failed — continuing")
            self._stop.wait(self.move_delay)
