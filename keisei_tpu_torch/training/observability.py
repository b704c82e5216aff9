"""Training-loop observability: DB metrics, heartbeat, board snapshots.

The port's own copy of keisei_tpu/training/observability.py, over the
port's copies of db/, engine/types.py and env/spectator_data.py, so that
the port never imports the JAX package.

Implements the reference's telemetry protocol (katago_loop.py:1700-1952,
:1886-1909) against the db package: training_state row at startup, epoch
summaries (metrics + progress in one transaction), throttled heartbeats
with phase labels, and live-board snapshots pulled from the device at
epoch boundaries (the fused rollout never touches the host mid-epoch, so
snapshot cadence is per-epoch — SURVEY §7 hard part 6).

All writes are non-fatal: telemetry failure must never kill training
(reference policy, katago_loop.py:1731-1736).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import time
from typing import Any

import numpy as np

from .. import db
from ..engine import types as TY
from ..env.spectator_data import build_spectator_dict

logger = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 10.0  # reference: katago_loop.py:1886-1909


def _now_iso() -> str:
    return datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


class TrainingObserver:
    """Owns the DB side of a training run. Safe no-op when db_path is empty."""

    def __init__(self, db_path: str, max_snapshot_games: int = 8):
        self.db_path = db_path
        self.max_snapshot_games = max_snapshot_games
        self._last_heartbeat = 0.0
        self.enabled = bool(db_path)
        if self.enabled:
            db.init_db(db_path)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self, config, total_epochs: int | None = None) -> None:
        if not self.enabled:
            return
        try:
            db.write_training_state(self.db_path, {
                "config_json": json.dumps(dataclasses.asdict(config), default=str),
                "display_name": config.model.display_name,
                "model_arch": config.model.architecture,
                "algorithm_name": config.training.algorithm,
                "started_at": _now_iso(),
                "total_epochs": total_epochs,
                "phase": "init",
            })
        except Exception:
            logger.exception("training_state write failed — continuing")

    def on_stop(self, status: str = "stopped") -> None:
        if not self.enabled:
            return
        try:
            db.set_status(self.db_path, status)
        except Exception:
            logger.exception("status write failed — continuing")

    # -- heartbeat -----------------------------------------------------------

    def heartbeat(self, epoch: int, step: int, phase: str) -> None:
        """Throttled phase/progress heartbeat (<=1 write / 10 s, plus every
        phase transition is the caller's prerogative by calling directly)."""
        if not self.enabled:
            return
        now = time.monotonic()
        if now - self._last_heartbeat < HEARTBEAT_INTERVAL_S:
            return
        self._last_heartbeat = now
        try:
            db.update_training_progress(self.db_path, epoch, step, phase=phase)
        except Exception:
            logger.exception("heartbeat write failed — continuing")

    # -- epoch summary ---------------------------------------------------------

    def on_epoch(
        self,
        em: dict[str, Any],
        step: int,
        checkpoint_path: str | None = None,
    ) -> None:
        """Map EpochMetrics fields onto the reference metrics row."""
        if not self.enabled:
            return
        episodes = em.get("episodes", 0)
        terminated = max(episodes - em.get("truncated", 0), 0)
        wins = em.get("wins_black", 0) + em.get("wins_white", 0)
        row = {
            "epoch": em["epoch"],
            "step": step,
            "policy_loss": em.get("policy_loss"),
            "value_loss": em.get("value_loss"),
            "entropy": em.get("entropy"),
            "gradient_norm": em.get("gradient_norm"),
            "episodes_completed": episodes,
            "win_rate": wins / terminated if terminated else None,
            "loss_rate": None,
            "black_win_rate": em.get("wins_black", 0) / terminated if terminated else None,
            "white_win_rate": em.get("wins_white", 0) / terminated if terminated else None,
            "draw_rate": em.get("draws", 0) / terminated if terminated else None,
            "truncation_rate": em.get("truncated", 0) / episodes if episodes else None,
            "avg_episode_length": em.get("mean_episode_length"),
        }
        try:
            db.write_epoch_summary(
                self.db_path, row, em["epoch"], step, checkpoint_path
            )
        except Exception:
            logger.exception("epoch summary write failed — continuing")

    # -- board snapshots -----------------------------------------------------

    def snapshot_envs(self, env_states, values: np.ndarray | None = None) -> None:
        """Write live boards for the first K envs from a batched GameState."""
        if not self.enabled:
            return
        try:
            k = min(self.max_snapshot_games, env_states.board.shape[0])
            boards = np.asarray(env_states.board[:k])
            hands = np.asarray(env_states.hands[:k])
            stms = np.asarray(env_states.stm[:k])
            plys = np.asarray(env_states.ply[:k])
            checks = np.asarray(env_states.in_check[:k])
            snaps = []
            for i in range(k):
                d = build_spectator_dict(
                    boards[i], hands[i], int(stms[i]), int(plys[i]),
                    reason=TY.NOT_TERMINATED, winner=-1,
                    in_check=bool(checks[i]),
                )
                snaps.append({
                    "game_id": i,
                    "board_json": json.dumps(d["board"]),
                    "hands_json": json.dumps(d["hands"]),
                    "current_player": d["current_player"],
                    "ply": d["ply"],
                    "is_over": int(d["is_over"]),
                    "result": d["result"],
                    "sfen": d["sfen"],
                    "in_check": int(d["in_check"]),
                    "move_history_json": "[]",
                    "value_estimate": float(values[i]) if values is not None else 0.0,
                })
            db.write_game_snapshots(self.db_path, snaps)
        except Exception:
            logger.exception("snapshot write failed — continuing")
