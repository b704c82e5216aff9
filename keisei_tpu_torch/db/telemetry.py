"""Training telemetry writes: metrics, training_state (heartbeat), game
snapshots.

The port's own copy of the write surface of keisei_tpu/db/telemetry.py that
the training observer calls, and `read_training_state`, where a league run
finds its learner's entry on resume. The dashboard's read surface stays in
the JAX package, which reads the same tables.
"""

from __future__ import annotations

from typing import Any

from . import core

_METRIC_COLS = (
    "epoch", "step", "policy_loss", "value_loss", "entropy", "win_rate",
    "loss_rate", "black_win_rate", "white_win_rate", "draw_rate",
    "truncation_rate", "avg_episode_length", "gradient_norm",
    "episodes_completed",
)


def _metric_row(metrics: dict[str, Any]) -> dict[str, Any]:
    row = {c: metrics.get(c) for c in _METRIC_COLS}
    row["epoch"] = metrics.get("epoch", 0)
    row["step"] = metrics.get("step", 0)
    return row


# --- training_state singleton ------------------------------------------------


def write_training_state(db_path: str, state: dict[str, Any]) -> None:
    row = {
        "id": 1,
        "config_json": state["config_json"],
        "display_name": state["display_name"],
        "model_arch": state["model_arch"],
        "algorithm_name": state["algorithm_name"],
        "started_at": state["started_at"],
        "current_epoch": state.get("current_epoch", 0),
        "current_step": state.get("current_step", 0),
        "checkpoint_path": state.get("checkpoint_path"),
        "total_epochs": state.get("total_epochs"),
        "status": state.get("status", "running"),
        "phase": state.get("phase", "init"),
        "learner_entry_id": state.get("learner_entry_id"),
    }
    core.write_row(db_path, "training_state", row, replace=True)


def read_training_state(db_path: str) -> dict[str, Any] | None:
    return core.fetch_one(db_path, "SELECT * FROM training_state WHERE id = 1")


def set_status(db_path: str, status: str) -> None:
    core.execute(
        db_path, "UPDATE training_state SET status = ? WHERE id = 1", (status,)
    )


def update_training_progress(
    db_path: str,
    epoch: int,
    step: int,
    checkpoint_path: str | None = None,
    phase: str | None = None,
    learner_entry_id: int | None = None,
) -> None:
    sets = ["current_epoch = ?", "current_step = ?", f"heartbeat_at = {core.NOW_SEC}"]
    params: list[Any] = [epoch, step]
    for col, val in (
        ("checkpoint_path", checkpoint_path),
        ("phase", phase),
        ("learner_entry_id", learner_entry_id),
    ):
        if val is not None:
            sets.append(f"{col} = ?")
            params.append(val)
    core.execute(
        db_path, f"UPDATE training_state SET {', '.join(sets)} WHERE id = 1",
        tuple(params),
    )


def write_epoch_summary(
    db_path: str,
    metrics: dict[str, Any],
    epoch: int,
    step: int,
    checkpoint_path: str | None = None,
) -> None:
    """Metrics insert + progress update + WAL truncate, one connection, so
    WAL growth stays bounded across epochs."""
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN")
        core.insert(conn, "metrics", _metric_row(metrics))
        sets = ["current_epoch = ?", "current_step = ?", f"heartbeat_at = {core.NOW_SEC}"]
        params: list[Any] = [epoch, step]
        if checkpoint_path is not None:
            sets.append("checkpoint_path = ?")
            params.append(checkpoint_path)
        conn.execute(
            f"UPDATE training_state SET {', '.join(sets)} WHERE id = 1", params
        )
        conn.commit()
        conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    finally:
        conn.close()


# --- game snapshots ------------------------------------------------------------

_SNAP_REQUIRED = (
    "game_id", "board_json", "hands_json", "current_player", "ply", "is_over",
    "result", "sfen", "in_check", "move_history_json",
)
_SNAP_OPTIONAL = {"value_estimate": 0.0, "game_type": "live", "demo_slot": None,
                  "opponent_id": None}


def write_game_snapshots(db_path: str, snapshots: list[dict[str, Any]]) -> None:
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN")
        for snap in snapshots:
            row = {c: snap[c] for c in _SNAP_REQUIRED}
            row.update({c: snap.get(c, d) for c, d in _SNAP_OPTIONAL.items()})
            cols = list(row)
            conn.execute(
                f"INSERT OR REPLACE INTO game_snapshots "
                f"({', '.join(cols)}, updated_at) "
                f"VALUES ({', '.join(':' + c for c in cols)}, {core.NOW_MS})",
                row,
            )
        conn.commit()
    finally:
        conn.close()
