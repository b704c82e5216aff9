"""Training telemetry: metrics, training_state (heartbeat), game snapshots.

The write surface the training loop needs (reference:
keisei/db/metrics.py, training_state.py, snapshots.py) and the cursored
read surface the dashboard server needs.
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


def write_metrics(db_path: str, metrics: dict[str, Any]) -> None:
    core.write_row(db_path, "metrics", _metric_row(metrics))


def read_metrics_since(db_path: str, since_id: int, limit: int = 500) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path, "SELECT * FROM metrics WHERE id > ? ORDER BY id LIMIT ?",
        (since_id, limit),
    )


def read_metrics_tail(db_path: str, limit: int = 500) -> list[dict[str, Any]]:
    """Newest `limit` metrics rows, ascending id.

    For init payloads: read_metrics_since(p, 0, N) returns rows 1..N — on a
    long run a (re)connecting dashboard would then crawl from the oldest
    epoch to live at the poll rate (minutes of stale charts). The client
    wants the RECENT window."""
    return core.fetch_all(
        db_path,
        "SELECT * FROM (SELECT * FROM metrics ORDER BY id DESC LIMIT ?) "
        "ORDER BY id",
        (limit,),
    )


def sum_episodes_completed(db_path: str, up_to_id: int | None = None) -> int:
    """Lifetime episode count across metrics rows (the init payload only
    carries the newest window, so the counter must come from SQL).

    up_to_id bounds the sum at the caller's poll cursor: rows written
    between the init tail read and this call have id > cursor and will be
    counted by the first read_metrics_since poll — summing them here too
    double-counts them for the connection's lifetime (review r2)."""
    if up_to_id is None:
        row = core.fetch_one(
            db_path,
            "SELECT COALESCE(SUM(episodes_completed), 0) AS s FROM metrics",
        )
    else:
        row = core.fetch_one(
            db_path,
            "SELECT COALESCE(SUM(episodes_completed), 0) AS s FROM metrics "
            "WHERE id <= ?",
            (up_to_id,),
        )
    return int(row["s"]) if row else 0


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


def set_total_epochs(db_path: str, total_epochs: int) -> None:
    core.execute(
        db_path, "UPDATE training_state SET total_epochs = ? WHERE id = 1",
        (total_epochs,),
    )


def set_status(db_path: str, status: str) -> None:
    core.execute(
        db_path, "UPDATE training_state SET status = ? WHERE id = 1", (status,)
    )


def update_heartbeat(db_path: str) -> None:
    core.execute(
        db_path,
        f"UPDATE training_state SET heartbeat_at = {core.NOW_SEC} WHERE id = 1",
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
    """Metrics insert + progress update + WAL truncate, one connection.

    Matches the reference's batched epoch write (training_state.py
    write_epoch_summary) so WAL growth stays bounded across epochs.
    """
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


def read_game_snapshots(db_path: str) -> list[dict[str, Any]]:
    return core.fetch_all(db_path, "SELECT * FROM game_snapshots ORDER BY game_id")


def read_game_snapshots_since(
    db_path: str, since_ts: str, since_game_id: int = 0
) -> tuple[list[dict[str, Any]], str, int]:
    """Composite-cursor incremental read: (updated_at, game_id) strictly after
    the cursor, so equal timestamps can't drop rows (reference
    snapshots.py read_game_snapshots_since)."""
    rows = core.fetch_all(
        db_path,
        "SELECT * FROM game_snapshots "
        "WHERE updated_at > ? OR (updated_at = ? AND game_id > ?) "
        "ORDER BY updated_at, game_id",
        (since_ts, since_ts, since_game_id),
    )
    max_ts, max_gid = since_ts, since_game_id
    if rows:
        max_ts = max(r["updated_at"] for r in rows)
        max_gid = max(r["game_id"] for r in rows if r["updated_at"] == max_ts)
    return rows, max_ts, max_gid
