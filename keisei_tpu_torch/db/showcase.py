"""Showcase tables: exhibition-match queue, games, per-move rows, heartbeat.

The WS server reads these; the showcase sidecar claims queue entries and
writes moves (reference: keisei/db/showcase.py).
"""

from __future__ import annotations

import datetime
from typing import Any

from . import core


def _now() -> str:
    return datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


def queue_match(db_path: str, entry_id_1: str, entry_id_2: str, speed: str) -> int:
    return core.write_row(db_path, "showcase_queue", {
        "entry_id_1": entry_id_1, "entry_id_2": entry_id_2,
        "speed": speed, "requested_at": _now(),
    })


def claim_next_match(db_path: str) -> dict[str, Any] | None:
    """Claim the oldest pending entry; the partial unique index on
    status='running' guarantees at most one active match."""
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN IMMEDIATE")
        row = conn.execute(
            "SELECT * FROM showcase_queue WHERE status = 'pending' "
            "ORDER BY id LIMIT 1"
        ).fetchone()
        if row is None:
            conn.commit()
            return None
        running = conn.execute(
            "SELECT COUNT(*) FROM showcase_queue WHERE status = 'running'"
        ).fetchone()[0]
        if running:
            conn.commit()
            return None
        conn.execute(
            "UPDATE showcase_queue SET status = 'running', started_at = ? "
            "WHERE id = ?",
            (_now(), row["id"]),
        )
        conn.commit()
        return dict(row)
    finally:
        conn.close()


def read_queue(db_path: str) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path,
        "SELECT * FROM showcase_queue WHERE status IN ('pending', 'running') "
        "ORDER BY id",
    )


def cancel_match(db_path: str, queue_id: int) -> None:
    core.execute(
        db_path,
        "UPDATE showcase_queue SET status = 'cancelled', completed_at = ? "
        "WHERE id = ? AND status IN ('pending', 'running')",
        (_now(), queue_id),
    )


def update_queue_speed(db_path: str, queue_id: int, speed: str) -> None:
    core.execute(
        db_path, "UPDATE showcase_queue SET speed = ? WHERE id = ?",
        (speed, queue_id),
    )


def get_queue_speed(db_path: str, queue_id: int) -> str | None:
    row = core.fetch_one(
        db_path, "SELECT speed, status FROM showcase_queue WHERE id = ?", (queue_id,)
    )
    return row["speed"] if row else None


def get_queue_status(db_path: str, queue_id: int) -> str | None:
    row = core.fetch_one(
        db_path, "SELECT status FROM showcase_queue WHERE id = ?", (queue_id,)
    )
    return row["status"] if row else None


def requeue_entry(db_path: str, queue_id: int) -> None:
    """Put a claimed-but-unplayed entry back in line (runner crash recovery).

    Only 'running' entries revert — a user cancellation must stick."""
    core.execute(
        db_path,
        "UPDATE showcase_queue SET status = 'pending', started_at = NULL "
        "WHERE id = ? AND status = 'running'",
        (queue_id,),
    )


def complete_queue_entry(db_path: str, queue_id: int) -> None:
    # only running entries complete: a user cancellation (status =
    # 'cancelled') must survive the runner's post-match completion call
    core.execute(
        db_path,
        "UPDATE showcase_queue SET status = 'done', completed_at = ? "
        "WHERE id = ? AND status = 'running'",
        (_now(), queue_id),
    )


def create_showcase_game(
    db_path: str,
    *,
    queue_id: int,
    entry_id_black: str,
    entry_id_white: str,
    elo_black: float | None = None,
    elo_white: float | None = None,
    name_black: str | None = None,
    name_white: str | None = None,
) -> int:
    return core.write_row(db_path, "showcase_games", {
        "queue_id": queue_id, "entry_id_black": entry_id_black,
        "entry_id_white": entry_id_white, "elo_black": elo_black,
        "elo_white": elo_white, "name_black": name_black,
        "name_white": name_white, "started_at": _now(),
    })


def read_active_showcase_game(db_path: str) -> dict[str, Any] | None:
    return core.fetch_one(
        db_path,
        "SELECT * FROM showcase_games WHERE status = 'in_progress' "
        "ORDER BY id DESC LIMIT 1",
    )


def read_showcase_game(db_path: str, game_id: int) -> dict[str, Any] | None:
    return core.fetch_one(
        db_path, "SELECT * FROM showcase_games WHERE id = ?", (game_id,)
    )


def write_showcase_move(
    db_path: str,
    *,
    game_id: int,
    ply: int,
    action_index: int,
    usi_notation: str,
    board_json: str,
    hands_json: str,
    current_player: str,
    in_check: bool = False,
    value_estimate: float | None = None,
    top_candidates: str | None = None,
    move_heatmap_json: str | None = None,
    move_usi: str | None = None,
    move_time_ms: int | None = None,
) -> None:
    core.write_row(db_path, "showcase_moves", {
        "game_id": game_id, "ply": ply, "action_index": action_index,
        "usi_notation": usi_notation, "board_json": board_json,
        "hands_json": hands_json, "current_player": current_player,
        "in_check": int(in_check), "value_estimate": value_estimate,
        "top_candidates": top_candidates,
        "move_heatmap_json": move_heatmap_json, "move_usi": move_usi,
        "move_time_ms": move_time_ms, "created_at": _now(),
    }, replace=True)


def read_showcase_moves_since(
    db_path: str, game_id: int, since_ply: int
) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path,
        "SELECT * FROM showcase_moves WHERE game_id = ? AND ply > ? ORDER BY ply",
        (game_id, since_ply),
    )


def read_all_showcase_moves(db_path: str, game_id: int) -> list[dict[str, Any]]:
    return read_showcase_moves_since(db_path, game_id, -1)


def mark_game_completed(db_path: str, game_id: int, result: str, total_ply: int) -> None:
    core.execute(
        db_path,
        "UPDATE showcase_games SET status = ?, completed_at = ?, total_ply = ? "
        "WHERE id = ?",
        (result, _now(), total_ply, game_id),
    )


def mark_game_abandoned(db_path: str, game_id: int, reason: str) -> None:
    core.execute(
        db_path,
        "UPDATE showcase_games SET status = 'abandoned', abandon_reason = ?, "
        "completed_at = ? WHERE id = ?",
        (reason, _now(), game_id),
    )


def write_heartbeat(db_path: str, pid: int) -> None:
    core.write_row(db_path, "showcase_heartbeat", {
        "id": 1, "last_heartbeat": _now(), "runner_pid": pid,
    }, replace=True)


def read_heartbeat(db_path: str) -> dict[str, Any] | None:
    return core.fetch_one(db_path, "SELECT * FROM showcase_heartbeat WHERE id = 1")


def cleanup_orphaned_games(db_path: str, stale_after_s: float = 60.0) -> int:
    """Abandon in-progress games whose runner heartbeat went stale."""
    hb = read_heartbeat(db_path)
    if hb is not None:
        try:
            seen = datetime.datetime.strptime(
                hb["last_heartbeat"], "%Y-%m-%dT%H:%M:%SZ"
            ).replace(tzinfo=datetime.UTC)
            age = (datetime.datetime.now(datetime.UTC) - seen).total_seconds()
            if age < stale_after_s:
                return 0
        except (ValueError, TypeError):
            pass
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN IMMEDIATE")
        cur = conn.execute(
            "UPDATE showcase_games SET status = 'abandoned', "
            "abandon_reason = 'runner heartbeat stale', completed_at = ? "
            "WHERE status = 'in_progress'",
            (_now(),),
        )
        conn.execute(
            "UPDATE showcase_queue SET status = 'cancelled', completed_at = ? "
            "WHERE status = 'running'",
            (_now(),),
        )
        conn.commit()
        return cur.rowcount
    finally:
        conn.close()
