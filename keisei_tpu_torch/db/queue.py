"""Tournament pairing queue + worker heartbeats — the cross-process bus.

SQLite WAL is the coordination layer between the training process (which
enqueues pairings) and out-of-process tournament workers (which claim and
play them); all claim operations are serialized with BEGIN IMMEDIATE so
concurrent workers never double-claim (reference:
keisei/db/tournament_queue.py:1-6, :113-231).
"""

from __future__ import annotations

import datetime
from typing import Any

from . import core


def _now() -> str:
    return datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


def enqueue_pairings(
    db_path: str,
    round_id: int,
    pairings: list[tuple[int, int, int, float]],
    epoch: int,
) -> int:
    """Insert (entry_a, entry_b, games_target, priority) rows as 'pending'."""
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN")
        for a, b, games, priority in pairings:
            core.insert(conn, "tournament_pairing_queue", {
                "round_id": round_id, "entry_a_id": a, "entry_b_id": b,
                "games_target": games, "priority": priority,
                "enqueued_epoch": epoch,
            })
        conn.commit()
        return len(pairings)
    finally:
        conn.close()


def claim_next_pairings_batch(
    db_path: str,
    worker_id: str,
    batch_size: int,
    stale_before_epoch: int | None = None,
) -> list[dict[str, Any]]:
    """Atomically claim up to batch_size pending pairings (priority order).

    One BEGIN IMMEDIATE transaction: optionally expire stale-epoch rows,
    select the top pending ids, flip them to 'playing' under this worker.
    """
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN IMMEDIATE")
        if stale_before_epoch is not None:
            conn.execute(
                "UPDATE tournament_pairing_queue SET status = 'expired' "
                "WHERE status = 'pending' AND enqueued_epoch < ?",
                (stale_before_epoch,),
            )
        ids = [r[0] for r in conn.execute(
            "SELECT id FROM tournament_pairing_queue WHERE status = 'pending' "
            "ORDER BY priority DESC, id LIMIT ?",
            (batch_size,),
        )]
        if ids:
            ph = ",".join("?" * len(ids))
            conn.execute(
                f"UPDATE tournament_pairing_queue "
                f"SET status = 'playing', worker_id = ?, claimed_at = ? "
                f"WHERE id IN ({ph}) AND status = 'pending'",
                [worker_id, _now(), *ids],
            )
        conn.commit()
        if not ids:
            return []
        ph = ",".join("?" * len(ids))
        return [dict(r) for r in conn.execute(
            f"SELECT * FROM tournament_pairing_queue WHERE id IN ({ph})", ids
        )]
    finally:
        conn.close()


def mark_pairing_done(db_path: str, pairing_id: int) -> None:
    core.execute(
        db_path,
        "UPDATE tournament_pairing_queue "
        "SET status = 'done', completed_at = ? WHERE id = ?",
        (_now(), pairing_id),
    )


def get_round_status(db_path: str, round_id: int) -> dict[str, int]:
    rows = core.fetch_all(
        db_path,
        "SELECT status, COUNT(*) AS n FROM tournament_pairing_queue "
        "WHERE round_id = ? GROUP BY status",
        (round_id,),
    )
    return {r["status"]: r["n"] for r in rows}


def get_active_queue_depth(db_path: str) -> int:
    row = core.fetch_one(
        db_path,
        "SELECT COUNT(*) AS n FROM tournament_pairing_queue "
        "WHERE status IN ('pending', 'playing')",
    )
    return row["n"] if row else 0


def reset_stale_playing(db_path: str, worker_id: str | None = None) -> int:
    """Return 'playing' claims to 'pending' (startup sweep after a crash)."""
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN IMMEDIATE")
        if worker_id is not None:
            cur = conn.execute(
                "UPDATE tournament_pairing_queue "
                "SET status = 'pending', worker_id = NULL, claimed_at = NULL "
                "WHERE status = 'playing' AND worker_id = ?",
                (worker_id,),
            )
        else:
            cur = conn.execute(
                "UPDATE tournament_pairing_queue "
                "SET status = 'pending', worker_id = NULL, claimed_at = NULL "
                "WHERE status = 'playing'",
            )
        conn.commit()
        return cur.rowcount
    finally:
        conn.close()


# --- worker heartbeats -------------------------------------------------------


def reclaim_dead_worker_claims(db_path: str, stale_after_s: float = 300.0,
                               exclude_worker: str | None = None) -> int:
    """Return 'playing' claims stranded by DEAD peers to 'pending'.

    A claim is stranded when its worker's heartbeat is older than
    `stale_after_s` or absent entirely (round-4 VERDICT #8: a worker
    SIGKILLed mid-round must not wedge its claimed pairings forever —
    reset_stale_playing only sweeps a worker's OWN claims at ITS restart).
    Live workers beat before every pairing (TournamentWorker), so their
    in-flight claims stay younger than any sane threshold; the default
    must exceed the slowest expected single pairing. `exclude_worker`
    guards the caller's own id (its beat may be a poll-interval old).
    Returns the number of claims reclaimed."""
    cutoff = (
        datetime.datetime.now(datetime.UTC)
        - datetime.timedelta(seconds=stale_after_s)
    ).strftime("%Y-%m-%dT%H:%M:%SZ")
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN IMMEDIATE")
        cur = conn.execute(
            "UPDATE tournament_pairing_queue "
            "SET status = 'pending', worker_id = NULL, claimed_at = NULL "
            "WHERE status = 'playing' AND (? IS NULL OR worker_id != ?) "
            "AND worker_id NOT IN ("
            "  SELECT worker_id FROM tournament_worker_heartbeat "
            "  WHERE last_seen >= ?)",
            (exclude_worker, exclude_worker, cutoff),
        )
        conn.commit()
        return cur.rowcount
    finally:
        conn.close()


def write_worker_heartbeat(
    db_path: str, worker_id: str, pid: int, device: str, pairings_done: int
) -> None:
    core.write_row(db_path, "tournament_worker_heartbeat", {
        "worker_id": worker_id, "pid": pid, "device": device,
        "last_seen": _now(), "pairings_done": pairings_done,
    }, replace=True)


def get_worker_health(db_path: str, stale_after_s: float = 60.0) -> list[dict[str, Any]]:
    """All workers with an `is_healthy` flag from heartbeat age."""
    rows = core.fetch_all(db_path, "SELECT * FROM tournament_worker_heartbeat")
    now = datetime.datetime.now(datetime.UTC)
    for r in rows:
        try:
            seen = datetime.datetime.strptime(
                r["last_seen"], "%Y-%m-%dT%H:%M:%SZ"
            ).replace(tzinfo=datetime.UTC)
            r["is_healthy"] = (now - seen).total_seconds() < stale_after_s
        except (ValueError, TypeError):
            r["is_healthy"] = False
    return rows


# --- cross-process dynamic-training lock --------------------------------------


def claim_dynamic_update(db_path: str, entry_id: int, worker_id: str) -> bool:
    """Take the per-entry dynamic-training lock (conditional UPDATE)."""
    conn = core.connect(db_path)
    try:
        cur = conn.execute(
            "UPDATE league_entries SET dynamic_update_worker = ? "
            "WHERE id = ? AND dynamic_update_worker IS NULL",
            (worker_id, entry_id),
        )
        conn.commit()
        return cur.rowcount == 1
    finally:
        conn.close()


def release_dynamic_update(db_path: str, entry_id: int, worker_id: str) -> None:
    core.execute(
        db_path,
        "UPDATE league_entries SET dynamic_update_worker = NULL "
        "WHERE id = ? AND dynamic_update_worker = ?",
        (entry_id, worker_id),
    )
