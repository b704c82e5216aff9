"""League table reads/writes shared by the opponent store and the server.

Read payload shapes match the reference dashboard's expectations
(keisei/db/league.py read_league_data/read_elo_history,
head_to_head.py read_head_to_head) so the reference WebUI renders them.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Any

from . import core

_ENTRY_COLS = (
    "id, display_name, flavour_facts, model_params, architecture, elo_rating, "
    "games_played, created_epoch, created_at, role, status, parent_entry_id, "
    "lineage_group, protection_remaining, last_match_at, elo_frontier, "
    "elo_dynamic, elo_recent, elo_historical, optimizer_path, update_count, "
    "last_train_at, games_vs_frontier, games_vs_dynamic, games_vs_recent"
)


def read_league_data(db_path: str, max_results: int = 500) -> dict[str, list[dict[str, Any]]]:
    """Entries + recent results + historical slots + gauntlet + transitions."""
    conn = core.connect(db_path)
    try:
        entries = []
        for r in conn.execute(
            # materializing = mid-add placeholder (blank name/path) — never
            # part of the dashboard payload; retired rows are intentional
            f"SELECT {_ENTRY_COLS} FROM league_entries "
            f"WHERE status != 'materializing' ORDER BY elo_rating DESC"
        ):
            e = dict(r)
            for json_col in ("flavour_facts", "model_params"):
                if isinstance(e.get(json_col), str):
                    e[json_col] = json.loads(e[json_col])
            entries.append(e)

        results = [dict(r) for r in conn.execute(
            "SELECT * FROM league_results ORDER BY id DESC LIMIT ?", (max_results,)
        )]
        historical = [dict(r) for r in conn.execute(
            "SELECT h.*, e.display_name AS entry_name, e.elo_rating AS entry_elo "
            "FROM historical_library h LEFT JOIN league_entries e "
            "ON h.entry_id = e.id ORDER BY h.slot_index"
        )]
        gauntlet = [dict(r) for r in conn.execute(
            "SELECT * FROM gauntlet_results WHERE epoch >= ("
            "  SELECT COALESCE(MIN(epoch), 0) FROM ("
            "    SELECT DISTINCT epoch FROM gauntlet_results "
            "    ORDER BY epoch DESC LIMIT 50)"
            ") ORDER BY epoch DESC, historical_slot"
        )]
        transitions = [dict(r) for r in conn.execute(
            "SELECT * FROM league_transitions ORDER BY id DESC LIMIT 200"
        )]
        return {
            "entries": entries,
            "results": results,
            "historical_library": historical,
            "gauntlet_results": gauntlet,
            "transitions": transitions,
        }
    finally:
        conn.close()


def read_elo_history(db_path: str, *, max_epochs: int = 0) -> list[dict[str, Any]]:
    if max_epochs > 0:
        return core.fetch_all(
            db_path,
            "SELECT entry_id, epoch, elo_rating FROM elo_history "
            "WHERE epoch >= (SELECT MAX(epoch) - ? FROM elo_history) "
            "ORDER BY epoch, entry_id",
            (max_epochs,),
        )
    return core.fetch_all(
        db_path,
        "SELECT entry_id, epoch, elo_rating FROM elo_history ORDER BY epoch, entry_id",
    )


def write_elo_history(db_path: str, entry_id: int, epoch: int, elo_rating: float) -> None:
    core.write_row(
        db_path, "elo_history",
        {"entry_id": entry_id, "epoch": epoch, "elo_rating": elo_rating},
    )


def read_head_to_head(db_path: str) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path,
        "SELECT entry_a_id, entry_b_id, wins_a, wins_b, draws, games, last_epoch "
        "FROM head_to_head ORDER BY games DESC, last_epoch DESC",
    )


def bump_head_to_head(
    conn: sqlite3.Connection,
    entry_a_id: int,
    entry_b_id: int,
    wins_a: int,
    wins_b: int,
    draws: int,
    epoch: int,
) -> None:
    """Incremental upsert in canonical (low id, high id) order; caller owns
    the transaction (used inside OpponentStore.record_result)."""
    if entry_a_id == entry_b_id:
        return
    if entry_a_id > entry_b_id:
        entry_a_id, entry_b_id = entry_b_id, entry_a_id
        wins_a, wins_b = wins_b, wins_a
    games = wins_a + wins_b + draws
    conn.execute(
        f"""INSERT INTO head_to_head
            (entry_a_id, entry_b_id, wins_a, wins_b, draws, games, last_epoch)
            VALUES (?, ?, ?, ?, ?, ?, ?)
            ON CONFLICT(entry_a_id, entry_b_id) DO UPDATE SET
              wins_a = wins_a + excluded.wins_a,
              wins_b = wins_b + excluded.wins_b,
              draws = draws + excluded.draws,
              games = games + excluded.games,
              last_epoch = MAX(last_epoch, excluded.last_epoch),
              updated_at = {core.NOW_SEC}""",
        (entry_a_id, entry_b_id, wins_a, wins_b, draws, games, epoch),
    )


def write_transition(
    db_path: str,
    entry_id: int,
    from_role: str | None = None,
    to_role: str | None = None,
    from_status: str | None = None,
    to_status: str | None = None,
    reason: str | None = None,
) -> None:
    core.write_row(db_path, "league_transitions", {
        "entry_id": entry_id, "from_role": from_role, "to_role": to_role,
        "from_status": from_status, "to_status": to_status, "reason": reason,
    })
