"""Behavioral analytics + tournament stats tables.

game_features / style_profiles / tournament_stats / gauntlet_results /
historical_library helpers (reference: keisei/db/{game_features,
style_profiles,tournament,gauntlet,historical}.py).
"""

from __future__ import annotations

from typing import Any

from . import core

_FEATURE_COLS = (
    "checkpoint_id", "opponent_id", "epoch", "side", "result", "total_plies",
    "first_action", "opening_seq_3", "opening_seq_6", "rook_moved_ply",
    "king_displacement_20", "first_capture_ply", "first_check_ply",
    "first_drop_ply", "num_checks", "num_captures", "num_drops",
    "num_promotions", "num_early_drops", "rook_moves_in_20",
    "king_moves_in_30", "num_repetitions", "termination_reason",
)
_FEATURE_DEFAULTS = {
    "king_displacement_20": 0, "num_checks": 0, "num_captures": 0,
    "num_drops": 0, "num_promotions": 0, "num_early_drops": 0,
    "rook_moves_in_20": 0, "king_moves_in_30": 0, "num_repetitions": 0,
    "termination_reason": 0,
}


def write_game_features(db_path: str, rows: list[dict[str, Any]]) -> None:
    conn = core.connect(db_path)
    try:
        conn.execute("BEGIN")
        for feat in rows:
            row = {c: feat.get(c, _FEATURE_DEFAULTS.get(c)) for c in _FEATURE_COLS}
            core.insert(conn, "game_features", row)
        conn.commit()
    finally:
        conn.close()


def read_game_features_for_checkpoint(
    db_path: str, checkpoint_id: int, limit: int = 500
) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path,
        "SELECT * FROM game_features WHERE checkpoint_id = ? "
        "ORDER BY id DESC LIMIT ?",
        (checkpoint_id, limit),
    )


def read_all_game_features(db_path: str, limit: int = 5000) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path, "SELECT * FROM game_features ORDER BY id DESC LIMIT ?", (limit,)
    )


def write_style_profile(db_path: str, profile: dict[str, Any]) -> None:
    row = {
        "checkpoint_id": profile["checkpoint_id"],
        "recomputed_at": profile["recomputed_at"],
        "profile_status": profile.get("profile_status", "insufficient"),
        "games_sampled": profile.get("games_sampled", 0),
        "raw_metrics_json": profile.get("raw_metrics_json", "{}"),
        "percentile_json": profile.get("percentile_json", "{}"),
        "primary_style": profile.get("primary_style"),
        "secondary_traits": profile.get("secondary_traits", "[]"),
        "commentary_json": profile.get("commentary_json", "[]"),
    }
    core.write_row(db_path, "style_profiles", row, replace=True)


def read_style_profiles(db_path: str) -> list[dict[str, Any]]:
    return core.fetch_all(db_path, "SELECT * FROM style_profiles")


def write_tournament_stats(db_path: str, stats: dict[str, Any]) -> None:
    row = {"id": 1}
    for c in ("round_duration_s", "pairings_requested", "pairings_completed",
              "total_games", "total_plies", "active_slots",
              "model_load_time_s", "model_load_count", "games_per_min"):
        row[c] = stats.get(c, 0)
    core.write_row(db_path, "tournament_stats", row, replace=True)


def read_tournament_stats(db_path: str) -> dict[str, Any] | None:
    return core.fetch_one(db_path, "SELECT * FROM tournament_stats WHERE id = 1")


def write_gauntlet_result(db_path: str, row: dict[str, Any]) -> None:
    core.write_row(db_path, "gauntlet_results", {
        c: row[c] for c in ("epoch", "entry_id", "historical_slot",
                            "historical_entry_id", "wins", "losses", "draws",
                            "elo_before", "elo_after")
    })


def read_historical_slots(db_path: str) -> list[dict[str, Any]]:
    return core.fetch_all(
        db_path, "SELECT * FROM historical_library ORDER BY slot_index"
    )


def write_historical_slot(db_path: str, slot: dict[str, Any]) -> None:
    core.write_row(db_path, "historical_library", {
        "slot_index": slot["slot_index"],
        "target_epoch": slot["target_epoch"],
        "entry_id": slot.get("entry_id"),
        "actual_epoch": slot.get("actual_epoch"),
        "selected_at": slot["selected_at"],
        "selection_mode": slot["selection_mode"],
    }, replace=True)
