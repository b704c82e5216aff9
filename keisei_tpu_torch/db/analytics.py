"""Historical library and gauntlet tables: the part of the JAX package's
db/analytics.py that the league's maintenance writes and reads (the
port's own copy; game features, style profiles and tournament stats come
with the tournament).
"""

from __future__ import annotations

from typing import Any

from . import core


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
