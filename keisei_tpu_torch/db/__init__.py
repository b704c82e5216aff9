"""SQLite observability DB, schema v8: the port's own copy of keisei_tpu/db.

Every module here is a byte-identical copy of the JAX package's
(tests/test_torch_copies.py), so a database the port writes is read by
either package's dashboard and league, and the port's dashboard server
reads what either package wrote:

  schema.py        all DDL + SCHEMA_VERSION (the dashboard compat contract)
  core.py          connections, init_db, wal_checkpoint, generic row helpers
  telemetry.py     metrics / training_state+heartbeat / game_snapshots
  league_tables.py league entry/result/elo/h2h reads+writes
  analytics.py     game_features / style_profiles / tournament & gauntlet stats
  queue.py         tournament pairing queue + worker heartbeats
  showcase.py      showcase queue/games/moves/heartbeat

This file re-exports what the JAX package's db/__init__.py re-exports, with
the same statements; `queue` and `showcase` are imported as submodules
(`from ..db import showcase as sc`), as there.
"""

from .analytics import (
    read_all_game_features,
    read_game_features_for_checkpoint,
    read_historical_slots,
    read_style_profiles,
    read_tournament_stats,
    write_game_features,
    write_gauntlet_result,
    write_historical_slot,
    write_style_profile,
    write_tournament_stats,
)
from .core import connect, init_db, wal_checkpoint
from .league_tables import (
    bump_head_to_head,
    read_elo_history,
    read_head_to_head,
    read_league_data,
    write_elo_history,
    write_transition,
)
from .schema import SCHEMA_VERSION
from .telemetry import (
    read_game_snapshots,
    read_game_snapshots_since,
    read_metrics_since,
    read_metrics_tail,
    read_training_state,
    sum_episodes_completed,
    set_status,
    set_total_epochs,
    update_heartbeat,
    update_training_progress,
    write_epoch_summary,
    write_game_snapshots,
    write_metrics,
    write_training_state,
)

__all__ = [
    "SCHEMA_VERSION",
    "connect",
    "init_db",
    "wal_checkpoint",
    "write_metrics",
    "read_metrics_since",
    "read_metrics_tail",
    "sum_episodes_completed",
    "write_game_snapshots",
    "read_game_snapshots",
    "read_game_snapshots_since",
    "write_training_state",
    "read_training_state",
    "set_total_epochs",
    "set_status",
    "update_heartbeat",
    "update_training_progress",
    "write_epoch_summary",
    "read_league_data",
    "read_elo_history",
    "read_head_to_head",
    "bump_head_to_head",
    "write_elo_history",
    "write_transition",
    "write_tournament_stats",
    "read_tournament_stats",
    "write_game_features",
    "read_game_features_for_checkpoint",
    "read_all_game_features",
    "write_style_profile",
    "read_style_profiles",
    "write_gauntlet_result",
    "write_historical_slot",
    "read_historical_slots",
]
