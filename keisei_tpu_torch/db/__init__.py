"""SQLite observability DB, schema v8: the part the port's trainer, its
league and its tournament write and read.

The port's own copy of what keisei_tpu.training.observability, the league
and the tournament reach in keisei_tpu.db (schema.py, league_tables.py,
analytics.py and queue.py byte-identical; core.py and telemetry.py
trimmed to the functions the port calls), so a database the port writes
is read by the JAX package's dashboard and league unchanged. The pairing
queue is imported as `from ..db import queue`, as in the JAX package.
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
from .core import connect, init_db
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
    read_training_state,
    set_status,
    update_training_progress,
    write_epoch_summary,
    write_game_snapshots,
    write_training_state,
)

__all__ = [
    "SCHEMA_VERSION",
    "bump_head_to_head",
    "connect",
    "init_db",
    "read_all_game_features",
    "read_elo_history",
    "read_game_features_for_checkpoint",
    "read_head_to_head",
    "read_historical_slots",
    "read_league_data",
    "read_style_profiles",
    "read_tournament_stats",
    "read_training_state",
    "set_status",
    "update_training_progress",
    "write_elo_history",
    "write_epoch_summary",
    "write_game_features",
    "write_game_snapshots",
    "write_gauntlet_result",
    "write_historical_slot",
    "write_style_profile",
    "write_tournament_stats",
    "write_training_state",
    "write_transition",
]
