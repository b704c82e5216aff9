"""SQLite observability DB, schema v8: the part the port's trainer and its
league write and read.

The port's own copy of what keisei_tpu.training.observability and the
league reach in keisei_tpu.db (schema.py and league_tables.py
byte-identical; core.py, telemetry.py and analytics.py trimmed to the
functions the port calls), so a database the port writes is read by the
JAX package's dashboard and league unchanged.
"""

from .analytics import read_historical_slots, write_gauntlet_result, write_historical_slot
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
    "read_elo_history",
    "read_head_to_head",
    "read_historical_slots",
    "read_league_data",
    "read_training_state",
    "set_status",
    "update_training_progress",
    "write_elo_history",
    "write_epoch_summary",
    "write_game_snapshots",
    "write_gauntlet_result",
    "write_historical_slot",
    "write_training_state",
    "write_transition",
]
