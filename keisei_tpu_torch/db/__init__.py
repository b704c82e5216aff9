"""SQLite observability DB, schema v8: the part the port's trainer writes.

The port's own copy of what keisei_tpu.training.observability calls in
keisei_tpu.db (schema.py byte-identical, core.py and telemetry.py trimmed
to the training writes), so a database the port writes is read by the JAX
package's dashboard unchanged.
"""

from .core import init_db
from .schema import SCHEMA_VERSION
from .telemetry import (
    set_status,
    update_training_progress,
    write_epoch_summary,
    write_game_snapshots,
    write_training_state,
)

__all__ = [
    "SCHEMA_VERSION",
    "init_db",
    "set_status",
    "update_training_progress",
    "write_epoch_summary",
    "write_game_snapshots",
    "write_training_state",
]
