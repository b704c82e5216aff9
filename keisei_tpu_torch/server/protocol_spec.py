"""Declarative WebSocket protocol contract for the dashboard.

This module is the single source of truth for the server<->UI wire protocol.
Both the conformance test suite (tests/test_ui_conformance.py) and the CI
conformance runner (scripts/ui_conformance.py) validate live server traffic
against these tables, so any drift between this server and the reference UI's
expectations fails loudly instead of rendering a blank panel.

Provenance (what pins what):
- Server->client message shapes: reference server emission sites
  (reference keisei/server/app.py:326-344 init, :380-401 training_status,
  :411-446 league_update, :437-446, :498-546 showcase command replies,
  :560-597 showcase polls) cross-checked against the reference client's reads
  (reference webui/src/lib/ws.js:95-222 handleMessage switch).
- Client->server commands: reference app.py:477-483 receiver dispatch.
- Row-level columns ride on the schema-v8 DDL compatibility contract
  (keisei_tpu/db/schema.py), because the reference readers are `SELECT *`
  pass-throughs (e.g. reference keisei/db/metrics.py:68).

Note one deliberate judgment call: `showcase_error` carries its text under
the key "error" — that is what the reference SERVER sends (app.py:498-513);
the reference client logs `msg.message` (ws.js:219), an internal
inconsistency on their side. We pin to the server, the authoritative half.
"""

from __future__ import annotations

# --- server -> client ------------------------------------------------------

# Message type -> keys that MUST be present (value may be null/empty but the
# key must exist, mirroring what ws.js destructures with `msg.<key> || ...`).
SERVER_MESSAGES: dict[str, frozenset[str]] = {
    # ws.js:97-120; app.py init emission
    "init": frozenset({
        "games", "metrics", "training_state",
        "league_entries", "league_results", "elo_history",
        "historical_library", "gauntlet_results", "transitions",
        "head_to_head", "tournament_stats", "style_profiles", "showcase",
    }),
    # ws.js:123-145
    "game_update": frozenset({"snapshots"}),
    # ws.js:147-149
    "metrics_update": frozenset({"rows"}),
    # ws.js:151-167 reads all of these off the message
    "training_status": frozenset({
        "status", "phase", "heartbeat_at", "epoch", "step", "episodes",
        "config_json", "display_name", "model_arch", "total_epochs",
        "system_stats", "learner_entry_id",
    }),
    # ws.js:169-180
    "league_update": frozenset({
        "entries", "results", "elo_history", "historical_library",
        "gauntlet_results", "transitions", "head_to_head",
        "tournament_stats", "style_profiles",
    }),
    # ws.js:182-205
    "showcase_update": frozenset({"game", "new_moves"}),
    # ws.js:207-216
    "showcase_status": frozenset({"queue", "sidecar_alive", "active_game_id"}),
    # reference app.py:498-546
    "showcase_error": frozenset({"error"}),
    "showcase_match_queued": frozenset({"entry_id_1", "entry_id_2", "speed"}),
    "showcase_speed_changed": frozenset({"queue_id", "speed"}),
    "showcase_match_cancelled": frozenset({"queue_id"}),
    # ws.js:222
    "ping": frozenset(),
}

# Keys inside the init "showcase" sub-object (ws.js:114-120).
INIT_SHOWCASE_KEYS = frozenset({"game", "moves", "queue", "sidecar_alive"})

# --- client -> server ------------------------------------------------------

# Command type -> required fields (reference app.py:477-483 + handlers).
CLIENT_COMMANDS: dict[str, frozenset[str]] = {
    "request_showcase_match": frozenset({"entry_id_1", "entry_id_2", "speed"}),
    "change_showcase_speed": frozenset({"queue_id", "speed"}),
    "cancel_showcase_match": frozenset({"queue_id"}),
    "pong": frozenset(),
}

VALID_SPEEDS = frozenset({"slow", "normal", "fast"})

# --- row-level contracts ---------------------------------------------------

# Fields the reference UI components actually dereference on individual rows.
# Weaker than full DDL equality on purpose: extra columns are always fine
# (ws.js spreads rows into stores), but a missing one of THESE breaks a view.
ROW_CONTRACTS: dict[str, frozenset[str]] = {
    # Board/EvalBar/MoveLog read these off each game snapshot
    # (ws.js:125-144 keys game_id/is_over; snapshot JSON from the trainer)
    "game_snapshot": frozenset({"game_id", "updated_at", "is_over"}),
    # MetricsChart series keys (webui stores/metrics.js)
    "metrics": frozenset({"id", "epoch", "step", "policy_loss"}),
    # LeagueTable / EntryDetail columns (elo_rating, not elo — schema v8)
    "league_entry": frozenset({
        "id", "display_name", "role", "status", "elo_rating", "games_played",
    }),
    "league_result": frozenset({"id"}),
    "elo_history": frozenset({"entry_id", "epoch", "elo_rating"}),
    "head_to_head": frozenset({"entry_a_id", "entry_b_id"}),
    "transition": frozenset({"id", "entry_id"}),
    # ShowcaseView move rows (ws.js:196-203 reads game_id and ply)
    "showcase_move": frozenset({"game_id", "ply"}),
    "showcase_queue": frozenset({"id", "status"}),
}


def validate_message(msg: dict) -> list[str]:
    """Return a list of contract violations for one server->client message.

    Empty list = conformant. Unknown message types are violations (the
    reference client would silently drop them, hiding bugs).
    """
    violations: list[str] = []
    mtype = msg.get("type")
    if mtype not in SERVER_MESSAGES:
        return [f"unknown message type: {mtype!r}"]
    missing = SERVER_MESSAGES[mtype] - msg.keys()
    if missing:
        violations.append(f"{mtype}: missing keys {sorted(missing)}")

    if mtype == "init":
        sc = msg.get("showcase")
        if isinstance(sc, dict):
            sc_missing = INIT_SHOWCASE_KEYS - sc.keys()
            if sc_missing:
                violations.append(
                    f"init.showcase: missing keys {sorted(sc_missing)}")
        elif sc is not None:
            violations.append("init.showcase: not an object")
        violations += _rows(msg.get("games"), "game_snapshot", "init.games")
        violations += _rows(msg.get("metrics"), "metrics", "init.metrics")
        violations += _rows(msg.get("league_entries"), "league_entry",
                            "init.league_entries")
        violations += _rows(msg.get("elo_history"), "elo_history",
                            "init.elo_history")
        violations += _rows(msg.get("head_to_head"), "head_to_head",
                            "init.head_to_head")
    elif mtype == "metrics_update":
        violations += _rows(msg.get("rows"), "metrics", "metrics_update.rows")
    elif mtype == "game_update":
        violations += _rows(msg.get("snapshots"), "game_snapshot",
                            "game_update.snapshots")
    elif mtype == "league_update":
        violations += _rows(msg.get("entries"), "league_entry",
                            "league_update.entries")
        violations += _rows(msg.get("elo_history"), "elo_history",
                            "league_update.elo_history")
    elif mtype == "showcase_update":
        violations += _rows(msg.get("new_moves"), "showcase_move",
                            "showcase_update.new_moves")
    elif mtype == "showcase_status":
        violations += _rows(msg.get("queue"), "showcase_queue",
                            "showcase_status.queue")
    return violations


def _rows(rows, contract: str, where: str) -> list[str]:
    if not isinstance(rows, list):
        return [f"{where}: not a list"] if rows is not None else []
    required = ROW_CONTRACTS[contract]
    out = []
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            out.append(f"{where}[{i}]: not an object")
            continue
        missing = required - row.keys()
        if missing:
            out.append(f"{where}[{i}]: missing {sorted(missing)}")
    return out
