"""SQLite schema (v8) — the observability tier's storage contract.

The port's own copy of keisei_tpu/db/schema.py: the DDL and SCHEMA_VERSION are
byte-identical (tests/test_torch_copies.py), so the JAX package's
dashboard reads a database the port wrote.

The DDL below is the **compatibility contract** with the reference framework
(reference: keisei/db/*.py DDL constants, keisei/db/__init__.py:57-115): the
reference's `keisei-serve` dashboard and Svelte WebUI read these exact tables
and columns, so a database produced by this framework renders in the
reference UI unchanged. Table families:

  metrics, game_snapshots, training_state          -- live training telemetry
  league_entries/results/transitions/meta,
  elo_history, head_to_head                        -- opponent league
  historical_library, gauntlet_results             -- milestone anchors
  tournament_stats, tournament_pairing_queue,
  tournament_worker_heartbeat                      -- tournament sidecars
  game_features, style_profiles                    -- behavioral analytics
  showcase_queue/games/moves/heartbeat             -- exhibition games

This package starts at schema v8 (no legacy deployments to migrate), but the
version row + registry hooks mirror the reference's guard semantics
(keisei/db/__init__.py:80-115): refuse to open a NEWER db, migrate an older.
"""

from __future__ import annotations

SCHEMA_VERSION = 8

DDL = """
CREATE TABLE IF NOT EXISTS schema_version (version INTEGER NOT NULL);

CREATE TABLE IF NOT EXISTS metrics (
    id                 INTEGER PRIMARY KEY AUTOINCREMENT,
    epoch              INTEGER NOT NULL,
    step               INTEGER NOT NULL,
    policy_loss        REAL,
    value_loss         REAL,
    entropy            REAL,
    win_rate           REAL,
    loss_rate          REAL,
    black_win_rate     REAL,
    white_win_rate     REAL,
    draw_rate          REAL,
    truncation_rate    REAL,
    avg_episode_length REAL,
    gradient_norm      REAL,
    episodes_completed INTEGER,
    timestamp          TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_metrics_epoch ON metrics(epoch);
CREATE INDEX IF NOT EXISTS idx_metrics_id ON metrics(id);

CREATE TABLE IF NOT EXISTS game_snapshots (
    game_id           INTEGER PRIMARY KEY,
    board_json        TEXT NOT NULL,
    hands_json        TEXT NOT NULL,
    current_player    TEXT NOT NULL,
    ply               INTEGER NOT NULL,
    is_over           INTEGER NOT NULL,
    result            TEXT NOT NULL,
    sfen              TEXT NOT NULL,
    in_check          INTEGER NOT NULL,
    move_history_json TEXT NOT NULL,
    value_estimate    REAL NOT NULL DEFAULT 0.0,
    game_type         TEXT NOT NULL DEFAULT 'live',
    demo_slot         INTEGER,
    opponent_id       INTEGER REFERENCES league_entries(id),
    updated_at        TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ', 'now'))
);

CREATE TABLE IF NOT EXISTS training_state (
    id               INTEGER PRIMARY KEY CHECK (id = 1),
    config_json      TEXT NOT NULL,
    display_name     TEXT NOT NULL,
    model_arch       TEXT NOT NULL,
    algorithm_name   TEXT NOT NULL,
    started_at       TEXT NOT NULL,
    current_epoch    INTEGER NOT NULL DEFAULT 0,
    current_step     INTEGER NOT NULL DEFAULT 0,
    checkpoint_path  TEXT,
    total_epochs     INTEGER,
    status           TEXT NOT NULL DEFAULT 'running',
    phase            TEXT NOT NULL DEFAULT 'init',
    heartbeat_at     TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now')),
    learner_entry_id INTEGER
);

CREATE TABLE IF NOT EXISTS league_entries (
    id              INTEGER PRIMARY KEY AUTOINCREMENT,
    display_name    TEXT NOT NULL DEFAULT '',
    flavour_facts   TEXT NOT NULL DEFAULT '[]',
    architecture    TEXT NOT NULL,
    model_params    TEXT NOT NULL,
    checkpoint_path TEXT NOT NULL,
    elo_rating      REAL NOT NULL DEFAULT 1000.0,
    created_epoch   INTEGER NOT NULL,
    games_played    INTEGER NOT NULL DEFAULT 0,
    created_at      TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now')),
    role            TEXT NOT NULL DEFAULT 'unassigned',
    status          TEXT NOT NULL DEFAULT 'active',
    parent_entry_id INTEGER REFERENCES league_entries(id),
    lineage_group   TEXT,
    protection_remaining INTEGER NOT NULL DEFAULT 0,
    last_match_at   TEXT,
    elo_frontier    REAL NOT NULL DEFAULT 1000.0,
    elo_dynamic     REAL NOT NULL DEFAULT 1000.0,
    elo_recent      REAL NOT NULL DEFAULT 1000.0,
    elo_historical  REAL NOT NULL DEFAULT 1000.0,
    optimizer_path  TEXT,
    update_count    INTEGER NOT NULL DEFAULT 0,
    last_train_at   TEXT,
    retired_at      TEXT,
    training_enabled INTEGER NOT NULL DEFAULT 1,
    games_vs_frontier INTEGER NOT NULL DEFAULT 0,
    games_vs_dynamic  INTEGER NOT NULL DEFAULT 0,
    games_vs_recent   INTEGER NOT NULL DEFAULT 0,
    dynamic_update_worker TEXT
);
CREATE INDEX IF NOT EXISTS idx_league_entries_elo ON league_entries(elo_rating);

CREATE TABLE IF NOT EXISTS league_results (
    id                  INTEGER PRIMARY KEY AUTOINCREMENT,
    epoch               INTEGER NOT NULL,
    entry_a_id          INTEGER NOT NULL REFERENCES league_entries(id),
    entry_b_id          INTEGER NOT NULL REFERENCES league_entries(id),
    match_type          TEXT NOT NULL,
    role_a              TEXT,
    role_b              TEXT,
    num_games           INTEGER NOT NULL,
    wins_a              INTEGER NOT NULL,
    wins_b              INTEGER NOT NULL,
    draws               INTEGER NOT NULL,
    elo_before_a        REAL,
    elo_after_a         REAL,
    elo_before_b        REAL,
    elo_after_b         REAL,
    training_updates_a  INTEGER,
    training_updates_b  INTEGER,
    recorded_at         TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_league_results_epoch ON league_results(epoch);
CREATE INDEX IF NOT EXISTS idx_league_results_entry_a ON league_results(entry_a_id);
CREATE INDEX IF NOT EXISTS idx_league_results_entry_b ON league_results(entry_b_id);

CREATE TABLE IF NOT EXISTS elo_history (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    entry_id    INTEGER NOT NULL REFERENCES league_entries(id),
    epoch       INTEGER NOT NULL,
    elo_rating  REAL NOT NULL,
    recorded_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_elo_history_entry ON elo_history(entry_id);
CREATE INDEX IF NOT EXISTS idx_elo_history_entry_epoch ON elo_history(entry_id, epoch);

CREATE TABLE IF NOT EXISTS league_transitions (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    entry_id    INTEGER NOT NULL REFERENCES league_entries(id),
    from_role   TEXT,
    to_role     TEXT,
    from_status TEXT,
    to_status   TEXT,
    reason      TEXT,
    created_at  TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_transitions_entry ON league_transitions(entry_id);

CREATE TABLE IF NOT EXISTS league_meta (
    id           INTEGER PRIMARY KEY CHECK (id = 1),
    bootstrapped INTEGER NOT NULL DEFAULT 0
);
INSERT OR IGNORE INTO league_meta (id, bootstrapped) VALUES (1, 0);

CREATE TABLE IF NOT EXISTS head_to_head (
    entry_a_id    INTEGER NOT NULL REFERENCES league_entries(id),
    entry_b_id    INTEGER NOT NULL REFERENCES league_entries(id),
    wins_a        INTEGER NOT NULL DEFAULT 0,
    wins_b        INTEGER NOT NULL DEFAULT 0,
    draws         INTEGER NOT NULL DEFAULT 0,
    games         INTEGER NOT NULL DEFAULT 0,
    last_epoch    INTEGER NOT NULL DEFAULT 0,
    updated_at    TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now')),
    PRIMARY KEY (entry_a_id, entry_b_id),
    CHECK (entry_a_id < entry_b_id)
);
CREATE INDEX IF NOT EXISTS idx_h2h_entry_a ON head_to_head(entry_a_id);
CREATE INDEX IF NOT EXISTS idx_h2h_entry_b ON head_to_head(entry_b_id);

CREATE TABLE IF NOT EXISTS historical_library (
    slot_index     INTEGER NOT NULL PRIMARY KEY,
    target_epoch   INTEGER NOT NULL,
    entry_id       INTEGER REFERENCES league_entries(id),
    actual_epoch   INTEGER,
    selected_at    TEXT NOT NULL,
    selection_mode TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS gauntlet_results (
    id                  INTEGER PRIMARY KEY AUTOINCREMENT,
    epoch               INTEGER NOT NULL,
    entry_id            INTEGER NOT NULL REFERENCES league_entries(id),
    historical_slot     INTEGER NOT NULL,
    historical_entry_id INTEGER NOT NULL REFERENCES league_entries(id),
    wins                INTEGER NOT NULL,
    losses              INTEGER NOT NULL,
    draws               INTEGER NOT NULL,
    elo_before          REAL,
    elo_after           REAL,
    created_at          TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_gauntlet_epoch ON gauntlet_results(epoch);

CREATE TABLE IF NOT EXISTS tournament_stats (
    id                  INTEGER PRIMARY KEY CHECK (id = 1),
    round_duration_s    REAL NOT NULL DEFAULT 0,
    pairings_requested  INTEGER NOT NULL DEFAULT 0,
    pairings_completed  INTEGER NOT NULL DEFAULT 0,
    total_games         INTEGER NOT NULL DEFAULT 0,
    total_plies         INTEGER NOT NULL DEFAULT 0,
    active_slots        INTEGER NOT NULL DEFAULT 0,
    model_load_time_s   REAL NOT NULL DEFAULT 0,
    model_load_count    INTEGER NOT NULL DEFAULT 0,
    games_per_min       REAL NOT NULL DEFAULT 0,
    updated_at          TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);

CREATE TABLE IF NOT EXISTS game_features (
    id                  INTEGER PRIMARY KEY AUTOINCREMENT,
    checkpoint_id       INTEGER NOT NULL REFERENCES league_entries(id),
    opponent_id         INTEGER NOT NULL REFERENCES league_entries(id),
    epoch               INTEGER NOT NULL,
    side                TEXT NOT NULL,
    result              TEXT NOT NULL,
    total_plies         INTEGER NOT NULL,
    first_action        INTEGER,
    opening_seq_3       TEXT,
    opening_seq_6       TEXT,
    rook_moved_ply      INTEGER,
    king_displacement_20 INTEGER NOT NULL DEFAULT 0,
    first_capture_ply   INTEGER,
    first_check_ply     INTEGER,
    first_drop_ply      INTEGER,
    num_checks          INTEGER NOT NULL DEFAULT 0,
    num_captures        INTEGER NOT NULL DEFAULT 0,
    num_drops           INTEGER NOT NULL DEFAULT 0,
    num_promotions      INTEGER NOT NULL DEFAULT 0,
    num_early_drops     INTEGER NOT NULL DEFAULT 0,
    rook_moves_in_20    INTEGER NOT NULL DEFAULT 0,
    king_moves_in_30    INTEGER NOT NULL DEFAULT 0,
    num_repetitions     INTEGER NOT NULL DEFAULT 0,
    termination_reason  INTEGER NOT NULL DEFAULT 0,
    created_at          TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);
CREATE INDEX IF NOT EXISTS idx_game_features_checkpoint ON game_features(checkpoint_id);
CREATE INDEX IF NOT EXISTS idx_game_features_opponent ON game_features(opponent_id);
CREATE INDEX IF NOT EXISTS idx_game_features_epoch ON game_features(epoch);

CREATE TABLE IF NOT EXISTS style_profiles (
    checkpoint_id       INTEGER PRIMARY KEY REFERENCES league_entries(id),
    recomputed_at       TEXT NOT NULL,
    profile_status      TEXT NOT NULL DEFAULT 'insufficient',
    games_sampled       INTEGER NOT NULL DEFAULT 0,
    raw_metrics_json    TEXT NOT NULL DEFAULT '{}',
    percentile_json     TEXT NOT NULL DEFAULT '{}',
    primary_style       TEXT,
    secondary_traits    TEXT NOT NULL DEFAULT '[]',
    commentary_json     TEXT NOT NULL DEFAULT '[]',
    updated_at          TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%SZ', 'now'))
);

CREATE TABLE IF NOT EXISTS showcase_queue (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    entry_id_1  TEXT NOT NULL,
    entry_id_2  TEXT NOT NULL,
    speed       TEXT NOT NULL DEFAULT 'normal',
    status      TEXT NOT NULL DEFAULT 'pending',
    requested_at TEXT NOT NULL,
    started_at  TEXT,
    completed_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_showcase_queue_status ON showcase_queue(status);
CREATE UNIQUE INDEX IF NOT EXISTS idx_showcase_queue_one_running
    ON showcase_queue(status) WHERE status = 'running';

CREATE TABLE IF NOT EXISTS showcase_games (
    id              INTEGER PRIMARY KEY AUTOINCREMENT,
    queue_id        INTEGER NOT NULL REFERENCES showcase_queue(id),
    entry_id_black  TEXT NOT NULL,
    entry_id_white  TEXT NOT NULL,
    elo_black       REAL,
    elo_white       REAL,
    name_black      TEXT,
    name_white      TEXT,
    status          TEXT NOT NULL DEFAULT 'in_progress',
    abandon_reason  TEXT,
    started_at      TEXT NOT NULL,
    completed_at    TEXT,
    total_ply       INTEGER DEFAULT 0
);
CREATE INDEX IF NOT EXISTS idx_showcase_games_status ON showcase_games(status);

CREATE TABLE IF NOT EXISTS showcase_moves (
    id              INTEGER PRIMARY KEY AUTOINCREMENT,
    game_id         INTEGER NOT NULL REFERENCES showcase_games(id),
    ply             INTEGER NOT NULL,
    action_index    INTEGER NOT NULL,
    usi_notation    TEXT NOT NULL,
    board_json      TEXT NOT NULL,
    hands_json      TEXT NOT NULL,
    current_player  TEXT NOT NULL,
    in_check        INTEGER NOT NULL DEFAULT 0,
    value_estimate  REAL,
    top_candidates  TEXT,
    move_heatmap_json TEXT,
    move_usi        TEXT,
    move_time_ms    INTEGER,
    created_at      TEXT NOT NULL,
    UNIQUE(game_id, ply)
);
CREATE INDEX IF NOT EXISTS idx_showcase_moves_game_ply ON showcase_moves(game_id, ply);

CREATE TABLE IF NOT EXISTS showcase_heartbeat (
    id              INTEGER PRIMARY KEY CHECK (id = 1),
    last_heartbeat  TEXT NOT NULL,
    runner_pid      INTEGER
);

CREATE TABLE IF NOT EXISTS tournament_pairing_queue (
    id             INTEGER PRIMARY KEY AUTOINCREMENT,
    round_id       INTEGER NOT NULL,
    entry_a_id     INTEGER NOT NULL REFERENCES league_entries(id),
    entry_b_id     INTEGER NOT NULL REFERENCES league_entries(id),
    games_target   INTEGER NOT NULL,
    status         TEXT NOT NULL DEFAULT 'pending',
    worker_id      TEXT,
    claimed_at     TEXT,
    completed_at   TEXT,
    enqueued_epoch INTEGER NOT NULL,
    priority       REAL NOT NULL DEFAULT 0.0
);
CREATE INDEX IF NOT EXISTS idx_pairing_queue_pending
    ON tournament_pairing_queue (status, priority DESC, id);
CREATE INDEX IF NOT EXISTS idx_pairing_queue_round
    ON tournament_pairing_queue (round_id);
CREATE INDEX IF NOT EXISTS idx_pairing_queue_staleness
    ON tournament_pairing_queue (status, enqueued_epoch);

CREATE TABLE IF NOT EXISTS tournament_worker_heartbeat (
    worker_id      TEXT PRIMARY KEY,
    pid            INTEGER NOT NULL,
    device         TEXT NOT NULL,
    last_seen      TEXT NOT NULL,
    pairings_done  INTEGER NOT NULL DEFAULT 0
);
"""
