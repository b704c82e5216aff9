"""Connection management, schema init, and generic row helpers.

The port's own copy of the part of keisei_tpu/db/core.py that the training
observer and the league reach: WAL-mode connections with busy timeouts, idempotent
schema creation with a version guard, and dict -> row plumbing.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Any

from .schema import DDL, SCHEMA_VERSION


def connect(db_path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(db_path, check_same_thread=False)
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout = 5000")
    conn.execute("PRAGMA wal_autocheckpoint = 1000")
    conn.execute("PRAGMA foreign_keys = ON")
    conn.row_factory = sqlite3.Row
    return conn


def init_db(db_path: str) -> None:
    """Create all tables (idempotent) and stamp/verify the schema version."""
    parent = os.path.dirname(os.path.abspath(db_path))
    os.makedirs(parent, exist_ok=True)
    conn = connect(db_path)
    try:
        # fast path: a current-version DB needs no DDL — running the
        # CREATE TABLE script anyway takes write locks, which makes a
        # read-mostly attacher (the dashboard) queue behind a busy trainer
        try:
            row = conn.execute("SELECT version FROM schema_version").fetchone()
            if row and row[0] == SCHEMA_VERSION:
                return
        except sqlite3.Error:
            pass  # missing table: fresh/partial db — run the full DDL
        conn.executescript(DDL)
        row = conn.execute("SELECT version FROM schema_version").fetchone()
        version = row[0] if row else 0
        if version > SCHEMA_VERSION:
            raise RuntimeError(
                f"database schema v{version} is newer than supported "
                f"v{SCHEMA_VERSION}; upgrade the application or delete the db"
            )
        if row is None:
            conn.execute("INSERT INTO schema_version VALUES (?)", (SCHEMA_VERSION,))
        elif version < SCHEMA_VERSION:
            conn.execute("UPDATE schema_version SET version = ?", (SCHEMA_VERSION,))
        conn.commit()
    finally:
        conn.close()


def insert(
    conn: sqlite3.Connection,
    table: str,
    row: dict[str, Any],
    replace: bool = False,
) -> int:
    """Parameterized INSERT from a dict; returns lastrowid."""
    cols = list(row)
    verb = "INSERT OR REPLACE" if replace else "INSERT"
    sql = (
        f"{verb} INTO {table} ({', '.join(cols)}) "
        f"VALUES ({', '.join(':' + c for c in cols)})"
    )
    cur = conn.execute(sql, row)
    return int(cur.lastrowid or 0)


def write_row(db_path: str, table: str, row: dict[str, Any], replace: bool = False) -> int:
    conn = connect(db_path)
    try:
        rowid = insert(conn, table, row, replace=replace)
        conn.commit()
        return rowid
    finally:
        conn.close()


def fetch_all(db_path: str, sql: str, params: tuple = ()) -> list[dict[str, Any]]:
    conn = connect(db_path)
    try:
        return [dict(r) for r in conn.execute(sql, params).fetchall()]
    finally:
        conn.close()


def fetch_one(db_path: str, sql: str, params: tuple = ()) -> dict[str, Any] | None:
    conn = connect(db_path)
    try:
        row = conn.execute(sql, params).fetchone()
        return dict(row) if row else None
    finally:
        conn.close()


def execute(db_path: str, sql: str, params: tuple = ()) -> None:
    conn = connect(db_path)
    try:
        conn.execute(sql, params)
        conn.commit()
    finally:
        conn.close()


NOW_SEC = "strftime('%Y-%m-%dT%H:%M:%SZ', 'now')"
NOW_MS = "strftime('%Y-%m-%dT%H:%M:%fZ', 'now')"
