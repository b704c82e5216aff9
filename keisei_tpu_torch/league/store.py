"""OpponentStore: SQLite-backed pool of frozen model snapshots
(counterpart of keisei_tpu/league/store.py).

Each entry is a row in `league_entries` plus a per-entry directory under
`league_dir/<id>/` holding the model's state dict and, for Dynamic
entries, a persisted optimizer state. The SQLite side is the JAX
package's, statement for statement: a league.db the port writes is read
by `keisei_tpu.league.store` and `keisei_tpu.db` unchanged.

Weight I/O is `torch.save` / `torch.load(weights_only=True)` of state
dicts in place of Orbax trees. A weights directory (`weights`,
`weights-v<n>`) holds `state.pt` and the `keisei_meta.json` sidecar; the
versioned paths, the pointer swing after the write, the async flush
thread and `reconcile_update_counts` are kept as they are. Loaded and
cached tensors live on the store's device (the card unless the caller
names the CPU); `snapshot_dtype = "bfloat16"` trees stay bfloat16, and the
device LRU counts their bytes as they are.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import re
import shutil
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import torch

from .. import db
from ..db import core as dbcore
from ..db.league_tables import bump_head_to_head
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _cast_tree(tree: dict, dtype) -> dict:
    """Floating tensors cast to `dtype`; integer buffers as they are."""
    dt = _dtype(dtype)
    return {k: v.to(dt) if v.is_floating_point() else v for k, v in tree.items()}


class Role:
    """Entry roles (reference opponent_store.py:27-31)."""

    FRONTIER_STATIC = "frontier_static"
    RECENT_FIXED = "recent_fixed"
    DYNAMIC = "dynamic"
    UNASSIGNED = "unassigned"

    ALL = (FRONTIER_STATIC, RECENT_FIXED, DYNAMIC, UNASSIGNED)
    ELO_COLUMN = {
        FRONTIER_STATIC: "elo_frontier",
        RECENT_FIXED: "elo_recent",
        DYNAMIC: "elo_dynamic",
    }


class EntryStatus:
    ACTIVE = "active"
    RETIRED = "retired"
    # row allocated, weights still being written — invisible to every
    # reader (all list/count paths filter on 'active'); swept at trainer
    # startup by reconcile_update_counts if a crash stranded one
    MATERIALIZING = "materializing"


# Themed display names: deterministic per entry id (the reference draws from
# a 500-name pool with flavour facts, opponent_store.py:58-236; the exact
# names are cosmetic, the determinism is the behavior that matters).
_NAME_STEMS = (
    "Musashi", "Kotetsu", "Habu", "Tsume", "Anaguma", "Yagura", "Mino",
    "Kakugawari", "Ibisha", "Furibisha", "Tesuji", "Sabaki", "Atsumi",
    "Karui", "Osho", "Ryuo", "Kisei", "Meijin", "Oi", "Kio", "Tenryu",
    "Ginga", "Raiden", "Fujin", "Suisei", "Kagero", "Shiden", "Akatsuki",
    "Hayabusa", "Tsubame", "Arashi", "Kaminari", "Tsunami", "Sakura",
    "Momiji", "Fubuki", "Tsukikage", "Hoshizora", "Yamabiko", "Umineko",
)
_NAME_TITLES = (
    "the Patient", "the Sharp", "of the North", "the Wall", "Stormcaller",
    "the Quiet", "Edgewalker", "the Relentless", "of Nine Files",
    "the Unmoved", "Dragonside", "the Swift", "Ironhand", "Longsight",
)


def display_name_for(entry_id: int) -> str:
    # co-prime strides so consecutive ids vary BOTH stem and title
    # (id//len(stems) kept every early entry on title[0])
    stem = _NAME_STEMS[entry_id % len(_NAME_STEMS)]
    title = _NAME_TITLES[(entry_id * 5) % len(_NAME_TITLES)]
    return f"{stem} {title}"


def flavour_facts_for(entry_id: int, created_epoch: int) -> list[list[str]]:
    styles = ("aggressive openings", "patient endgames", "drop-heavy play",
              "castle-first strategy", "edge-pawn storms", "central control")
    return [
        ["Signature", styles[entry_id % len(styles)]],
        ["Hatched", f"epoch {created_epoch}"],
    ]


def compute_elo_update(
    rating_a: float, rating_b: float, result: float, k: float = 32.0
) -> tuple[float, float]:
    """Standard Elo; result is A's score in [0, 1]
    (opponent_store.py:308-331)."""
    expected_a = 1.0 / (1.0 + 10.0 ** ((rating_b - rating_a) / 400.0))
    new_a = rating_a + k * (result - expected_a)
    new_b = rating_b + k * ((1.0 - result) - (1.0 - expected_a))
    return new_a, new_b


def _now() -> str:
    return datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


@dataclass
class OpponentEntry:
    """Frozen snapshot metadata (reference opponent_store.py:240-305)."""

    id: int
    display_name: str
    architecture: str
    model_params: dict[str, Any]
    checkpoint_path: str
    elo_rating: float
    created_epoch: int
    games_played: int
    created_at: str
    flavour_facts: list = field(default_factory=list)
    role: str = Role.UNASSIGNED
    status: str = EntryStatus.ACTIVE
    parent_entry_id: int | None = None
    lineage_group: str | None = None
    protection_remaining: int = 0
    last_match_at: str | None = None
    elo_frontier: float = 1000.0
    elo_dynamic: float = 1000.0
    elo_recent: float = 1000.0
    elo_historical: float = 1000.0
    optimizer_path: str | None = None
    update_count: int = 0
    last_train_at: str | None = None
    retired_at: str | None = None
    training_enabled: bool = True
    games_vs_frontier: int = 0
    games_vs_dynamic: int = 0
    games_vs_recent: int = 0

    @classmethod
    def from_row(cls, row: dict[str, Any]) -> OpponentEntry:
        return cls(
            id=row["id"],
            display_name=row["display_name"],
            architecture=row["architecture"],
            model_params=json.loads(row["model_params"])
            if isinstance(row["model_params"], str) else row["model_params"],
            checkpoint_path=row["checkpoint_path"],
            elo_rating=row["elo_rating"],
            created_epoch=row["created_epoch"],
            games_played=row["games_played"],
            created_at=row["created_at"],
            flavour_facts=json.loads(row["flavour_facts"])
            if isinstance(row.get("flavour_facts"), str) else row.get("flavour_facts", []),
            role=row["role"],
            status=row["status"],
            parent_entry_id=row["parent_entry_id"],
            lineage_group=row["lineage_group"],
            protection_remaining=row["protection_remaining"],
            last_match_at=row["last_match_at"],
            elo_frontier=row["elo_frontier"],
            elo_dynamic=row["elo_dynamic"],
            elo_recent=row["elo_recent"],
            elo_historical=row["elo_historical"],
            optimizer_path=row["optimizer_path"],
            update_count=row["update_count"],
            last_train_at=row["last_train_at"],
            retired_at=row["retired_at"],
            training_enabled=bool(row["training_enabled"]),
            games_vs_frontier=row["games_vs_frontier"],
            games_vs_dynamic=row["games_vs_dynamic"],
            games_vs_recent=row["games_vs_recent"],
        )

    def role_elo(self, role: str) -> float:
        return {
            Role.FRONTIER_STATIC: self.elo_frontier,
            Role.RECENT_FIXED: self.elo_recent,
            Role.DYNAMIC: self.elo_dynamic,
        }.get(role, self.elo_rating)


class OpponentStore:
    """Thread-safe snapshot pool over the shared observability DB."""

    def __init__(self, db_path: str, league_dir: str, cache_size: int = 16,
                 cache_bytes: float | None = 3e9,
                 device: torch.device | str = "cuda"):
        # The BYTE budget is the binding limit: a count-only LRU grows
        # with the pool's fp32 natives. It must hold the pool's bf16
        # inference trees (~96 MB each at b40c256) plus a couple of fp32
        # natives; an evicted cohort member costs a disk load and an
        # upload. Natives are evicted before bf16 trees: bf16 is the hot
        # inference set, natives are only touched by dynamic updates.
        self.device = resolve_device(device)
        self.db_path = db_path
        self.league_dir = os.path.abspath(league_dir)
        os.makedirs(self.league_dir, exist_ok=True)
        db.init_db(db_path)
        self._lock = threading.RLock()
        self._cache: OrderedDict[tuple[int, int], Any] = OrderedDict()
        self._cache_size = cache_size
        self._cache_bytes = cache_bytes
        self._tree_bytes: dict[tuple, int] = {}
        # single-worker pool serializes async weight flushes in FIFO order
        # (last writer wins per path); created lazily so stores that never
        # flush asynchronously spawn no thread
        self._flush_pool = None
        self._flush_errors: list[Exception] = []
        # entry_id -> (count, path, variables, meta) generations whose
        # disk write was deferred (update_weights flush="defer")
        self._deferred_flushes: dict[int, tuple] = {}
        # entry_id -> (update_count, variables) for updates whose async
        # disk flush has not landed yet: cache misses MUST be served from
        # here, never from the (still-old) checkpoint_path, or an evicted
        # seed would silently re-cache stale weights under the new key
        self._pending_trees: dict[int, tuple[int, Any]] = {}

    @staticmethod
    def _weights_version(path: str | None) -> int:
        """Generation encoded in a committed weights path (0 for the
        initial unversioned `weights` dir written by add_entry)."""
        if not path:
            return 0
        m = re.search(r"weights-v(\d+)$", path)
        return int(m.group(1)) if m else 0

    def reconcile_update_counts(self) -> None:
        """Heal the bump-before-flush crash window at trainer startup.

        update_weights bumps update_count and then writes weights-v<count>
        (async: seconds later). A process death in between leaves the DB
        claiming a generation that never reached disk; every reader would
        then cache the OLD committed weights under the NEW (id, count) key
        forever. At startup, clamp update_count back to the version the
        committed checkpoint_path actually names.

        ONLY the process that owns dynamic updates (the trainer) may call
        this, and only before its first update: a sidecar reconciling
        against a LIVE trainer would clamp a bump whose async flush is
        simply still in flight.

        Also sweeps 'materializing' orphans: add_entry allocates the row
        before its (lock-free) weight write and flips it 'active' after;
        a crash in between strands a row no reader can see."""
        orphans = dbcore.fetch_all(
            self.db_path,
            "SELECT id FROM league_entries WHERE status = ?",
            (EntryStatus.MATERIALIZING,),
        )
        for row in orphans:
            logger.warning(
                "entry %d: stranded mid-add by a crash — sweeping", row["id"])
            dbcore.execute(
                self.db_path,
                "DELETE FROM league_entries WHERE id = ?", (row["id"],))
            shutil.rmtree(self._entry_dir(row["id"]), ignore_errors=True)
        rows = dbcore.fetch_all(
            self.db_path,
            "SELECT id, update_count, checkpoint_path FROM league_entries "
            "WHERE update_count > 0",
        )
        for row in rows:
            committed = self._weights_version(row["checkpoint_path"])
            if committed < row["update_count"]:
                logger.warning(
                    "entry %d: update_count=%d but committed weights are "
                    "v%d (flush lost in a crash) — reconciling to v%d",
                    row["id"], row["update_count"], committed, committed,
                )
                dbcore.execute(
                    self.db_path,
                    "UPDATE league_entries SET update_count = ? WHERE id = ?",
                    (committed, row["id"]),
                )

    # -- weights io ------------------------------------------------------------

    def _entry_dir(self, entry_id: int) -> str:
        return os.path.join(self.league_dir, str(entry_id))

    def _save_variables(self, path: str, variables: dict,
                        meta: dict | None = None) -> None:
        """state.pt (host tensors) and the keisei_meta.json sidecar (same
        name and shape as trainer checkpoints) into a fresh `path`; both
        land under temporary names and are renamed into place."""
        os.makedirs(path, exist_ok=True)
        host = {k: v.detach().cpu() for k, v in variables.items()}
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(host, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if meta is not None:
            tmp = os.path.join(path, "keisei_meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(path, "keisei_meta.json"))

    @staticmethod
    def _restore(path: str) -> dict:
        """The state dict under a weights directory, as host tensors of
        the dtypes they were saved in."""
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)

    def load_variables(self, entry: OpponentEntry, template: dict | None = None):
        """An entry's state dict, as host tensors (`template` is accepted
        for the reference's signature; a state dict needs none).

        Tolerates a stale snapshot: `entry` may have been fetched before
        one or more dynamic updates swung the entry's checkpoint_path, and
        the snapshot's path may since have been garbage-collected (flush GC
        keeps only the two newest generations). On a failed restore the
        CURRENT pointer is re-fetched from the DB and tried once — serving
        the newest committed weights beats failing a whole pairing over an
        opponent that trained mid-round."""
        return self._load_versioned(entry, template)[0]

    def _load_versioned(self, entry: OpponentEntry,
                        template: dict | None = None):
        """(variables, generation-actually-restored) — see load_variables.

        The version matters to the cache: between a trainer's update_count
        bump and its (async) flush landing, the DB names the NEW count but
        the OLD checkpoint_path. A reader in another process — which can
        never see this store's _pending_trees — must not cache what it
        restored under the new count, or it serves last generation's
        weights for the entire generation."""
        try:
            return (self._restore(entry.checkpoint_path),
                    self._weights_version(entry.checkpoint_path))
        except Exception:
            fresh = self.get_entry(entry.id)
            if fresh.checkpoint_path == entry.checkpoint_path:
                raise
            logger.warning(
                "entry %d: weights at %s are gone (superseded by v%d) — "
                "loading the current generation instead",
                entry.id, entry.checkpoint_path,
                self._weights_version(fresh.checkpoint_path),
            )
            return (self._restore(fresh.checkpoint_path),
                    self._weights_version(fresh.checkpoint_path))

    def load_variables_cached(self, entry: OpponentEntry,
                              template: dict | None = None, *, dtype=None):
        """LRU-cached state dict keyed by (id, update_count, dtype) so
        retrained Dynamic entries are re-read, on the store's device.

        dtype=torch.bfloat16 (or "bfloat16") serves a half-size tree for
        inference-only consumers (cohort stack, gauntlet): the model
        computes in bf16 regardless, so the pre-cast is action-identical
        while halving both device residency and upload bytes. Training
        consumers must use the default native tree. A bf16 request is
        satisfied by an on-device cast of the native cache entry when
        present, cheaper than a disk load."""
        tag = str(_dtype(dtype)).removeprefix("torch.") if dtype is not None else "native"
        key = (entry.id, entry.update_count, tag)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
            native = self._cache.get((entry.id, entry.update_count, "native"))
            if native is None:
                # an async flush for this generation may not have swung the
                # checkpoint_path pointer yet: disk would serve the OLD tree
                pend = self._pending_trees.get(entry.id)
                if pend is not None and pend[0] == entry.update_count:
                    native = pend[1]
        if native is not None:
            native = self._to_device(native)
            variables = _cast_tree(native, dtype) if dtype is not None else native
        else:
            host, got_version = self._load_versioned(entry, template)
            if got_version != entry.update_count:
                # the disk served a different generation than the DB counter
                # claims (bump landed, flush still in flight, possible only
                # across processes): cache under what was actually read
                key = (entry.id, got_version, tag)
            if dtype is not None:
                host = _cast_tree(host, dtype)  # on the host: half the upload
            variables = self._to_device(host)
        self._cache_put(key, variables)
        return variables

    def _to_device(self, tree: dict) -> dict:
        return {k: v.to(self.device) for k, v in tree.items()}

    @staticmethod
    def _tree_nbytes(tree: dict) -> int:
        return sum(v.numel() * v.element_size() for v in tree.values())

    def _cache_put(self, key: tuple, variables) -> None:
        """Insert into the device LRU, evicting past BOTH the entry-count
        cap and the byte budget (device memory is the scarce resource; see
        __init__). Eviction order: LRU natives first, then LRU overall — the
        bf16 inference set must survive (evicting it costs re-uploads)."""
        nbytes = self._tree_nbytes(variables)
        with self._lock:
            self._cache[key] = variables
            self._cache.move_to_end(key)
            self._tree_bytes[key] = nbytes

            def total():
                return sum(self._tree_bytes.get(k, 0) for k in self._cache)

            def over():
                return len(self._cache) > self._cache_size or (
                    self._cache_bytes is not None
                    and total() > self._cache_bytes
                )

            while len(self._cache) > 1 and over():
                victim = next(
                    (k for k in self._cache
                     if k[2] == "native" and k != key), None)
                if victim is None:
                    victim = next(k for k in self._cache if k != key)
                del self._cache[victim]
                self._tree_bytes.pop(victim, None)

    def save_optimizer(self, entry_id: int, opt_state: dict) -> str:
        path = os.path.join(self._entry_dir(entry_id), "optimizer")
        self._save_variables(path, opt_state)
        dbcore.execute(
            self.db_path,
            "UPDATE league_entries SET optimizer_path = ? WHERE id = ?",
            (path, entry_id),
        )
        return path

    def load_optimizer(self, entry: OpponentEntry, template=None):
        if not entry.optimizer_path or not os.path.isdir(entry.optimizer_path):
            return None
        return self._restore(entry.optimizer_path)

    # -- entry lifecycle ---------------------------------------------------------

    def add_entry(
        self,
        variables: dict,
        *,
        architecture: str,
        model_params: dict,
        created_epoch: int,
        role: str = Role.UNASSIGNED,
        parent_entry_id: int | None = None,
        lineage_group: str | None = None,
        protection_remaining: int = 0,
        elo_rating: float = 1000.0,
    ) -> OpponentEntry:
        """Snapshot `variables` into the pool. Weights land on disk before
        the row turns 'active'.

        The multi-second weight write happens OUTSIDE any DB transaction:
        the row is allocated 'materializing' in one short BEGIN IMMEDIATE,
        the 200+ MB tree is written with no lock held, and a second short
        transaction flips it 'active'. Holding the write lock across the
        save (the original shape) starved every other writer in the
        process past the 5 s busy_timeout — live telemetry snapshots and
        heartbeats failed with `database is locked` whenever the
        maintenance worker snapshotted the learner (found by the r3
        amortized-throughput run). Readers never see the intermediate row
        (all list/count paths filter status='active'); a crash mid-save
        leaves a 'materializing' orphan that reconcile_update_counts
        sweeps at next trainer startup."""
        entry_id = None
        with self._lock:
            try:
                conn = db.connect(self.db_path)
                try:
                    conn.execute("BEGIN IMMEDIATE")
                    cur = conn.execute(
                        "INSERT INTO league_entries (display_name, "
                        "architecture, model_params, checkpoint_path, "
                        "elo_rating, created_epoch, role, status, "
                        "parent_entry_id, lineage_group, "
                        "protection_remaining, flavour_facts) "
                        "VALUES ('', ?, ?, '', ?, ?, ?, 'materializing', "
                        "?, ?, ?, '[]')",
                        (architecture, json.dumps(model_params), elo_rating,
                         created_epoch, role, parent_entry_id, lineage_group,
                         protection_remaining),
                    )
                    entry_id = int(cur.lastrowid)
                    conn.commit()
                finally:
                    conn.close()

                weights_path = os.path.join(
                    self._entry_dir(entry_id), "weights")
                self._save_variables(weights_path, variables, meta={
                    "architecture": architecture,
                    "model_params": model_params,
                    "epoch": created_epoch,
                    "league_entry_id": entry_id,
                    "format_version": 1,
                })

                name = display_name_for(entry_id)
                facts = flavour_facts_for(entry_id, created_epoch)
                lineage = lineage_group or f"L{entry_id}"
                conn = db.connect(self.db_path)
                try:
                    conn.execute("BEGIN IMMEDIATE")
                    conn.execute(
                        "UPDATE league_entries SET checkpoint_path = ?, "
                        "display_name = ?, flavour_facts = ?, "
                        "lineage_group = ?, status = 'active' WHERE id = ?",
                        (weights_path, name, json.dumps(facts), lineage,
                         entry_id),
                    )
                    conn.commit()
                finally:
                    conn.close()
            except Exception:
                if entry_id is not None:
                    try:
                        dbcore.execute(
                            self.db_path,
                            "DELETE FROM league_entries WHERE id = ?",
                            (entry_id,),
                        )
                    except Exception:
                        logger.exception(
                            "entry %d: failed-add row cleanup also failed "
                            "(will be swept at next startup)", entry_id)
                    shutil.rmtree(self._entry_dir(entry_id),
                                  ignore_errors=True)
                raise
        logger.info("league: added entry %d (%s) role=%s", entry_id, name, role)
        return self.get_entry(entry_id)

    def clone_entry(self, source_id: int, *, role: str, created_epoch: int,
                    protection_remaining: int = 0) -> OpponentEntry:
        """Copy weights into a fresh entry (Dynamic promotion path,
        tier_managers.py DynamicManager.admit)."""
        src = self.get_entry(source_id)
        variables = self.load_variables(src)
        return self.add_entry(
            variables,
            architecture=src.architecture,
            model_params=src.model_params,
            created_epoch=created_epoch,
            role=role,
            parent_entry_id=source_id,
            lineage_group=src.lineage_group,
            protection_remaining=protection_remaining,
            elo_rating=src.elo_rating,
        )

    def get_entry(self, entry_id: int) -> OpponentEntry:
        row = dbcore.fetch_one(
            self.db_path, "SELECT * FROM league_entries WHERE id = ?", (entry_id,)
        )
        if row is None:
            raise KeyError(f"no league entry with id {entry_id}")
        return OpponentEntry.from_row(row)

    def list_entries(
        self, role: str | None = None, status: str = EntryStatus.ACTIVE
    ) -> list[OpponentEntry]:
        sql = "SELECT * FROM league_entries WHERE status = ?"
        params: list[Any] = [status]
        if role is not None:
            sql += " AND role = ?"
            params.append(role)
        sql += " ORDER BY elo_rating DESC"
        return [OpponentEntry.from_row(r)
                for r in dbcore.fetch_all(self.db_path, sql, tuple(params))]

    def list_by_role(self, role: str) -> list[OpponentEntry]:
        """Active entries of a role, oldest first (tier reviews rely on
        created_epoch ASC ordering)."""
        return [OpponentEntry.from_row(r) for r in dbcore.fetch_all(
            self.db_path,
            "SELECT * FROM league_entries WHERE status = 'active' AND role = ? "
            "ORDER BY created_epoch ASC, id ASC",
            (role,),
        )]

    def count_unique_opponents(self, entry_id: int) -> int:
        """Distinct opponents this entry has faced in either seat."""
        row = dbcore.fetch_one(
            self.db_path,
            "SELECT COUNT(DISTINCT opp) AS n FROM ("
            "  SELECT entry_b_id AS opp FROM league_results WHERE entry_a_id = ?"
            "  UNION ALL"
            "  SELECT entry_a_id AS opp FROM league_results WHERE entry_b_id = ?)",
            (entry_id, entry_id),
        )
        return row["n"] if row else 0

    def elo_spread(self, entry_id: int, window: int = 0) -> float:
        """Max - min Elo over the entry's last `window` history points
        (0 = lifetime); 0.0 with fewer than 2 points."""
        if window > 0:
            sql = ("SELECT elo_rating FROM ("
                   "SELECT elo_rating, id FROM elo_history WHERE entry_id = ? "
                   "ORDER BY id DESC LIMIT ?)")
            rows = dbcore.fetch_all(self.db_path, sql, (entry_id, window))
        else:
            rows = dbcore.fetch_all(
                self.db_path,
                "SELECT elo_rating FROM elo_history WHERE entry_id = ?",
                (entry_id,),
            )
        if len(rows) < 2:
            return 0.0
        vals = [r["elo_rating"] for r in rows]
        return max(vals) - min(vals)

    def update_role(self, entry_id: int, role: str, reason: str = "") -> None:
        with self._lock:
            old = self.get_entry(entry_id)
            dbcore.execute(
                self.db_path, "UPDATE league_entries SET role = ? WHERE id = ?",
                (role, entry_id),
            )
            db.write_transition(
                self.db_path, entry_id, from_role=old.role, to_role=role,
                reason=reason,
            )

    def retire_entry(self, entry_id: int, reason: str = "") -> None:
        with self._lock:
            old = self.get_entry(entry_id)
            dbcore.execute(
                self.db_path,
                "UPDATE league_entries SET status = 'retired', retired_at = ? "
                "WHERE id = ?",
                (_now(), entry_id),
            )
            db.write_transition(
                self.db_path, entry_id, from_status=old.status,
                to_status=EntryStatus.RETIRED, reason=reason,
            )

    def set_protection(self, entry_id: int, remaining: int) -> None:
        dbcore.execute(
            self.db_path,
            "UPDATE league_entries SET protection_remaining = ? WHERE id = ?",
            (remaining, entry_id),
        )

    def set_training_enabled(self, entry_id: int, enabled: bool) -> None:
        dbcore.execute(
            self.db_path,
            "UPDATE league_entries SET training_enabled = ? WHERE id = ?",
            (int(enabled), entry_id),
        )

    def bump_update_count(self, entry_id: int) -> None:
        dbcore.execute(
            self.db_path,
            "UPDATE league_entries SET update_count = update_count + 1, "
            "last_train_at = ? WHERE id = ?",
            (_now(), entry_id),
        )

    def update_weights(self, entry_id: int, variables: dict, *,
                       flush: str = "sync") -> None:
        """Overwrite a Dynamic entry's weights after online training.

        The new tree is installed into the device-resident LRU under the
        bumped (id, update_count) key, so the next cohort stack and the
        next dynamic update reuse it directly — no disk load + re-upload
        round trip for weights that never left the device (the reference
        keeps dynamic models GPU-resident between updates for the same
        reason, opponent_store.py:909-930).

        The disk write is crash-safe for concurrent readers: the new tree
        is saved into a fresh versioned directory (weights-v<count>) and
        only then does the DB checkpoint_path pointer swing to it, so a
        sidecar process reads either the old or the new committed tree —
        never a half-rewritten path. The superseded directory is removed
        after the swap.

        flush="async" moves that write onto a background thread: the
        update_count bump is immediate (in-process readers are served from
        the seeded cache), while sidecars keep reading the previous
        committed weights until the pointer swap lands a couple of seconds
        later. A failed async flush is logged and re-raised on the NEXT
        update_weights call (matching the trainer's circuit-breaker
        granularity); the pointer then still names the old consistent tree.

        flush="defer" skips the disk write entirely for THIS generation:
        the tree stays pinned in _pending_trees (in-process readers are
        current), the DB pointer keeps naming the last flushed
        generation, and the deferred tree is written either by a later
        non-deferred update or by wait_for_flushes() at teardown. The
        dynamic trainer defers intermediate generations because each
        flush is a full f32 tree copied off the device and written —
        cross-process readers lag by at most
        weight_flush_every generations (they already tolerate ~1-epoch
        staleness by design), and a crash loses only recent updates of an
        OPPONENT, not the learner.
        """
        entry = self.get_entry(entry_id)
        meta = {
            "architecture": entry.architecture,
            "model_params": entry.model_params,
            "epoch": entry.created_epoch,
            "league_entry_id": entry.id,
            "format_version": 1,
        }
        if flush in ("async", "defer"):
            # surface a prior failed flush BEFORE bumping: bump-then-raise
            # would mint a generation that exists nowhere (every reader
            # cache-misses and re-restores old weights under the new key).
            # Deferred updates mint generations too, so they hit the same
            # circuit breaker.
            with self._lock:
                if self._flush_errors:
                    err = self._flush_errors[:]
                    self._flush_errors.clear()
                    raise RuntimeError(
                        f"previous async weight flush failed: {err[0]}"
                    ) from err[0]
        # pin the new tree BEFORE the bump lands in the DB: a concurrent
        # in-process reader that observes the bumped count must find the
        # pin, or it would restore the stale checkpoint_path and cache it
        # under the new key for the whole generation. The count
        # is anticipated from the snapshot; bump_update_count is a serial
        # +1 per entry (updates to one entry are trainer-serialized), and
        # the post-bump check below repairs the pin if that ever drifts.
        new_count = entry.update_count + 1
        with self._lock:
            self._pending_trees[entry_id] = (new_count, variables)
        self.bump_update_count(entry_id)
        actual = self.get_entry(entry_id).update_count
        if actual != new_count:
            logger.warning(
                "entry %d: anticipated update_count %d but DB has %d "
                "(concurrent bump?) — repinning", entry_id, new_count, actual)
            new_count = actual
            with self._lock:
                self._pending_trees[entry_id] = (new_count, variables)
        new_path = os.path.join(self._entry_dir(entry_id),
                                f"weights-v{new_count}")
        if flush == "defer":
            # no disk IO this generation: the pin serves in-process
            # readers; wait_for_flushes()/the next non-deferred update
            # writes the newest tree (any older deferred one is obsolete).
            # Each deferred generation pins one device tree beyond the LRU
            # byte budget, so cap the outstanding set — the oldest entry's
            # tree spills to an async flush (which also unpins it).
            spill = None
            with self._lock:
                self._deferred_flushes[entry_id] = (new_count, new_path,
                                                    variables, meta)
                if len(self._deferred_flushes) > 4:
                    eid = next(iter(self._deferred_flushes))
                    spill = (eid, self._deferred_flushes.pop(eid))
                if spill is not None and self._flush_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._flush_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="league-flush")
            if spill is not None:
                eid, (cnt, pth, tree, m) = spill
                self._flush_pool.submit(
                    self._flush_job, eid, cnt, pth, tree, m)
        elif flush == "async":
            with self._lock:
                self._deferred_flushes.pop(entry_id, None)  # superseded
                if self._flush_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._flush_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="league-flush")
            self._flush_pool.submit(
                self._flush_job, entry_id, new_count, new_path, variables,
                meta)
        else:
            # keep the pin through the sync write too: if the save raises
            # AFTER the bump, readers of the new generation must still get
            # the new tree instead of silently re-caching the stale disk
            # weights under the new key
            with self._lock:
                self._deferred_flushes.pop(entry_id, None)  # superseded
            self._flush_job(entry_id, new_count, new_path, variables, meta,
                            reraise=True)
        self._cache_put((entry_id, new_count, "native"), self._to_device(variables))

    def _flush_job(self, entry_id: int, count: int, new_path: str,
                   variables: dict, meta: dict, reraise: bool = False) -> None:
        """Write weights to new_path, swing checkpoint_path, drop the
        superseded directory.

        Superseded directories are garbage-collected by version with a
        ONE-GENERATION grace: the previous committed tree is kept until the
        next flush lands. Readers holding a stale OpponentEntry snapshot
        (a tournament round that started before this update, a sidecar
        mid-restore) still resolve their one-generation-old
        checkpoint_path; deleting it immediately raced exactly those reads.
        load_variables additionally retries with a fresh DB pointer if its
        snapshot's path IS gone (two updates behind)."""
        try:
            self._save_variables(new_path, variables, meta=meta)
            dbcore.execute(
                self.db_path,
                "UPDATE league_entries SET checkpoint_path = ? WHERE id = ?",
                (new_path, entry_id),
            )
            # GC by version: keep this generation and the previous one
            entry_dir = self._entry_dir(entry_id)
            versions = []
            for name in os.listdir(entry_dir):
                if name == "weights" or re.fullmatch(r"weights-v\d+", name):
                    versions.append((self._weights_version(name), name))
            keep = {v for v, _ in sorted(versions)[-2:]}
            for v, name in versions:
                if v not in keep:
                    shutil.rmtree(os.path.join(entry_dir, name),
                                  ignore_errors=True)
            with self._lock:
                pend = self._pending_trees.get(entry_id)
                if pend is not None and pend[0] <= count:
                    del self._pending_trees[entry_id]
        except Exception as e:  # surfaced on the next update_weights call
            if reraise:
                raise
            # keep the pending tree: readers of this generation still get
            # the new weights even though the disk pointer lags
            logger.exception("async weight flush to %s failed", new_path)
            with self._lock:
                self._flush_errors.append(e)

    def wait_for_flushes(self) -> None:
        """Block until all queued async weight flushes have completed, then
        raise if any of them failed (call before shutdown / before handing
        the league dir to another process that must see the newest
        weights — exiting cleanly on a failed final flush would leave the
        DB pointer naming the previous generation while update_count claims
        newer weights exist). Deferred generations (flush="defer") are
        written here first, so the newest tree always lands on disk."""
        with self._lock:
            deferred = list(self._deferred_flushes.items())
            self._deferred_flushes.clear()
            if deferred and self._flush_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._flush_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="league-flush")
        for eid, (count, path, variables, meta) in deferred:
            self._flush_pool.submit(
                self._flush_job, eid, count, path, variables, meta)
        pool = self._flush_pool
        if pool is not None:
            # a no-op job flushes the FIFO queue
            pool.submit(lambda: None).result()
        with self._lock:
            if self._flush_errors:
                err = self._flush_errors[:]
                self._flush_errors.clear()
                raise RuntimeError(
                    f"{len(err)} async weight flush(es) failed; the on-disk "
                    f"weights lag the recorded update_count: {err[0]}"
                ) from err[0]

    # -- results + Elo -----------------------------------------------------------

    def record_result(
        self,
        entry_a_id: int,
        entry_b_id: int,
        *,
        epoch: int,
        wins_a: int,
        wins_b: int,
        draws: int,
        match_type: str = "tournament",
        k: float = 32.0,
        role_elo_k: dict[str, float] | None = None,
        elo_floor: float = 0.0,
    ) -> tuple[float, float]:
        """One transaction: league_results row + composite Elo (majority
        score) + per-role Elo + game counters + head_to_head
        (reference tournament.py:352-467 'majority-wins Elo').

        Returns the new composite ratings (a, b).
        """
        games = wins_a + wins_b + draws
        if games == 0:
            raise ValueError("record_result with zero games")
        majority = 1.0 if wins_a > wins_b else (0.0 if wins_b > wins_a else 0.5)
        with self._lock:
            conn = db.connect(self.db_path)
            try:
                conn.execute("BEGIN IMMEDIATE")
                row_a = conn.execute(
                    "SELECT * FROM league_entries WHERE id = ?", (entry_a_id,)
                ).fetchone()
                row_b = conn.execute(
                    "SELECT * FROM league_entries WHERE id = ?", (entry_b_id,)
                ).fetchone()
                a, b = OpponentEntry.from_row(dict(row_a)), OpponentEntry.from_row(dict(row_b))
                new_a, new_b = compute_elo_update(a.elo_rating, b.elo_rating, majority, k)
                # ratings never sink below the configured floor
                # (LeagueConfig.elo_floor, reference config.py:423)
                new_a, new_b = max(new_a, elo_floor), max(new_b, elo_floor)
                conn.execute(
                    "INSERT INTO league_results (epoch, entry_a_id, entry_b_id, "
                    "match_type, role_a, role_b, num_games, wins_a, wins_b, draws, "
                    "elo_before_a, elo_after_a, elo_before_b, elo_after_b) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    (epoch, entry_a_id, entry_b_id, match_type, a.role, b.role,
                     games, wins_a, wins_b, draws,
                     a.elo_rating, new_a, b.elo_rating, new_b),
                )
                now = _now()
                for eid, new_elo, opp_role, n_games in (
                    (entry_a_id, new_a, b.role, games),
                    (entry_b_id, new_b, a.role, games),
                ):
                    counter = {
                        Role.FRONTIER_STATIC: "games_vs_frontier",
                        Role.DYNAMIC: "games_vs_dynamic",
                        Role.RECENT_FIXED: "games_vs_recent",
                    }.get(opp_role)
                    extra = f", {counter} = {counter} + {n_games}" if counter else ""
                    conn.execute(
                        f"UPDATE league_entries SET elo_rating = ?, "
                        f"games_played = games_played + ?, last_match_at = ?, "
                        f"protection_remaining = MAX(protection_remaining - 1, 0)"
                        f"{extra} WHERE id = ?",
                        (new_elo, n_games, now, eid),
                    )
                # per-role Elo columns with per-context K factors
                # (role_elo.py:31-146; frontier 16 / dynamic 24 / recent 32)
                rk = role_elo_k or {Role.FRONTIER_STATIC: 16.0,
                                    Role.DYNAMIC: 24.0, Role.RECENT_FIXED: 32.0}
                for ent, opp, score in ((a, b, majority), (b, a, 1.0 - majority)):
                    col = Role.ELO_COLUMN.get(opp.role)
                    if col is None:
                        continue
                    cur_elo = getattr(ent, col)
                    opp_elo = opp.role_elo(ent.role)
                    upd, _ = compute_elo_update(
                        cur_elo, opp_elo, score, rk.get(opp.role, k)
                    )
                    upd = max(upd, elo_floor)
                    conn.execute(
                        f"UPDATE league_entries SET {col} = ? WHERE id = ?",
                        (upd, ent.id),
                    )
                bump_head_to_head(
                    conn, entry_a_id, entry_b_id, wins_a, wins_b, draws, epoch
                )
                for eid, elo in ((entry_a_id, new_a), (entry_b_id, new_b)):
                    conn.execute(
                        "INSERT INTO elo_history (entry_id, epoch, elo_rating) "
                        "VALUES (?, ?, ?)", (eid, epoch, elo),
                    )
                conn.commit()
            except Exception:
                conn.rollback()
                raise
            finally:
                conn.close()
        return new_a, new_b

    def carry_forward_elo(self, epoch: int) -> None:
        """Re-stamp every active entry's current Elo at this epoch so the
        dashboard chart has no gaps (opponent_store.py:1006+)."""
        conn = db.connect(self.db_path)
        try:
            conn.execute("BEGIN")
            conn.execute(
                "INSERT INTO elo_history (entry_id, epoch, elo_rating) "
                "SELECT id, ?, elo_rating FROM league_entries "
                "WHERE status = 'active'",
                (epoch,),
            )
            conn.commit()
        finally:
            conn.close()

    def pool_size(self) -> int:
        row = dbcore.fetch_one(
            self.db_path,
            "SELECT COUNT(*) AS n FROM league_entries WHERE status = 'active'",
        )
        return row["n"] if row else 0
