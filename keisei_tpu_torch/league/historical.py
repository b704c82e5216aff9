"""Historical milestone library + regression gauntlet.

Reference semantics (keisei/training/historical_library.py:40-220,
historical_gauntlet.py:21-220): five log-spaced milestone slots from epoch
1 to now, refreshed periodically with a two-pass snap-to-nearest (50%
proximity threshold, then backfill), slot re-pointing logged as
transitions; the gauntlet periodically plays the learner against each
milestone and updates ONLY the learner's `elo_historical` (anchors are
frozen — one-sided Elo).
"""

from __future__ import annotations

import datetime
import logging
import math

from .. import db
from ..db import core as dbcore
from .config import GauntletConfig, HistoricalLibraryConfig
from .match import ModelCache, make_match_runner
from .store import OpponentEntry, OpponentStore, compute_elo_update

logger = logging.getLogger(__name__)


class HistoricalLibrary:
    def __init__(self, store: OpponentStore, config: HistoricalLibraryConfig):
        self.store = store
        self.config = config

    def is_due_for_refresh(self, epoch: int) -> bool:
        if not self.config.enabled or epoch < self.config.min_epoch_for_selection:
            return False
        return epoch % self.config.refresh_interval_epochs == 0

    @staticmethod
    def compute_targets(current_epoch: int, num_slots: int = 5) -> list[int]:
        """Log-spaced epochs from 1 to current_epoch inclusive."""
        if num_slots == 1:
            return [max(current_epoch, 1)]
        e = max(current_epoch, 2)
        return [
            round(math.exp(math.log(e) * i / (num_slots - 1)))
            for i in range(num_slots)
        ]

    def _candidates(self) -> list[OpponentEntry]:
        """Fully-materialized entries, retired (stable) first, then by age.

        The status filter is structural, not incidental: add_entry inserts
        a 'materializing' row (blank checkpoint_path) before the multi-
        second weight save completes, and a milestone slot snapping onto
        that row would hand the gauntlet an unloadable path (and a failed
        add's cleanup DELETE would leave the slot dangling). Today the
        single maintenance thread happens to serialize refresh()/add_entry,
        but the invariant must hold at the query level."""
        rows = dbcore.fetch_all(
            self.store.db_path,
            "SELECT * FROM league_entries "
            "WHERE status IN ('active', 'retired') ORDER BY id",
        )
        entries = [OpponentEntry.from_row(r) for r in rows]
        entries.sort(key=lambda e: (0 if e.status == "retired" else 1,
                                    e.created_epoch))
        return entries

    @staticmethod
    def _snap(target: int, candidates, used: set[int]):
        best, best_d = None, float("inf")
        for c in candidates:
            if c.id in used:
                continue
            d = abs(c.created_epoch - target)
            if d < best_d:
                best, best_d = c, d
        return best

    def refresh(self, current_epoch: int) -> None:
        targets = self.compute_targets(current_epoch, self.config.slots)
        candidates = self._candidates()
        old = {s["slot_index"]: s["entry_id"]
               for s in db.read_historical_slots(self.store.db_path)}

        assignments: list[tuple[OpponentEntry, str] | None] = [None] * len(targets)
        if candidates:
            # neighbor spacing for the proximity threshold
            dists = []
            for i in range(len(targets)):
                left = targets[i] - targets[i - 1] if i > 0 else float("inf")
                right = targets[i + 1] - targets[i] if i < len(targets) - 1 else float("inf")
                dists.append(min(left, right))
            used: set[int] = set()
            enough = len(candidates) >= self.config.slots
            for i, t in enumerate(targets):  # pass 1: within threshold
                best = self._snap(t, candidates, used)
                if best is None:
                    continue
                thr = dists[i] * 0.5
                if thr == 0 or abs(best.created_epoch - t) > thr:
                    continue
                used.add(best.id)
                assignments[i] = (best, "log_spaced" if enough else "fallback")
            for i, t in enumerate(targets):  # pass 2: backfill
                if assignments[i] is not None:
                    continue
                best = self._snap(t, candidates, used)
                if best is None:
                    continue
                used.add(best.id)
                assignments[i] = (best, "fallback")

        for i, t in enumerate(targets):
            a = assignments[i]
            db.write_historical_slot(self.store.db_path, {
                "slot_index": i, "target_epoch": t,
                "entry_id": a[0].id if a else None,
                "actual_epoch": a[0].created_epoch if a else None,
                "selected_at": datetime.datetime.now(datetime.UTC).strftime(
                    "%Y-%m-%dT%H:%M:%SZ"),
                "selection_mode": a[1] if a else "fallback",
            })
            new_id = a[0].id if a else None
            if new_id != old.get(i) and (new_id is not None or old.get(i) is not None):
                db.write_transition(
                    self.store.db_path, new_id if new_id is not None else old[i],
                    reason=f"historical_slot_repointed slot={i} "
                           f"old={old.get(i)} new={new_id}",
                )

    def get_slots(self) -> list[dict]:
        return db.read_historical_slots(self.store.db_path)[: self.config.slots]


class HistoricalGauntlet:
    def __init__(
        self,
        store: OpponentStore,
        config: GauntletConfig,
        historical_k: float = 12.0,
        num_envs: int | None = None,
        max_ply: int = 512,
    ):
        self.store = store
        self.config = config
        self.historical_k = historical_k
        # one env per gauntlet game (games_per_matchup is the config knob)
        self.num_envs = num_envs if num_envs is not None else config.games_per_matchup
        self.max_ply = max_ply
        self._runners: dict[tuple, object] = {}
        self._models = ModelCache()

    def is_due(self, epoch: int) -> bool:
        return (self.config.enabled and epoch >= 1
                and epoch % self.config.interval_epochs == 0)

    def _runner(self, a: OpponentEntry, b: OpponentEntry):
        ma, ka = self._models.model_for(a)
        mb, kb = self._models.model_for(b)
        if (ka, kb) not in self._runners:
            self._runners[(ka, kb)] = make_match_runner(
                ma, mb, num_games=self.num_envs, max_ply=self.max_ply,
            )
        return self._runners[(ka, kb)]

    def run_gauntlet(self, epoch: int, learner_entry: OpponentEntry) -> int:
        """Learner vs each filled slot; updates elo_historical one-sided.
        Returns slots played."""
        slots = [s for s in db.read_historical_slots(self.store.db_path)
                 if s["entry_id"] is not None]
        if not slots:
            return 0
        played = 0
        for slot in slots:
            try:
                hist = self.store.get_entry(slot["entry_id"])
            except KeyError:
                continue
            try:
                runner = self._runner(learner_entry, hist)
                result = runner(
                    self.store.load_variables_cached(
                        learner_entry, dtype="bfloat16"),
                    self.store.load_variables_cached(hist, dtype="bfloat16"),
                    seed=epoch * 131 + slot["slot_index"],
                )
            except Exception:
                logger.exception("gauntlet slot %d failed", slot["slot_index"])
                continue
            if result.games == 0:
                continue
            learner = self.store.get_entry(learner_entry.id)
            elo_before = learner.elo_historical
            # one-sided: the anchor's rating is frozen (role_elo.py:31-146)
            new_elo, _ = compute_elo_update(
                elo_before, hist.elo_historical, result.score_a, self.historical_k
            )
            dbcore.execute(
                self.store.db_path,
                "UPDATE league_entries SET elo_historical = ? WHERE id = ?",
                (new_elo, learner.id),
            )
            db.write_gauntlet_result(self.store.db_path, {
                "epoch": epoch, "entry_id": learner.id,
                "historical_slot": slot["slot_index"],
                "historical_entry_id": hist.id,
                "wins": result.wins_a, "losses": result.wins_b,
                "draws": result.draws,
                "elo_before": elo_before, "elo_after": new_elo,
            })
            played += 1
        return played
