"""Tier managers: Frontier / RecentFixed / Dynamic + the TieredPool orchestrator.

Semantics pinned to the reference (keisei/training/tier_managers.py:36-511,
frontier_promoter.py:15-129, tiered_pool.py:28-328):

* Frontier Static — Elo-spread anchors; promotion of top-K-streak Dynamic
  entries after margin/tenure/lineage checks, one retirement per review.
* Recent Fixed — admits learner snapshots; the oldest entry is reviewed:
  PROMOTE (calibrated + Elo-qualified + stable), DELAY (under-calibrated,
  soft-overflow budget left), or RETIRE.
* Dynamic — receives promoted clones, evicts the weakest unprotected
  entry, lists trainable entries for online PPO.
"""

from __future__ import annotations

import logging

from .config import (
    DynamicConfig,
    FrontierStaticConfig,
    LeagueConfig,
    RecentFixedConfig,
)
from .store import EntryStatus, OpponentEntry, OpponentStore, Role

logger = logging.getLogger(__name__)

PROMOTE = "promote"
RETIRE = "retire"
DELAY = "delay"


class FrontierPromoter:
    """Top-K streak tracking for Dynamic -> Frontier promotion
    (frontier_promoter.py:15-129). Streaks are in-memory only; losing them
    on restart just delays promotion (conservative)."""

    def __init__(self, config: FrontierStaticConfig):
        self.config = config
        self._topk_since: dict[int, int] = {}  # entry_id -> epoch entered top-K

    def evaluate(
        self,
        dynamic_entries: list[OpponentEntry],
        frontier_entries: list[OpponentEntry],
        epoch: int,
    ) -> OpponentEntry | None:
        ranked = sorted(dynamic_entries, key=lambda e: e.elo_frontier, reverse=True)
        topk = ranked[: self.config.topk]
        topk_ids = {e.id for e in topk}
        for e in topk:
            self._topk_since.setdefault(e.id, epoch)
        for eid in [i for i in self._topk_since if i not in topk_ids]:
            del self._topk_since[eid]
        for e in topk:
            if self.should_promote(e, frontier_entries, epoch):
                return e
        return None

    def should_promote(
        self,
        candidate: OpponentEntry,
        frontier_entries: list[OpponentEntry],
        epoch: int,
    ) -> bool:
        if candidate.games_played < self.config.min_games_for_promotion:
            return False
        if not frontier_entries:
            return True  # seed an empty tier once calibrated
        since = self._topk_since.get(candidate.id)
        if since is None or epoch - since < self.config.streak_epochs:
            return False
        weakest = min(e.elo_frontier for e in frontier_entries)
        if candidate.elo_frontier < weakest + self.config.promotion_margin_elo:
            return False
        lineage = candidate.lineage_group or f"L{candidate.id}"
        overlap = sum(
            1 for e in frontier_entries
            if (e.lineage_group or f"L{e.parent_entry_id or e.id}") == lineage
        )
        return overlap < self.config.max_lineage_overlap


class FrontierManager:
    def __init__(self, store: OpponentStore, config: FrontierStaticConfig,
                 promoter: FrontierPromoter | None = None):
        self.store = store
        self.config = config
        self.promoter = promoter or FrontierPromoter(config)

    def get_active(self) -> list[OpponentEntry]:
        return self.store.list_by_role(Role.FRONTIER_STATIC)

    def is_due_for_review(self, epoch: int) -> bool:
        return epoch > 0 and epoch % self.config.review_interval_epochs == 0

    def select_initial(self, entries: list[OpponentEntry], count: int) -> list[OpponentEntry]:
        """Pick `count` entries spread evenly over the Elo range."""
        if count < 1:
            return []
        if len(entries) <= count:
            return list(entries)
        by_elo = sorted(entries, key=lambda e: e.elo_rating)
        n = len(by_elo)
        idxs = [n // 2] if count == 1 else [
            round(i * (n - 1) / (count - 1)) for i in range(count)
        ]
        return [by_elo[i] for i in idxs]

    def review(self, epoch: int) -> OpponentEntry | None:
        """Promote one qualified Dynamic entry, retiring one Frontier seat
        if at capacity. At most one promotion + one retirement per review."""
        dynamic = self.store.list_by_role(Role.DYNAMIC)
        frontier = self.get_active()
        candidate = self.promoter.evaluate(dynamic, frontier, epoch)
        if candidate is None:
            return None
        if len(frontier) >= self.config.slots:
            retired = self._retire_weakest_or_stalest(
                frontier, epoch, candidate_elo=candidate.elo_frontier
            )
            if retired is None:
                logger.info("frontier review: all entries under tenure, skipping")
                return None
        fresh = self.store.get_entry(candidate.id)
        if fresh.status != EntryStatus.ACTIVE:
            return None
        new_entry = self.store.clone_entry(
            candidate.id, role=Role.FRONTIER_STATIC, created_epoch=epoch
        )
        logger.info(
            "frontier promotion: dynamic %d -> frontier %d (elo %.1f)",
            candidate.id, new_entry.id, candidate.elo_rating,
        )
        return new_entry

    def _retire_weakest_or_stalest(
        self, frontier: list[OpponentEntry], epoch: int,
        candidate_elo: float | None = None,
    ) -> int | None:
        eligible = [
            e for e in frontier
            if e.created_epoch + self.config.min_tenure_epochs <= epoch
        ]
        if not eligible:
            return None
        tenure = self.config.min_tenure_epochs or 1
        if self.config.span_selection and candidate_elo is not None:
            # retire the seat closest in Elo to the incoming candidate,
            # with a mild staleness discount (preserves the spread, §6.1)
            def score(e):
                extra = max(0, (epoch - e.created_epoch) - tenure) / tenure
                return (abs(e.elo_frontier - candidate_elo) - extra * 5.0,
                        e.created_epoch)
            target = min(eligible, key=score)
        else:
            def score(e):
                extra = max(0, (epoch - e.created_epoch) - tenure) / tenure
                return (e.elo_frontier - extra * 25.0, e.created_epoch)
            target = min(eligible, key=score)
        self.store.retire_entry(target.id, reason=f"frontier seat replaced at epoch {epoch}")
        return target.id


class RecentFixedManager:
    def __init__(self, store: OpponentStore, config: RecentFixedConfig):
        self.store = store
        self.config = config
        self._weakest_elo_fn = None

    def set_weakest_elo_fn(self, fn) -> None:
        self._weakest_elo_fn = fn

    def count(self) -> int:
        return len(self.store.list_by_role(Role.RECENT_FIXED))

    def admit(self, variables: dict, arch: str, params: dict, epoch: int) -> OpponentEntry:
        return self.store.add_entry(
            variables, architecture=arch, model_params=params,
            created_epoch=epoch, role=Role.RECENT_FIXED,
        )

    def review_oldest(
        self, total_active_count: int | None = None
    ) -> tuple[str, OpponentEntry]:
        """PROMOTE / DELAY / RETIRE the oldest entry (tier_managers.py:277-371)."""
        entries = self.store.list_by_role(Role.RECENT_FIXED)
        if not entries:
            raise ValueError("review_oldest with empty Recent Fixed tier")
        oldest = entries[0]

        games_ok = oldest.games_played >= self.config.min_games_for_review
        min_opp = self.config.min_unique_opponents
        if total_active_count is not None:
            min_opp = min(min_opp, max(1, total_active_count - 1))
        opponents_ok = self.store.count_unique_opponents(oldest.id) >= min_opp

        floor = self._weakest_elo_fn() if self._weakest_elo_fn else None
        elo_ok = floor is None or (
            oldest.elo_rating >= floor - self.config.promotion_margin_elo
        )
        spread = self.store.elo_spread(oldest.id, window=self.config.spread_window)
        stable_ok = spread <= self.config.max_elo_spread

        if games_ok and opponents_ok and elo_ok and stable_ok:
            return PROMOTE, oldest
        overflow_used = self.count() - self.config.slots
        under_calibrated = not games_ok or not opponents_ok or not stable_ok
        if overflow_used <= self.config.soft_overflow and under_calibrated:
            return DELAY, oldest
        return RETIRE, oldest


class DynamicManager:
    def __init__(self, store: OpponentStore, config: DynamicConfig):
        self.store = store
        self.config = config

    def count(self) -> int:
        return len(self.store.list_by_role(Role.DYNAMIC))

    def is_full(self) -> bool:
        return self.count() >= self.config.slots

    def admit(
        self, source: OpponentEntry, epoch: int,
        promotion_candidate_ids: frozenset[int] = frozenset(),
    ) -> OpponentEntry | None:
        """Clone into Dynamic, evicting the weakest eligible first if full."""
        if self.is_full():
            if self.evict_weakest(protected_candidate_ids=promotion_candidate_ids) is None:
                logger.warning("dynamic admit: tier full, nothing evictable")
                return None
        entry = self.store.clone_entry(
            source.id, role=Role.DYNAMIC, created_epoch=epoch,
            protection_remaining=self.config.protection_matches,
        )
        return entry

    def evict_weakest(
        self,
        disabled_entry_ids: set[int] | None = None,
        protected_candidate_ids: frozenset[int] = frozenset(),
    ) -> OpponentEntry | None:
        disabled = disabled_entry_ids or set()
        eligible = [
            e for e in self.store.list_by_role(Role.DYNAMIC)
            if ((e.protection_remaining <= 0
                 and e.games_played >= self.config.min_games_before_eviction)
                or e.id in disabled)
            and e.id not in protected_candidate_ids
        ]
        if not eligible:
            return None
        weakest = min(eligible, key=lambda e: e.elo_dynamic)
        self.store.retire_entry(weakest.id, reason="evicted: weakest in dynamic tier")
        return weakest

    def get_trainable(self, disabled_entries: set[int] | None = None) -> list[OpponentEntry]:
        if not self.config.training_enabled:
            return []
        disabled = disabled_entries or set()
        return [
            e for e in self.store.list_by_role(Role.DYNAMIC)
            if e.id not in disabled and e.training_enabled
        ]

    def _eligible(self) -> list[OpponentEntry]:
        return [
            e for e in self.store.list_by_role(Role.DYNAMIC)
            if e.protection_remaining <= 0
            and e.games_played >= self.config.min_games_before_eviction
        ]

    def weakest_elo(self) -> float | None:
        el = self._eligible()
        return min(e.elo_rating for e in el) if el else None

    def weakest_dynamic_elo(self) -> float | None:
        el = self._eligible()
        return min(e.elo_dynamic for e in el) if el else None


class TieredPool:
    """Wires the three managers together (tiered_pool.py:28-328)."""

    def __init__(self, store: OpponentStore, config: LeagueConfig):
        self.store = store
        self.config = config
        self.promoter = FrontierPromoter(config.frontier)
        self.frontier = FrontierManager(store, config.frontier, self.promoter)
        self.recent = RecentFixedManager(store, config.recent)
        self.dynamic = DynamicManager(store, config.dynamic)
        self.recent.set_weakest_elo_fn(self.dynamic.weakest_dynamic_elo)

    def total_active(self) -> int:
        return self.store.pool_size()

    def snapshot_learner(self, variables: dict, arch: str, params: dict,
                         epoch: int) -> OpponentEntry:
        """Admit a learner snapshot to Recent Fixed, then resolve overflow:
        the oldest entry is promoted to Dynamic (clone), retired, or delayed
        (tiered_pool.py:109-198)."""
        entry = self.recent.admit(variables, arch, params, epoch)
        while self.recent.count() > self.config.recent.slots:
            outcome, oldest = self.recent.review_oldest(self.total_active())
            if outcome == PROMOTE:
                promoted = self.dynamic.admit(oldest, epoch)
                self.store.retire_entry(
                    oldest.id,
                    reason="promoted to dynamic" if promoted else
                    "retired (dynamic tier full)",
                )
            elif outcome == RETIRE:
                # review_oldest returns RETIRE (never DELAY) whenever the
                # tier is past slots + soft_overflow, so the hard cap is
                # enforced by this branch — DELAY implies count <= hard cap
                self.store.retire_entry(oldest.id, reason="recent-fixed review")
            else:  # DELAY — under-calibrated entry keeps its soft-overflow seat
                break
        self._enforce_pool_cap()
        return entry

    def _pool_cap(self) -> int:
        """max_active_entries overrides the derived tier-slot sum
        (tiered_pool.py:74-86)."""
        if self.config.max_active_entries is not None:
            return self.config.max_active_entries
        return (self.config.frontier.slots + self.config.recent.slots
                + self.config.dynamic.slots)

    def _enforce_pool_cap(self) -> None:
        """Whole-pool hard cap: retire the oldest Recent Fixed entries until
        the active count fits (tiered_pool.py:186-198)."""
        cap = self._pool_cap()
        while self.total_active() > cap:
            rf = sorted(self.store.list_by_role(Role.RECENT_FIXED),
                        key=lambda e: (e.created_epoch, e.id))
            if not rf:
                break
            oldest = rf[0]
            logger.info("hard cap: retiring Recent Fixed id=%d (pool %d/%d)",
                        oldest.id, self.total_active(), cap)
            self.store.retire_entry(
                oldest.id, reason="hard cap: pool exceeded max_active_entries")

    def maybe_review_frontier(self, epoch: int, force: bool = False) -> None:
        """Run a frontier review when due — or immediately with force=True.

        force is the Elo-ceiling alert's adaptive refresh (round-5
        post-mortem finding): with the default 250-epoch cadence the
        Frontier tier retired stale anchors faster than it promoted fresh
        ones, decaying to a single active anchor 400-600 Elo behind the
        learner. When the alert fires, the pool is told so outright —
        waiting out the calendar just starves the calibration signal. The
        promoter's own criteria (margin/tenure/lineage) still gate WHO
        gets promoted; force only skips the calendar."""
        if force or self.frontier.is_due_for_review(epoch):
            self.frontier.review(epoch)

    def bootstrap_from_flat_pool(self, epoch: int) -> None:
        """One-time role assignment for an unassigned pool: ~25% recent,
        ~25% frontier (Elo-spread), rest dynamic (tiered_pool.py:249-328)."""
        unassigned = self.store.list_by_role(Role.UNASSIGNED)
        if not unassigned:
            return
        n = len(unassigned)
        n_recent = max(1, n // 4)
        n_frontier = max(1, n // 4)
        by_epoch = sorted(unassigned, key=lambda e: e.created_epoch, reverse=True)
        recent_ids = {e.id for e in by_epoch[:n_recent]}
        rest = [e for e in unassigned if e.id not in recent_ids]
        frontier_sel = {e.id for e in self.frontier.select_initial(rest, n_frontier)}
        for e in unassigned:
            if e.id in recent_ids:
                role = Role.RECENT_FIXED
            elif e.id in frontier_sel:
                role = Role.FRONTIER_STATIC
            else:
                role = Role.DYNAMIC
            self.store.update_role(e.id, role, reason="bootstrap_from_flat_pool")
