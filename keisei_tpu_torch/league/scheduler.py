"""Match scheduling: class taxonomy, priority scoring, round generation.

Semantics pinned to the reference (keisei/training/match_scheduler.py:25-463,
priority_scorer.py:13-130): training vs calibration match classes, learner
tier sampling at 50/30/20 with challenge-threshold down-weighting of
mastered tiers, priority = under-sample + uncertainty + recent-fixed +
lineage diversity + match-class + frontier exposure − repeat − lineage
closeness, and full/weighted/random round generation with minimum-coverage
enforcement.
"""

from __future__ import annotations

import random
from collections import Counter, deque

from .config import MatchSchedulerConfig, PriorityScorerConfig
from .store import OpponentEntry, Role

# --- match classes (§8.2) ------------------------------------------------------

DYNAMIC_VS_DYNAMIC = "dynamic_vs_dynamic"
DYNAMIC_VS_RECENT = "dynamic_vs_recent"
DYNAMIC_VS_FRONTIER = "dynamic_vs_frontier"
RECENT_VS_FRONTIER = "recent_vs_frontier"
RECENT_VS_RECENT = "recent_vs_recent"
FRONTIER_VS_FRONTIER = "frontier_vs_frontier"
OTHER = "other"

TRAINING_CLASSES = frozenset({DYNAMIC_VS_DYNAMIC, DYNAMIC_VS_RECENT})

_CLASS_BY_ROLES = {
    frozenset({Role.DYNAMIC}): DYNAMIC_VS_DYNAMIC,
    frozenset({Role.DYNAMIC, Role.RECENT_FIXED}): DYNAMIC_VS_RECENT,
    frozenset({Role.DYNAMIC, Role.FRONTIER_STATIC}): DYNAMIC_VS_FRONTIER,
    frozenset({Role.RECENT_FIXED, Role.FRONTIER_STATIC}): RECENT_VS_FRONTIER,
    frozenset({Role.RECENT_FIXED}): RECENT_VS_RECENT,
    frozenset({Role.FRONTIER_STATIC}): FRONTIER_VS_FRONTIER,
}


def classify_match(a: OpponentEntry, b: OpponentEntry) -> str:
    return _CLASS_BY_ROLES.get(frozenset({a.role, b.role}), OTHER)


def is_training_match(a: OpponentEntry, b: OpponentEntry) -> bool:
    """Training matches feed Dynamic-entry online PPO (§10.1)."""
    return classify_match(a, b) in TRAINING_CLASSES


def build_match_class_weights(cfg: MatchSchedulerConfig) -> dict[str, float]:
    return {
        DYNAMIC_VS_DYNAMIC: cfg.dynamic_dynamic_weight,
        DYNAMIC_VS_RECENT: cfg.dynamic_recent_weight,
        DYNAMIC_VS_FRONTIER: cfg.dynamic_frontier_weight,
        RECENT_VS_FRONTIER: cfg.recent_frontier_weight,
        RECENT_VS_RECENT: cfg.recent_recent_weight,
        FRONTIER_VS_FRONTIER: 0.0,
        OTHER: 0.0,
    }


# --- priority scorer -----------------------------------------------------------


class PriorityScorer:
    """Higher score = more informative pairing, play it first
    (priority_scorer.py:49-121)."""

    def __init__(self, config: PriorityScorerConfig,
                 match_class_weights: dict[str, float] | None = None):
        self.config = config
        self._weights = match_class_weights or build_match_class_weights(
            MatchSchedulerConfig()
        )
        self._pair_games: Counter[tuple[int, int]] = Counter()
        self._round_history: deque[set[tuple[int, int]]] = deque(
            maxlen=config.repeat_window_rounds
        )
        self._current_round: set[tuple[int, int]] = set()

    @staticmethod
    def _key(a: int, b: int) -> tuple[int, int]:
        return (a, b) if a < b else (b, a)

    def record_result(self, id_a: int, id_b: int) -> None:
        self._pair_games[self._key(id_a, id_b)] += 1

    def record_round_result(self, id_a: int, id_b: int) -> None:
        self._current_round.add(self._key(id_a, id_b))

    def advance_round(self) -> None:
        self._round_history.append(self._current_round)
        self._current_round = set()

    def score(self, a: OpponentEntry, b: OpponentEntry) -> float:
        c = self.config
        key = self._key(a.id, b.id)
        # 1/(games+1): an unplayed pair outranks a once-played pair
        under_sample = 1.0 / (self._pair_games[key] + 1)
        uncertainty = 1.0 if abs(a.elo_rating - b.elo_rating) < 100 else 0.0
        has_recent = 1.0 if Role.RECENT_FIXED in (a.role, b.role) else 0.0
        if a.lineage_group is None or b.lineage_group is None:
            diversity = 1.0  # optimistic default for untracked lineage
        else:
            diversity = 0.0 if a.lineage_group == b.lineage_group else 1.0
        mc = self._weights.get(classify_match(a, b), 0.0)
        exposure = 0.0
        thr = c.frontier_exposure_threshold
        for d, f in ((a, b), (b, a)):
            if d.role == Role.DYNAMIC and f.role == Role.FRONTIER_STATIC:
                exposure = 1.0 if d.games_vs_frontier < thr else 0.0
        repeats = sum(1 for r in self._round_history if key in r)
        if a.parent_entry_id == b.id or b.parent_entry_id == a.id:
            closeness = 1.0
        elif a.lineage_group is not None and a.lineage_group == b.lineage_group:
            closeness = 0.5
        else:
            closeness = 0.0
        return (
            c.under_sample_weight * under_sample
            + c.uncertainty_weight * uncertainty
            + c.recent_fixed_bonus * has_recent
            + c.diversity_weight * diversity
            + c.match_class_weight * mc
            + c.frontier_exposure_weight * exposure
            + c.repeat_penalty * repeats
            + c.lineage_penalty * closeness
        )

    def sort_by_priority(self, pairings):
        return sorted(pairings, key=lambda p: self.score(*p), reverse=True)


# --- scheduler -----------------------------------------------------------------


class MatchScheduler:
    def __init__(self, config: MatchSchedulerConfig,
                 priority_scorer: PriorityScorer | None = None,
                 rng: random.Random | None = None):
        self.config = config
        self.scorer = priority_scorer
        self.match_class_weights = build_match_class_weights(config)
        self._rng = rng or random.Random()
        self._tier_outcomes: dict[str, deque[bool]] = {
            role: deque(maxlen=config.challenge_window)
            for role in (Role.DYNAMIC, Role.FRONTIER_STATIC, Role.RECENT_FIXED)
        }

    # -- learner opponent sampling -------------------------------------------

    def record_learner_result(self, opponent_role: str, won: bool) -> None:
        if opponent_role in self._tier_outcomes:
            self._tier_outcomes[opponent_role].append(won)

    def tier_win_rate(self, role: str) -> float | None:
        o = self._tier_outcomes.get(role)
        if not o or len(o) < 10:
            return None
        return sum(o) / len(o)

    def effective_ratios(self, entries_by_role: dict) -> dict[str, float]:
        """50/30/20 tier mix, mastered tiers (win rate > challenge_threshold)
        halved, renormalized over non-empty tiers."""
        raw = {
            Role.DYNAMIC: self.config.learner_dynamic_ratio,
            Role.FRONTIER_STATIC: self.config.learner_frontier_ratio,
            Role.RECENT_FIXED: self.config.learner_recent_ratio,
        }
        non_empty = {r: w for r, w in raw.items() if entries_by_role.get(r)}
        if not non_empty:
            return {r: 0.0 for r in raw}
        for role in list(non_empty):
            wr = self.tier_win_rate(role)
            if wr is not None and wr > self.config.challenge_threshold:
                non_empty[role] *= 0.5
        total = sum(non_empty.values())
        if total <= 0:
            return {r: 0.0 for r in raw}
        return {r: (non_empty.get(r, 0.0) / total) for r in raw}

    def sample_for_learner(self, entries_by_role: dict) -> OpponentEntry:
        ratios = self.effective_ratios(entries_by_role)
        non_empty = {r: w for r, w in ratios.items() if w > 0}
        if not non_empty:
            raise ValueError("no entries available in any tier")
        roles = list(non_empty)
        role = self._rng.choices(roles, weights=[non_empty[r] for r in roles])[0]
        return self._rng.choice(entries_by_role[role])

    def sample_k_for_learner(self, entries_by_role: dict, k: int) -> list[OpponentEntry]:
        """K distinct opponents, role-weighted without replacement
        (match_scheduler.py:154-213)."""
        if k <= 0:
            return []
        total = sum(len(v) for v in entries_by_role.values())
        if total == 0:
            raise ValueError("no entries available in any tier")
        if k >= total:
            return [e for v in entries_by_role.values() for e in v]
        remaining = {r: list(v) for r, v in entries_by_role.items()}
        out: list[OpponentEntry] = []
        while len(out) < k:
            ratios = self.effective_ratios(remaining)
            non_empty = {r: w for r, w in ratios.items() if w > 0 and remaining.get(r)}
            if not non_empty:
                flat = [e for v in remaining.values() for e in v]
                if not flat:
                    break
                pick = flat[self._rng.randrange(len(flat))]
                out.append(pick)
                for v in remaining.values():
                    if pick in v:
                        v.remove(pick)
                        break
                continue
            roles = list(non_empty)
            role = self._rng.choices(roles, weights=[non_empty[r] for r in roles])[0]
            out.append(remaining[role].pop(self._rng.randrange(len(remaining[role]))))
        return out

    # -- round generation ------------------------------------------------------

    @staticmethod
    def _all_pairs(entries):
        return [
            (entries[i], entries[j])
            for i in range(len(entries))
            for j in range(i + 1, len(entries))
        ]

    def generate_round(self, entries) -> list[tuple[OpponentEntry, OpponentEntry]]:
        mode = self.config.tournament_mode
        pairs = self._all_pairs(entries)
        if mode == "random":
            self._rng.shuffle(pairs)
            return pairs
        if mode == "full":
            if self.scorer is not None:
                return self.scorer.sort_by_priority(pairs)
            self._rng.shuffle(pairs)
            return pairs
        return self._weighted_sample(entries, pairs)

    def _weighted_sample(self, entries, all_pairs):
        if not all_pairs:
            return []
        buckets: dict[str, list] = {}
        for p in all_pairs:
            buckets.setdefault(classify_match(*p), []).append(p)
        round_size = self.config.weighted_round_size or len(entries)
        present = {mc for mc in buckets if self.match_class_weights.get(mc, 0) > 0}
        if not present:
            self._rng.shuffle(all_pairs)
            return all_pairs[:round_size]
        total_w = sum(self.match_class_weights[mc] for mc in present)
        selected = []
        for mc in present:
            pool = buckets[mc]
            if self.scorer is not None:
                pool = self.scorer.sort_by_priority(pool)
            else:
                self._rng.shuffle(pool)
            share = max(1, round(round_size * self.match_class_weights[mc] / total_w))
            selected.extend(pool[:share])
        if self.scorer is not None:
            selected = self.scorer.sort_by_priority(selected)
        else:
            self._rng.shuffle(selected)
        selected = selected[:round_size]
        return self._enforce_min_coverage(entries, all_pairs, selected)

    def _enforce_min_coverage(self, entries, all_pairs, selected):
        """Ensure >= min_coverage_ratio of entries appear in some pairing;
        prefer evicting low-priority redundant pairs over overrunning the
        budget (match_scheduler.py:322-427)."""
        ratio = self.config.min_coverage_ratio
        if ratio <= 0.0:
            return selected
        min_covered = int(len(entries) * ratio + 0.999999)
        budget = len(selected)
        covered = {e.id for p in selected for e in p}
        if len(covered) >= min_covered:
            return selected

        def key(p):
            return (min(p[0].id, p[1].id), max(p[0].id, p[1].id))

        selected_keys = {key(p) for p in selected}
        result = list(selected)
        protected: set[tuple[int, int]] = set()
        uncovered = [e for e in entries if e.id not in covered]
        # highest-priority extra pair per uncovered entry
        for e in uncovered:
            if len({x.id for p in result for x in p}) >= min_covered:
                break
            candidates = [
                p for p in all_pairs
                if key(p) not in selected_keys and e.id in (p[0].id, p[1].id)
            ]
            if not candidates:
                continue
            if self.scorer is not None:
                candidates = self.scorer.sort_by_priority(candidates)
            best = candidates[0]
            result.append(best)
            selected_keys.add(key(best))
            protected.add(key(best))
            # over budget: evict lowest-priority pair whose removal keeps coverage
            if len(result) > budget:
                counts: Counter[int] = Counter()
                for p in result:
                    counts[p[0].id] += 1
                    counts[p[1].id] += 1
                order = (
                    self.scorer.sort_by_priority(result)[::-1]
                    if self.scorer is not None else list(result)
                )
                for victim in order:
                    if key(victim) in protected:
                        continue
                    if counts[victim[0].id] > 1 and counts[victim[1].id] > 1:
                        result.remove(victim)
                        selected_keys.discard(key(victim))
                        break
                # if nothing evictable, accept a small overrun
        return result
