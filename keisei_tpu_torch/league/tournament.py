"""League tournament: rounds of pool-vs-pool matches with Elo recording
(counterpart of keisei_tpu/league/tournament.py).

Per round: generate prioritized pairings, play the pairings that share
one architecture on the concurrent match pool (concurrent.py: P pairings
per batched environment, one stacked forward a ply) and the others one at
a time on a match runner, record majority-wins Elo + per-role Elo +
head-to-head in one transaction, feed training-match rollouts to the
DynamicTrainer, extract behavioral features, refresh style profiles every
5 rounds and the tournament stats for the dashboard.

Rounds run synchronously where the trainer calls them (on its league
maintenance worker). Every tensor of a round lives on `device`: the store's
device (the trainer's) unless the config's `tournament_device` names
another card. The sidecar mode's training half is TournamentDispatcher;
its workers are worker.py.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

from .. import db
from ..utils.device import parse_device
from .config import LeagueConfig
from .dynamic_trainer import DynamicTrainer
from .match import ModelCache, host_rollout, make_match_runner
from .scheduler import (MatchScheduler, PriorityScorer,
                        build_match_class_weights, is_training_match)
from .store import OpponentEntry, OpponentStore, Role

logger = logging.getLogger(__name__)


class LeagueTournament:
    def __init__(
        self,
        store: OpponentStore,
        config: LeagueConfig,
        scheduler: MatchScheduler | None = None,
        scorer: PriorityScorer | None = None,
        dynamic_trainer: DynamicTrainer | None = None,
        max_pairings_per_round: int = 8,
        min_pool: int = 3,
        min_epoch: int = 5,
        heartbeat=None,
        learner_id_fn=None,
        device=None,
    ):
        self.store = store
        self.config = config
        self.scorer = scorer or PriorityScorer(
            config.priority, build_match_class_weights(config.scheduler))
        self.scheduler = scheduler or MatchScheduler(config.scheduler, self.scorer)
        self.dynamic_trainer = dynamic_trainer
        self.max_pairings_per_round = max_pairings_per_round
        self.min_pool = min_pool
        self.min_epoch = min_epoch
        # zero-arg callback invoked between pairings: a round can run for
        # minutes, and without beats /healthz flags the trainer dead
        self.heartbeat = heartbeat or (lambda: None)
        # current learner entry id (for the Elo-ceiling alert); None in
        # sidecar workers, which skip the check
        self.learner_id_fn = learner_id_fn or (lambda: None)
        self.device = parse_device(device, default=store.device)
        # games end at max_ply plies; the pool plays chunk_steps plies a
        # host call (the reference's values; a smoke run cuts both)
        self.max_ply = 512
        self.chunk_steps = 128
        # sampler(step, masks) -> (N,) actions: replaces the pool's draws
        # (tests replay JAX's); called anew from step 0 for every pool call
        self.sampler = None
        self.rounds_played = 0
        self._elo_ceiling_streak = 0
        self._phase_s: dict[str, float] = {}  # current round (reset per round)
        self._phase_total_s: dict[str, float] = {}  # lifetime cumulative
        self._phase_t = time.monotonic()
        self._runners: dict[tuple, object] = {}
        self._models = ModelCache()

    # learner exceeding the strongest Frontier anchor by this margin for
    # this many consecutive rounds means the pool may be too weak to teach
    # it anything
    ELO_CEILING_MARGIN = 200.0
    ELO_CEILING_STREAK = 2

    # -- plumbing -----------------------------------------------------------

    def _model_for(self, entry: OpponentEntry):
        return self._models.model_for(entry)

    def _runner_for(self, a: OpponentEntry, b: OpponentEntry):
        model_a, ka = self._model_for(a)
        model_b, kb = self._model_for(b)
        key = (ka, kb)
        if key not in self._runners:
            self._runners[key] = make_match_runner(
                model_a, model_b,
                num_games=self.config.tournament_num_envs,
                max_ply=self.max_ply,
            )
        return self._runners[key]

    def _match_vars(self, entry: OpponentEntry) -> dict:
        """Inference-only match play: the half-size bf16 tree (store LRU),
        on the tournament's device."""
        tree = self.store.load_variables_cached(entry, dtype="bfloat16")
        return {k: v.to(self.device) for k, v in tree.items()}

    def is_due(self, epoch: int) -> bool:
        if not self.config.tournament_enabled:
            return False
        if epoch < self.min_epoch:
            return False
        if epoch % self.config.tournament_interval_epochs != 0:
            return False
        return self.store.pool_size() >= self.min_pool

    # -- the round ---------------------------------------------------------------

    def run_round(self, epoch: int) -> dict:
        """Play one tournament round synchronously. Returns round stats.
        On a card, that card is the current device for the round."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return self._run_round_body(epoch)

    def _run_round_body(self, epoch: int) -> dict:
        t0 = time.monotonic()
        self._phase_s = {}
        self._phase_t = t0
        if self.dynamic_trainer is not None:
            self.dynamic_trainer.begin_round()
        entries = [
            e for e in self.store.list_entries()
            if e.role in (Role.DYNAMIC, Role.RECENT_FIXED, Role.FRONTIER_STATIC)
        ]
        if len(entries) < 2:
            return {"pairings": 0}
        pairings = self.scheduler.generate_round(entries)[: self.max_pairings_per_round]
        self._mark("schedule")

        total_games = total_plies = completed = 0
        # pairings sharing one architecture run batched in the pool,
        # training pairings included (the pool collects their rollouts);
        # only heterogeneous-arch pairings stay sequential
        pooled, sequential = self._partition_for_pool(pairings)
        if pooled:
            recorded: set[tuple[int, int]] = set()
            P = max(1, self.config.concurrency.parallel_matches)
            # training pairings grouped first so full rollout collection
            # is confined to as few chunks as possible
            pooled.sort(key=lambda ab: not self._is_training(*ab))
            for ci in range(0, len(pooled), P):
                chunk = pooled[ci:ci + P]
                self.heartbeat()
                try:
                    g, p, c = self._play_pooled(chunk, epoch, recorded,
                                                seed_salt=ci)
                    total_games += g
                    total_plies += p
                    completed += c
                except Exception:
                    logger.exception(
                        "pooled chunk failed — falling back sequential")
                    # replay only the pairings whose results were NOT
                    # already recorded: a mid-loop failure must not
                    # double-play and double-Elo pairings 0..k-1
                    sequential = [
                        (a, b) for a, b in chunk
                        if (a.id, b.id) not in recorded
                    ] + sequential
        for a, b in sequential:
            self.heartbeat()
            try:
                stats = self._play_pairing(a, b, epoch)
            except Exception:
                logger.exception("tournament pairing %d-vs-%d failed", a.id, b.id)
                continue
            completed += 1
            total_games += stats["games"]
            total_plies += stats["plies"]
        self.heartbeat()
        self.scorer.advance_round()
        self.rounds_played += 1

        # reconcile dynamic-trainer caches against the live tier: entries
        # retired/evicted since last round release their buffered rollouts
        # and device-resident Adam moments
        if self.dynamic_trainer is not None:
            try:
                active = {
                    e.id for e in self.store.list_by_role(Role.DYNAMIC)
                }
                self.dynamic_trainer.retain_only(active)
            except Exception:
                logger.exception("dynamic-trainer cache sweep failed")

        # style profiles every 5 rounds
        if self.rounds_played % 5 == 0:
            try:
                from .style import StyleProfiler

                StyleProfiler(self.store.db_path).recompute_all()
            except Exception:
                logger.exception("style profiling failed — continuing")

        ceiling = self._check_elo_ceiling(entries)

        duration = time.monotonic() - t0
        phase_s = {k: round(v, 2) for k, v in
                   sorted(self._phase_s.items(), key=lambda kv: -kv[1])}
        if duration > 30.0:
            logger.info("tournament round phases (%.1fs total): %s",
                        duration, phase_s)
        round_stats = {
            **ceiling,
            "phase_s": phase_s,
            "round_duration_s": duration,
            "pairings_requested": len(pairings),
            "pairings_completed": completed,
            "total_games": total_games,
            "total_plies": total_plies,
            "active_slots": len(entries),
            "games_per_min": total_games / max(duration / 60.0, 1e-9),
        }
        try:
            db.write_tournament_stats(self.store.db_path, round_stats)
        except Exception:
            logger.exception("tournament stats write failed — continuing")
        return round_stats

    def _check_elo_ceiling(self, entries) -> dict:
        """Warn when the learner has outgrown the opponent pool: learner
        composite Elo exceeding the strongest FRONTIER entry by >= 200 for
        2+ consecutive rounds. Returns {elo_ceiling_margin,
        elo_ceiling_streak} for round stats (margin is None until both
        learner and a Frontier entry exist)."""
        learner_id = self.learner_id_fn()
        out = {"elo_ceiling_margin": None,
               "elo_ceiling_streak": self._elo_ceiling_streak}
        if learner_id is None:
            return out
        try:
            learner = self.store.get_entry(learner_id)
        except Exception:
            return out
        frontier = [e.elo_rating for e in entries
                    if e.role == Role.FRONTIER_STATIC and e.id != learner_id]
        if not frontier:
            return out
        margin = learner.elo_rating - max(frontier)
        out["elo_ceiling_margin"] = margin
        if margin >= self.ELO_CEILING_MARGIN:
            self._elo_ceiling_streak += 1
            if self._elo_ceiling_streak >= self.ELO_CEILING_STREAK:
                logger.warning(
                    "Elo ceiling alert: learner (%.0f) exceeds max Frontier "
                    "(%.0f) by %.0f for %d consecutive rounds — pool may be "
                    "too weak", learner.elo_rating, max(frontier), margin,
                    self._elo_ceiling_streak,
                )
        else:
            self._elo_ceiling_streak = 0
        out["elo_ceiling_streak"] = self._elo_ceiling_streak
        return out

    def _mark(self, phase: str) -> None:
        now = time.monotonic()
        took = now - self._phase_t
        self._phase_s[phase] = self._phase_s.get(phase, 0.0) + took
        self._phase_total_s[phase] = (
            self._phase_total_s.get(phase, 0.0) + took)
        self._phase_t = now

    def _is_training(self, a: OpponentEntry, b: OpponentEntry) -> bool:
        return is_training_match(a, b) and self.dynamic_trainer is not None

    def _partition_for_pool(self, pairings):
        """(pooled, sequential): pairings sharing one arch+params signature
        run batched in the ConcurrentMatchPool — run_round chunks them into
        groups of `parallel_matches`; training pairings ride the pool too
        (it collects their rollouts). Heterogeneous-architecture pairings
        fall back to the sequential per-pairing runner."""
        P = self.config.concurrency.parallel_matches
        if P <= 1 or not pairings:
            return [], list(pairings)
        pooled, sequential = [], []
        key0 = None
        for a, b in pairings:
            _, ka = self._model_for(a)
            _, kb = self._model_for(b)
            if ka == kb and (key0 is None or ka == key0):
                key0 = ka
                pooled.append((a, b))
            else:
                sequential.append((a, b))
        if len(pooled) < 2:  # no batching win for a single pairing
            return [], list(pairings)
        return pooled, sequential

    def _play_pooled(self, pooled, epoch: int, recorded: set | None = None,
                     seed_salt: int = 0):
        from .concurrent import ConcurrentMatchPool

        model, key = self._model_for(pooled[0][0])
        pool_key = ("__pool__", key)  # the pool pads short rounds itself
        if pool_key not in self._runners:
            self._runners[pool_key] = ConcurrentMatchPool(
                model,
                parallel_matches=self.config.concurrency.parallel_matches,
                envs_per_match=self.config.concurrency.envs_per_match,
                max_ply=self.max_ply,
                chunk_steps=self.chunk_steps,
                device=self.device,
            )
        pool = self._runners[pool_key]
        pairs_vars = [(self._match_vars(a), self._match_vars(b)) for a, b in pooled]
        self._mark("load_weights")
        training_flags = [self._is_training(a, b) for a, b in pooled]
        # full collection only when a slot feeds the dynamic trainer;
        # "light" otherwise — still enough for game-feature extraction
        collect = True if any(training_flags) else "light"
        # epoch and chunk index fold into disjoint bit ranges
        results, stats, rollouts = pool.run_round(
            pairs_vars, seed=(epoch << 8) | (seed_salt & 0xFF),
            collect=collect, sampler=self.sampler)
        self._mark("play")
        for (a, b), result, rollout, training in zip(
                pooled, results, rollouts, training_flags):
            self.store.record_result(
                a.id, b.id, epoch=epoch,
                wins_a=result.wins_a, wins_b=result.wins_b, draws=result.draws,
                match_type="tournament", k=self.config.tournament_k_factor,
                elo_floor=self.config.elo_floor,
                role_elo_k={
                    Role.FRONTIER_STATIC: self.config.elo.frontier_k,
                    Role.DYNAMIC: self.config.elo.dynamic_k,
                    Role.RECENT_FIXED: self.config.elo.recent_k,
                },
            )
            if recorded is not None:
                recorded.add((a.id, b.id))
            self.scorer.record_result(a.id, b.id)
            self.scorer.record_round_result(a.id, b.id)
            self._mark("record")
            self._post_match(a, b, epoch, rollout, training)
        return stats.games, stats.total_plies, len(pooled)

    def _play_pairing(self, a: OpponentEntry, b: OpponentEntry, epoch: int) -> dict:
        runner = self._runner_for(a, b)
        vars_a = self._match_vars(a)
        vars_b = self._match_vars(b)
        self._mark("load_weights")
        training = is_training_match(a, b) and self.dynamic_trainer is not None

        # training matches collect the full record (the dynamic trainer
        # consumes observations); calibration matches collect "light" — only
        # the small (T, N) arrays feature extraction needs
        result, rollout = runner(
            vars_a, vars_b, seed=epoch * 1000 + a.id,
            collect=True if training else "light",
        )
        self._mark("play")

        self.store.record_result(
            a.id, b.id, epoch=epoch,
            wins_a=result.wins_a, wins_b=result.wins_b, draws=result.draws,
            match_type="tournament", k=self.config.tournament_k_factor,
            elo_floor=self.config.elo_floor,
            role_elo_k={
                Role.FRONTIER_STATIC: self.config.elo.frontier_k,
                Role.DYNAMIC: self.config.elo.dynamic_k,
                Role.RECENT_FIXED: self.config.elo.recent_k,
            },
        )
        self.scorer.record_result(a.id, b.id)
        self.scorer.record_round_result(a.id, b.id)
        self._mark("record")

        self._post_match(a, b, epoch, rollout, training)
        return {"games": result.games, "plies": result.total_plies}

    def _post_match(self, a: OpponentEntry, b: OpponentEntry, epoch: int,
                    rollout, training: bool) -> None:
        """Shared post-play bookkeeping: game features (from a host copy of
        the rollout's small arrays) + dynamic training (both the sequential
        runner and pool slots produce the same MatchRollout record)."""
        if rollout is None:
            return
        try:
            from .features import extract_game_features

            rows = extract_game_features(host_rollout(rollout), a.id, b.id, epoch)
            if rows:
                db.write_game_features(self.store.db_path, rows)
        except Exception:
            logger.exception("game feature extraction failed — continuing")
        self._mark("features")

        if training and self.dynamic_trainer is not None:
            for entry, side in ((a, "a"), (b, "b")):
                if entry.role == Role.DYNAMIC and entry.training_enabled:
                    self.dynamic_trainer.record_rollout(entry.id, rollout, side)
                    self._mark("dyn_fetch")
                    self.dynamic_trainer.maybe_update(
                        self.store.get_entry(entry.id), seed=epoch,
                    )
                    self._mark("dyn_update")


class TournamentDispatcher:
    """Training-side half of the sidecar mode: generate + enqueue pairings
    into the DB queue for out-of-process workers (worker.py)."""

    def __init__(
        self,
        store: OpponentStore,
        config: LeagueConfig,
        scheduler: MatchScheduler | None = None,
        scorer: PriorityScorer | None = None,
    ):
        self.store = store
        self.config = config
        self.scorer = scorer or PriorityScorer(
            config.priority, build_match_class_weights(config.scheduler))
        self.scheduler = scheduler or MatchScheduler(config.scheduler, self.scorer)
        self._round_id = 0

    def enqueue_round(self, epoch: int) -> int:
        """Generate a prioritized round and enqueue it; returns pairings
        queued (0 when the queue is saturated or no healthy worker exists —
        the caller logs, training never blocks)."""
        from ..db import queue as dbq

        depth = dbq.get_active_queue_depth(self.store.db_path)
        if depth >= self.config.dispatcher_max_queue_depth:
            logger.warning("tournament queue saturated (%d) — skipping enqueue", depth)
            return 0
        workers = [w for w in dbq.get_worker_health(self.store.db_path)
                   if w["is_healthy"]]
        if not workers:
            logger.warning("no healthy tournament worker — enqueueing anyway")

        entries = [
            e for e in self.store.list_entries()
            if e.role in (Role.DYNAMIC, Role.RECENT_FIXED, Role.FRONTIER_STATIC)
        ]
        if len(entries) < 2:
            return 0
        pairings = self.scheduler.generate_round(entries)
        self._round_id += 1
        rows = [
            (a.id, b.id, self.config.tournament_games_per_match,
             self.scorer.score(a, b))
            for a, b in pairings
        ]
        n = dbq.enqueue_pairings(self.store.db_path, self._round_id, rows, epoch)
        # Feed the enqueued pairings back into the scorer AT DISPATCH time:
        # results are recorded by out-of-process workers, so the dispatcher
        # never sees them. Counting "scheduled" as "played" keeps the
        # under-sample and repeat terms of the scorer live without any
        # cross-process plumbing; workers claim near-everything queued, so
        # the approximation is tight.
        for a, b in pairings:
            self.scorer.record_result(a.id, b.id)
            self.scorer.record_round_result(a.id, b.id)
        self.scorer.advance_round()
        return n
