"""Out-of-process tournament worker: claims pairings from the DB queue
(counterpart of keisei_tpu/league/worker.py).

A sidecar process: sweeps its own stale claims at startup, heartbeats into
tournament_worker_heartbeat, claims batches atomically (2x overclaim),
plays each pairing on its device, records results + Elo, and marks
pairings done. SIGTERM finishes the current pairing then exits.

    python -m keisei_tpu_torch.league.worker --db <path> --league-dir <dir> \
        [--device cuda:1]

`--device` defaults to the card (`cuda`, card 0), as every entry point of
the port does; the JAX worker defaults to its host CPU. `--device cpu`
plays on the CPU (small models only), `N` or `cuda:N` on card N.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import signal
import time
import uuid

import torch

from ..db import queue as dbq
from ..utils.device import parse_device
from .config import LeagueConfig
from .dynamic_trainer import DynamicTrainer
from .scheduler import is_training_match
from .store import OpponentStore
from .tournament import LeagueTournament

logger = logging.getLogger(__name__)


class TournamentWorker:
    def __init__(
        self,
        db_path: str,
        league_dir: str,
        config: LeagueConfig | None = None,
        worker_id: str | None = None,
        parallel_matches: int = 2,
        poll_interval_s: float = 2.0,
        store: OpponentStore | None = None,
        device=None,
    ):
        self.config = config or LeagueConfig(tournament_enabled=True)
        # None = the card; "cpu", "N" or "cuda:N" as parse_device reads them
        self.device = parse_device(device)
        self.store = store or OpponentStore(db_path, league_dir, device=self.device)
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.parallel_matches = parallel_matches
        self.poll_interval_s = poll_interval_s
        # claims of peers whose heartbeat is older than this are treated
        # as stranded by a dead worker and returned to pending; must
        # exceed the slowest expected single pairing (workers beat before
        # every pairing)
        self.dead_peer_reclaim_s = 300.0
        self.pairings_done = 0
        self._stop = False
        self._cpu_warned: set = set()
        # reuse the tournament's pairing machinery (runner cache, Elo txn)
        self._tourney = LeagueTournament(self.store, self.config, device=self.device)
        self._tourney.dynamic_trainer = DynamicTrainer(
            self.store, None, self.config.dynamic, device=self.device
        )

    def request_stop(self, *_args) -> None:
        logger.info("worker %s: stop requested", self.worker_id)
        self._stop = True

    # conv-stem param estimate above which a CPU worker is orders slower
    # than the in-process pooled path (b40c256 ~ 47M; b10c128 ~ 3M)
    CPU_FEASIBLE_PARAMS = 10_000_000

    def _warn_if_infeasible_on_cpu(self, entry) -> None:
        """A flagship pairing on a CPU worker runs orders slower than
        in_process mode: estimate the residual-stem parameter count from
        the entry's model_params and warn (once per model signature) when
        it exceeds the CPU feasibility threshold."""
        try:
            if self.device.type != "cpu":
                return
            mp = entry.model_params or {}
            blocks = int(mp.get("num_blocks", 0))
            ch = int(mp.get("channels", 0))
            approx = 18 * blocks * ch * ch  # 2 conv3x3 per SE block
        except Exception:
            return
        if approx <= self.CPU_FEASIBLE_PARAMS:
            return
        sig = (entry.architecture, blocks, ch)
        if sig in self._cpu_warned:
            return
        self._cpu_warned.add(sig)
        logger.warning(
            "worker %s plays on the host CPU but pairing model %s b%dc%d "
            "(~%.0fM params) is far beyond the CPU feasibility threshold — "
            "each match will be orders of magnitude slower than the "
            "trainer's in_process tournament path. Use "
            "tournament_mode='in_process', or run this worker on a card "
            "(--device cuda:N).",
            self.worker_id, entry.architecture, blocks, ch, approx / 1e6,
        )

    def _heartbeat(self) -> None:
        dbq.write_worker_heartbeat(
            self.store.db_path, self.worker_id, os.getpid(), str(self.device),
            self.pairings_done,
        )

    def _stale_cutoff(self) -> int | None:
        """Expire pairings older than max_staleness_epochs relative to the
        trainer's current epoch."""
        try:
            from .. import db as kdb

            state = kdb.read_training_state(self.store.db_path)
            if state and state.get("current_epoch") is not None:
                return int(state["current_epoch"]) - self.config.max_staleness_epochs
        except Exception:
            pass
        return None

    def run_once(self, stale_before_epoch: int | None = None) -> int:
        """Claim and play one batch; returns pairings completed. On a card,
        that card is the current device for the batch."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return self._run_once_body(stale_before_epoch)

    def _run_once_body(self, stale_before_epoch: int | None = None) -> int:
        if stale_before_epoch is None:
            stale_before_epoch = self._stale_cutoff()
        batch = dbq.claim_next_pairings_batch(
            self.store.db_path, self.worker_id,
            2 * self.parallel_matches, stale_before_epoch,
        )
        if batch:
            # beat immediately after claiming: peers treat claims whose
            # worker heartbeat has gone stale as stranded (dead-worker
            # reclaim), so the claim must never be older than our beat
            self._heartbeat()
            # per-batch dynamic-update budget (the worker's "round")
            self._tourney.dynamic_trainer.begin_round()
        done = 0
        for pairing in batch:
            if self._stop:
                # return unplayed claims so another worker picks them up
                dbq.reset_stale_playing(self.store.db_path, self.worker_id)
                break
            try:
                a = self.store.get_entry(pairing["entry_a_id"])
                b = self.store.get_entry(pairing["entry_b_id"])
                self._warn_if_infeasible_on_cpu(a)
                self._warn_if_infeasible_on_cpu(b)
                if is_training_match(a, b):
                    # the worker's dynamic trainer trains the pairing's
                    # architecture (its module is built per architecture;
                    # the arch gate skips entries of another)
                    from ..models.registry import get_model_contract

                    model, _ = self._tourney._model_for(a)
                    self._tourney.dynamic_trainer.model = model
                    self._tourney.dynamic_trainer.contract = get_model_contract(
                        a.architecture
                    )
                    self._tourney.dynamic_trainer.architecture = a.architecture
                self._tourney._play_pairing(a, b, pairing["enqueued_epoch"])
                dbq.mark_pairing_done(self.store.db_path, pairing["id"])
                done += 1
                self.pairings_done += 1
            except Exception:
                logger.exception("pairing %s failed — marking done to avoid "
                                 "poison-claim loops", pairing["id"])
                dbq.mark_pairing_done(self.store.db_path, pairing["id"])
            self._heartbeat()
        return done

    def run(self) -> None:
        logger.info("worker %s starting (pid %d)", self.worker_id, os.getpid())
        # startup sweep: our previous incarnation may have died mid-claim
        swept = dbq.reset_stale_playing(self.store.db_path, self.worker_id)
        if swept:
            logger.info("worker %s: reset %d stale claims", self.worker_id, swept)
        self._heartbeat()
        while not self._stop:
            n = self.run_once()
            if n == 0 and not self._stop:
                # idle: sweep claims stranded by dead peers so their round
                # completes (a SIGKILLed worker can never sweep its own)
                try:
                    swept = dbq.reclaim_dead_worker_claims(
                        self.store.db_path, self.dead_peer_reclaim_s,
                        exclude_worker=self.worker_id)
                    if swept:
                        logger.warning(
                            "worker %s: reclaimed %d claims from dead peers",
                            self.worker_id, swept)
                        continue  # immediately try the reclaimed work
                except Exception:
                    logger.exception("dead-peer reclaim failed — continuing")
                time.sleep(self.poll_interval_s)
                self._heartbeat()
        logger.info("worker %s exiting (%d pairings)", self.worker_id,
                    self.pairings_done)


def main(argv=None):
    p = argparse.ArgumentParser(description="keisei_tpu_torch tournament worker")
    p.add_argument("--db", required=True)
    p.add_argument("--league-dir", required=True)
    p.add_argument("--parallel-matches", type=int, default=2)
    p.add_argument("--worker-id", default=None)
    p.add_argument("--device", default="cuda",
                   help="Where this worker plays: 'cuda' (default: card 0), "
                   "'N' or 'cuda:N' (card N: give the tournament its own card "
                   "beside the learner's), or 'cpu' (small models only, see "
                   "CPU_FEASIBLE_PARAMS).")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    worker = TournamentWorker(
        args.db, args.league_dir, worker_id=args.worker_id,
        parallel_matches=args.parallel_matches, device=args.device,
    )
    signal.signal(signal.SIGTERM, worker.request_stop)
    signal.signal(signal.SIGINT, worker.request_stop)
    worker.run()


if __name__ == "__main__":
    main()
