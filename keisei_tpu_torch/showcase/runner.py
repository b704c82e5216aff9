"""Showcase sidecar: plays queued exhibition matches at watchable speed
(counterpart of keisei_tpu/showcase/runner.py).

Claims pending showcase_queue entries, plays a single game via
SpectatorEnv with temperature-0.5 sampling, writes a showcase_moves row
per ply (Hodges + USI, win-probability estimate, policy heatmap over the
chosen move's from-square), heartbeats, sweeps orphaned games at startup,
honors live speed changes and cancellation, and auto-queues an exhibition
between the two strongest entries when idle too long. The game loop, the
queue handling and the DB rows are the JAX package's.

Runs as its own process (`python -m keisei_tpu_torch.showcase.runner`);
models come from the league store (entry ids are league entry ids) and
run, with the game, on `--device`: the card unless the caller names
"cpu". The JAX sidecar pins itself to the host CPU instead; here one B=1
forward every 0.5-4 s shares the learner's card.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import random
import signal
import sqlite3
import time
from collections import OrderedDict

import numpy as np
import torch

from ..db import showcase as sc
from ..env.spectator import SpectatorEnv
from ..league.store import OpponentStore
from ..models.registry import build_model

logger = logging.getLogger(__name__)

SPEED_DELAYS = {"slow": 4.0, "normal": 2.0, "fast": 0.5}
SPEED_POLL_INTERVAL = 5  # re-read speed from DB every N plies
AUTO_SHOWCASE_INTERVAL_S = 1800.0
MAX_MATCH_REPLAYS = 2  # replay a failed match at most this often, then cancel
TEMPERATURE = 0.5


def build_heatmap(chosen_usi: str, legal_with_usi, probs: dict[int, float]) -> dict:
    """{usi: prob} for legal moves sharing the chosen move's from-square /
    drop prefix (reference heatmap.py:21-49)."""
    prefix = chosen_usi[:2]
    out = {}
    for idx, usi in legal_with_usi:
        if usi[:2] != prefix:
            continue
        p = probs.get(idx)
        if p is None or not math.isfinite(p) or p <= 0.0:
            continue
        out[usi] = float(p)
    return out


class ModelCache:
    """LRU of (entry_id, update_count) -> the entry's eager nn.Module in eval
    mode, with its stored weights, on the store's device; max 2 entries
    (reference inference.py ModelCache). An architecture the port lacks
    raises NotImplementedError (models/registry.py)."""

    def __init__(self, store: OpponentStore, max_size: int = 2):
        self.store = store
        self.max_size = max_size
        self._cache: OrderedDict = OrderedDict()

    def get(self, entry_id: int) -> torch.nn.Module:
        entry = self.store.get_entry(entry_id)
        key = (entry.id, entry.update_count)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        model, _ = build_model(entry.architecture, entry.model_params)
        model.load_state_dict(self.store.load_variables(entry))
        model.to(self.store.device).eval()
        self._cache[key] = model
        while len(self._cache) > self.max_size:
            self._cache.popitem(last=False)
        return model


def policy_and_value(model: torch.nn.Module, env: SpectatorEnv) -> tuple[np.ndarray, float]:
    """The mover's policy logits over the 11,259 spatial actions and its
    value P(W) - P(L), from one B=1 forward on the model's device."""
    obs = np.zeros((1, 50, 9, 9), np.float32)  # pad 46 -> 50 (inference.py:75-81)
    obs[0, :46] = env.get_observation()
    with torch.no_grad():
        out = model(torch.from_numpy(obs).to(next(model.parameters()).device))
        wdl = torch.softmax(out.value_logits.float(), dim=-1)[0]
        # one transfer: the logits, then P(W) and P(L)
        host = torch.cat([out.policy_logits.reshape(-1).float(), wdl[[0, 2]]]).cpu().numpy()
    return host[:-2], float(host[-2] - host[-1])


class ShowcaseRunner:
    def __init__(self, db_path: str, league_dir: str, max_ply: int = 512,
                 auto_showcase: bool = True,
                 store: OpponentStore | None = None,
                 device: torch.device | str = "cuda"):
        """`device`: where the models and the game run (resolved by the
        store: a card the machine lacks raises); a given `store` brings its own."""
        self.db_path = db_path
        self.store = store or OpponentStore(db_path, league_dir, device=device)
        self.device = self.store.device
        self.cache = ModelCache(self.store)
        self.max_ply = max_ply
        self.auto_showcase = auto_showcase
        self._stop = False
        self._last_activity = time.monotonic()
        self._rng = np.random.default_rng(os.getpid())

    def request_stop(self, *_a) -> None:
        self._stop = True

    # -- inference ------------------------------------------------------------

    def _policy_and_value(self, entry_id: int, env: SpectatorEnv):
        return policy_and_value(self.cache.get(entry_id), env)

    def _choose(self, logits: np.ndarray, legal_spatial: np.ndarray):
        masked = np.full(logits.shape, -np.inf, np.float32)
        masked[legal_spatial] = logits[legal_spatial] / TEMPERATURE
        z = masked - masked.max()
        p = np.exp(z)
        p /= p.sum()
        action = int(self._rng.choice(len(p), p=p))
        return action, p

    # -- the game --------------------------------------------------------------

    def play_match(self, queue_row: dict) -> None:
        qid = queue_row["id"]
        try:
            e1 = self.store.get_entry(int(queue_row["entry_id_1"]))
            e2 = self.store.get_entry(int(queue_row["entry_id_2"]))
        except (KeyError, ValueError):
            logger.warning("showcase %s: unknown entries — cancelling", qid)
            sc.cancel_match(self.db_path, qid)
            return
        # random color assignment
        black, white = (e1, e2) if self._rng.random() < 0.5 else (e2, e1)
        gid = sc.create_showcase_game(
            self.db_path, queue_id=qid,
            entry_id_black=str(black.id), entry_id_white=str(white.id),
            elo_black=black.elo_rating, elo_white=white.elo_rating,
            name_black=black.display_name, name_white=white.display_name,
        )
        env = SpectatorEnv(max_ply=self.max_ply, action_mode="spatial", device=self.device)
        speed = queue_row.get("speed", "normal")
        logger.info("showcase game %d: %s (B) vs %s (W)", gid,
                    black.display_name, white.display_name)
        try:
            while not env.is_over() and not self._stop:
                ply = env.ply
                if ply % SPEED_POLL_INTERVAL == 0:
                    status = sc.get_queue_status(self.db_path, qid)
                    if status == "cancelled":
                        sc.mark_game_abandoned(self.db_path, gid, "cancelled by user")
                        return
                    speed = sc.get_queue_speed(self.db_path, qid) or speed
                mover = black if env.current_player() == "black" else white
                t0 = time.monotonic()
                logits, value = self._policy_and_value(mover.id, env)
                legal = env.legal_actions()
                action, probs = self._choose(logits, np.array(legal))
                legal_usi = env.legal_moves_with_usi()
                usi = dict(legal_usi)[action]
                heatmap = build_heatmap(
                    usi, legal_usi, {a: float(probs[a]) for a in legal}
                )
                d = env.step(action)
                notation = env.move_history[-1][1]
                sc.write_showcase_move(
                    self.db_path, game_id=gid, ply=env.ply, action_index=action,
                    usi_notation=notation, move_usi=usi,
                    board_json=json.dumps(d["board"]),
                    hands_json=json.dumps(d["hands"]),
                    current_player=d["current_player"],
                    in_check=d["in_check"], value_estimate=value,
                    top_candidates=json.dumps(sorted(
                        heatmap.items(), key=lambda kv: -kv[1])[:5]),
                    move_heatmap_json=json.dumps(heatmap),
                    move_time_ms=int((time.monotonic() - t0) * 1000),
                )
                sc.write_heartbeat(self.db_path, os.getpid())
                time.sleep(SPEED_DELAYS.get(speed, 2.0))
            result = env.to_dict()["result"] if env.is_over() else "abandoned"
            if env.is_over():
                winner = env.winner
                label = ("black_win" if winner == 0 else
                         "white_win" if winner == 1 else "draw")
                sc.mark_game_completed(self.db_path, gid, label, env.ply)
                logger.info("showcase game %d finished: %s (%s) in %d plies",
                            gid, label, result, env.ply)
            else:
                sc.mark_game_abandoned(self.db_path, gid, "runner stopped")
        except Exception:
            logger.exception("showcase game %d crashed", gid)
            sc.mark_game_abandoned(self.db_path, gid, "exception")

    def _maybe_auto_showcase(self) -> None:
        if not self.auto_showcase:
            return
        if time.monotonic() - self._last_activity < AUTO_SHOWCASE_INTERVAL_S:
            return
        entries = self.store.list_entries()
        if len(entries) < 2:
            return
        top = entries[:4]
        a, b = random.sample(top, 2)
        sc.queue_match(self.db_path, str(a.id), str(b.id), "normal")
        self._last_activity = time.monotonic()
        logger.info("auto-showcase queued: %s vs %s", a.display_name, b.display_name)

    def run(self) -> None:
        logger.info("showcase runner starting (pid %d)", os.getpid())
        swept = sc.cleanup_orphaned_games(self.db_path)
        if swept:
            logger.info("swept %d orphaned showcase games", swept)
        sc.write_heartbeat(self.db_path, os.getpid())
        last_sweep = time.monotonic()
        claimed_id = None
        claimed_played = False  # play_match returned; only completion pending
        requeues: dict[int, int] = {}  # queue id -> replay attempts
        while not self._stop:
            try:
                # a claimed-but-uncompleted entry blocks claim_next_match
                # forever — resolve it before claiming anything new. If the
                # match actually played (only its completion write hit a
                # locked DB), mark it done; if play_match itself died on a
                # DB error, requeue for a clean replay instead of silently
                # swallowing a never-played match. Replays are capped: a
                # persistently-failing match (schema mismatch, wedged
                # writer) must not starve the rest of the queue by being
                # re-claimed as the oldest pending entry forever.
                if claimed_id is not None:
                    if claimed_played:
                        sc.complete_queue_entry(self.db_path, claimed_id)
                    elif requeues.get(claimed_id, 0) >= MAX_MATCH_REPLAYS:
                        logger.error(
                            "showcase match %s failed %d replays — cancelling",
                            claimed_id, requeues[claimed_id])
                        sc.cancel_match(self.db_path, claimed_id)
                        requeues.pop(claimed_id, None)
                    else:
                        # count AFTER the requeue write succeeds: a locked-DB
                        # failure of requeue_entry itself must burn no replay
                        # budget (the match never got replayed), or two lock
                        # hiccups would cancel a never-replayed match
                        sc.requeue_entry(self.db_path, claimed_id)
                        requeues[claimed_id] = requeues.get(claimed_id, 0) + 1
                    claimed_id = None
                    claimed_played = False
                if time.monotonic() - last_sweep > 60.0:
                    # periodic orphan sweep (not just at startup): recovers
                    # 'running' rows stranded by any earlier failure
                    sc.cleanup_orphaned_games(self.db_path)
                    last_sweep = time.monotonic()
                match = sc.claim_next_match(self.db_path)
                if match is None:
                    self._maybe_auto_showcase()
                    time.sleep(2.0)
                    sc.write_heartbeat(self.db_path, os.getpid())
                    continue
                self._last_activity = time.monotonic()
                claimed_id = match["id"]
                claimed_played = False
                self.play_match(match)
                claimed_played = True
                sc.complete_queue_entry(self.db_path, claimed_id)
                claimed_id = None
                claimed_played = False
            except sqlite3.OperationalError as e:
                # non-fatal telemetry policy (reference §5.3): the DB can be
                # momentarily locked, re-initialized, or replaced by a fresh
                # training run — back off and retry instead of dying
                logger.warning("showcase DB unavailable (%s) — retrying", e)
                time.sleep(5.0)
        logger.info("showcase runner exiting")


def main(argv=None):
    p = argparse.ArgumentParser(description="keisei-tpu showcase sidecar (PyTorch)")
    p.add_argument("--db", required=True)
    p.add_argument("--league-dir", required=True)
    p.add_argument("--max-ply", type=int, default=512)
    p.add_argument("--no-auto", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu: where the models and the "
                   "game run; a card the machine lacks fails at startup")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    runner = ShowcaseRunner(args.db, args.league_dir, max_ply=args.max_ply,
                            auto_showcase=not args.no_auto, device=args.device)
    signal.signal(signal.SIGTERM, runner.request_stop)
    signal.signal(signal.SIGINT, runner.request_stop)
    runner.run()


if __name__ == "__main__":
    main()
