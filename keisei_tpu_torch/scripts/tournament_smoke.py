"""The league tournament end to end, with its checks: one in-process round
of configs/katago-league.toml's league at full width on a store seeded
with random-weight entries (2 Dynamic with training on, 1 Recent, 1
Frontier), the sidecar mode (the dispatcher enqueues a round, a worker
claims and plays a batch), and the wiring in SelfPlayTrainer (league
epochs with the tournament due, scripts/league_smoke.py).

    python -m keisei_tpu_torch.scripts.tournament_smoke [--device cuda]
        [--blocks N] [--max-ply 64] [--chunk 64] [--games 48] [--wiring-blocks 8]

The cuts are printed. The round's checks: every pairing completed; the
pool ran (its run_round counter moved) and no pairing went down the
sequential fallback; result, Elo, tournament-stats and game-feature rows
written; at least one Dynamic update succeeded (maybe_update True, the
update count bumped, weights changed, finite losses, no error counted);
every tensor of the round on the requested device. On a card it then
times a ply of the pool beside a ply of a gauntlet match (`time_plies`).
The sidecar's: the claimed pairings marked done with their results. chip_smoke.py phase 9
calls `run_round`, `run_sidecar` and league_smoke.run_league.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
import tomllib

import torch

from .. import db
from ..db import queue as dbq
from ..league.concurrent import ConcurrentMatchPool
from ..league.config import league_config_from_dict
from ..league.dynamic_trainer import DynamicTrainer
from ..league.store import OpponentStore, Role
from ..league.tournament import LeagueTournament, TournamentDispatcher
from ..league.worker import TournamentWorker
from ..models.registry import build_model
from .league_smoke import CONFIG, _tensors

ROLES = (Role.DYNAMIC, Role.DYNAMIC, Role.RECENT_FIXED, Role.FRONTIER_STATIC)


def _league():
    """configs/katago-league.toml's model params, learning rate and league
    section, Dynamic updates after every match; returns (params, lr,
    LeagueConfig, cuts)."""
    with open(CONFIG, "rb") as f:
        raw = tomllib.load(f)
    section = raw["league"]
    section.setdefault("dynamic", {})["update_every_matches"] = 1
    cuts = ["league.dynamic.update_every_matches = 1"]
    return (dict(raw["model"]["params"]), raw["training"]["algorithm_params"]["learning_rate"],
            league_config_from_dict(section), cuts)


def seed_store(device, tmp: str, params: dict) -> OpponentStore:
    """A store with one random-weight entry per role of ROLES, bf16
    snapshots as storage.snapshot_dtype keeps them."""
    store = OpponentStore(os.path.join(tmp, "league.db"), os.path.join(tmp, "league"),
                          device=device)
    for i, role in enumerate(ROLES):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1000 + i)
            sd = build_model("se_resnet", params)[0].state_dict()
        store.add_entry({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                         for k, v in sd.items()}, architecture="se_resnet",
                        model_params=params, created_epoch=i, role=role)
    return store


@torch.no_grad()
def time_plies(pool: ConcurrentMatchPool, store: OpponentStore, a, b,
               gauntlet_games: tuple = (2, 16)) -> dict:
    """Milliseconds a ply (CUDA events around 10 calls, host launches
    included) of the pool, which advances its P pairings together (one
    stacked forward over the 2P weight sets and one engine step over P*E
    games), beside a gauntlet match's ply (two eager forwards of the
    parameter-free twin at B = games and one engine step; B=2 as the smoke
    cuts it, 16 as gauntlet.games_per_matchup defaults), on entries a and
    b's bf16 weights."""
    from torch.func import functional_call

    from ..env.vec_env import EnvCore
    from ..league.concurrent import stack_pairings
    from ..league.match import ModelCache
    from ..utils.timing import cuda_ms

    va = store.load_variables_cached(a, dtype="bfloat16")
    vb = store.load_variables_cached(b, dtype="bfloat16")
    stacked = stack_pairings([(va, vb)] * pool.P)
    states, obs, masks = pool.core.init()
    obs2 = obs.reshape(pool.P, pool.E, *obs.shape[1:])
    masks2 = masks.reshape(pool.P, pool.E, -1)
    obs2, masks2 = torch.cat([obs2, obs2]), torch.cat([masks2, masks2])
    first_legal = masks.int().argmax(dim=-1)
    fwd = cuda_ms(lambda: pool.stacked_forward(stacked, obs2, masks2), iters=10)
    step = cuda_ms(lambda: pool.core.step(states, first_legal), iters=10)
    out = {"pool_forward_ms": fwd, "pool_step_ms": step,
           "pool_ply_per_pairing_ms": (fwd + step) / pool.P}
    twin, _ = ModelCache().model_for(a)
    for n in gauntlet_games:
        core = EnvCore(n, 512, pool.core.num_channels, pool.device)
        g_states, g_obs, g_masks = core.init()
        g_fwd = cuda_ms(lambda: functional_call(twin, va, (g_obs.reshape(n, -1, 9, 9),)),
                        iters=10)
        g_step = cuda_ms(lambda: core.step(g_states, g_masks.int().argmax(dim=-1)), iters=10)
        out.update({f"gauntlet_B{n}_forward_ms": g_fwd, f"gauntlet_B{n}_step_ms": g_step,
                    f"gauntlet_B{n}_ply_ms": 2 * g_fwd + g_step})
    return out


def run_round(device, tmp: str, *, blocks: int | None = None, max_ply: int = 64,
              chunk_steps: int = 64, label: str = "tournament round") -> dict:
    """One LeagueTournament.run_round, checked. Returns the round stats,
    the Dynamic updates' seconds and peak device memory, and the counts."""
    device = torch.device(device)
    params, lr, lc, cuts = _league()
    if blocks is not None:
        params["num_blocks"] = blocks
        cuts.append(f"model.params.num_blocks = {blocks}")
    store = seed_store(device, tmp, params)
    dyn = DynamicTrainer(store, None, lc.dynamic, learner_lr=lr, device=device)
    tourney = LeagueTournament(store, lc, dynamic_trainer=dyn, min_epoch=0, device=device)
    tourney.max_ply, tourney.chunk_steps = max_ply, chunk_steps
    cuts += ["tournament.min_epoch = 0", f"tournament.max_ply = {max_ply}",
             f"tournament.chunk_steps = {chunk_steps}"]
    for cut in cuts:
        print(f"{label} cut {cut}")

    # what the round did, seen from outside: sequential fallbacks and each
    # Dynamic update's result, seconds and peak memory
    sequential, updates = [], []
    real_pairing, real_update = tourney._play_pairing, dyn._update_inner

    def play_pairing(a, b, epoch):
        sequential.append((a.id, b.id))
        return real_pairing(a, b, epoch)

    def update_inner(entry, seed):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        ok = real_update(entry, seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
        updates.append({"entry": entry.id, "ok": ok, "s": time.monotonic() - t0,
                        "peak_gb": peak, **(dyn.last_metrics or {})})
        return ok

    tourney._play_pairing, dyn._update_inner = play_pairing, update_inner
    pools_before = ConcurrentMatchPool.rounds_run
    dynamic_ids = [e.id for e in store.list_by_role(Role.DYNAMIC)]
    before = {eid: {k: v.float().clone() for k, v in store.load_variables(
        store.get_entry(eid)).items()} for eid in dynamic_ids}
    t0 = time.monotonic()
    stats = tourney.run_round(epoch=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    pool = next(r for k, r in tourney._runners.items() if k[0] == "__pool__")

    # -- checks ------------------------------------------------------------------
    pools_run = ConcurrentMatchPool.rounds_run - pools_before
    data = db.read_league_data(store.db_path)
    counts = {"results": len(data["results"]), "elo_rows": len(db.read_elo_history(store.db_path)),
              "game_features": len(db.read_all_game_features(store.db_path)),
              "tournament_stats": db.read_tournament_stats(store.db_path) is not None,
              "pool_rounds": pools_run, "sequential_pairings": len(sequential)}
    print(f"{label} counts {counts}")
    for u in updates:
        print(f"{label} dynamic_update entry={u['entry']} ok={u['ok']} s={u['s']:.3f} "
              f"peak_gb={u['peak_gb']} policy_loss={u.get('policy_loss')} "
              f"value_loss={u.get('value_loss')}")
    if stats["pairings_completed"] != stats["pairings_requested"] or not stats["pairings_completed"]:
        raise AssertionError(f"{label}: pairings {stats['pairings_completed']} of "
                             f"{stats['pairings_requested']}")
    if pools_run < 1 or sequential:
        raise AssertionError(f"{label}: the pool ran {pools_run} times and {len(sequential)} "
                             "pairings went down the sequential fallback")
    if not (counts["results"] and counts["elo_rows"] and counts["game_features"]
            and counts["tournament_stats"]):
        raise AssertionError(f"{label}: rows missing: {counts}")
    done = [u for u in updates if u["ok"]]
    if not done or any(not (math.isfinite(u["policy_loss"]) and math.isfinite(u["value_loss"]))
                       for u in done):
        raise AssertionError(f"{label}: no Dynamic update succeeded with finite losses: "
                             f"{updates}")
    if any(dyn._error_counts.values()):
        raise AssertionError(f"{label}: Dynamic update errors: {dyn._error_counts}")
    for eid in {u["entry"] for u in done}:
        entry = store.get_entry(eid)
        after = store.load_variables_cached(entry)
        if entry.update_count < 1 or all(torch.equal(after[k].float().cpu(), v)
                                         for k, v in before[eid].items()):
            raise AssertionError(f"{label}: entry {eid} did not change "
                                 f"(update_count {entry.update_count})")
    round_tensors = list(_tensors([list(store._cache.values()), list(dyn._opt_states.values()),
                                   [m.state_dict() for m in dyn._modules.values()],
                                   pool.core.reset_obs, pool.core.reset_mask]))
    off = {str(t.device) for t in round_tensors if t.device.type != device.type}
    if off:
        raise AssertionError(f"{label}: tensors off {device}: {sorted(off)}")
    print(f"{label} tensors_checked={len(round_tensors)} all_on={device.type}")
    plies = None
    if device.type == "cuda":
        entries = store.list_by_role(Role.RECENT_FIXED) + store.list_by_role(Role.FRONTIER_STATIC)
        plies = time_plies(pool, store, *entries[:2])
        print(f"{label} ply_ms " + " ".join(f"{k}={v:.3f}" for k, v in plies.items()))
    store.wait_for_flushes()
    return {"stats": stats, "wall_s": wall, "updates": updates, "counts": counts,
            "P": lc.concurrency.parallel_matches, "E": lc.concurrency.envs_per_match,
            "ply_ms": plies}


def run_sidecar(device, tmp: str, *, blocks: int | None = None, max_ply: int = 64,
                parallel_matches: int = 1, label: str = "tournament sidecar") -> dict:
    """TournamentDispatcher.enqueue_round, then one TournamentWorker.run_once
    (2 x parallel_matches pairings claimed), checked. Returns the seconds
    per pairing."""
    device = torch.device(device)
    params, _, lc, cuts = _league()
    if blocks is not None:
        params["num_blocks"] = blocks
        cuts.append(f"model.params.num_blocks = {blocks}")
    cuts += [f"worker.parallel_matches = {parallel_matches}",
             f"worker.tournament.max_ply = {max_ply}"]
    for cut in cuts:
        print(f"{label} cut {cut}")
    store = seed_store(device, tmp, params)
    queued = TournamentDispatcher(store, lc).enqueue_round(1)
    worker = TournamentWorker(store.db_path, store.league_dir, config=lc, store=store,
                              parallel_matches=parallel_matches, device=device)
    worker._tourney.max_ply = max_ply
    t0 = time.monotonic()
    n = worker.run_once()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    queue = db.core.fetch_all(store.db_path, "SELECT status FROM tournament_pairing_queue")
    done = sum(r["status"] == "done" for r in queue)
    results = len(db.read_league_data(store.db_path)["results"])
    health = dbq.get_worker_health(store.db_path)
    print(f"{label} queued={queued} played={n} done={done} results={results} "
          f"worker_device={health[0]['device'] if health else None} wall_s={wall:.3f}")
    if n != 2 * parallel_matches or done != n or results != n:
        raise AssertionError(f"{label}: played {n}, marked done {done}, results {results}")
    store.wait_for_flushes()
    return {"queued": queued, "played": n, "wall_s": wall, "s_per_pairing": wall / n}


def main(argv=None) -> int:
    from .league_smoke import run_league

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--blocks", type=int, default=None)
    parser.add_argument("--max-ply", type=int, default=64)
    parser.add_argument("--chunk", type=int, default=64)
    parser.add_argument("--games", type=int, default=48)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--wiring-blocks", type=int, default=8)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        r = run_round(args.device, os.path.join(tmp, "round"), blocks=args.blocks,
                      max_ply=args.max_ply, chunk_steps=args.chunk)
        print(f"tournament round_s={r['wall_s']:.3f} phase_s={r['stats']['phase_s']} "
              f"games_per_min={r['stats']['games_per_min']:.1f}")
        s = run_sidecar(args.device, os.path.join(tmp, "sidecar"), blocks=args.blocks,
                        max_ply=args.max_ply)
        print(f"tournament sidecar s_per_pairing={s['s_per_pairing']:.3f}")
        os.makedirs(os.path.join(tmp, "wiring"))
        run_league(args.device, os.path.join(tmp, "wiring"), epochs=2, games=args.games,
                   steps=args.steps, opponents=3, max_ply=args.max_ply, batch=args.batch,
                   blocks=args.wiring_blocks, label="tournament wiring",
                   tournament={"min_epoch": 1, "max_ply": args.max_ply,
                               "chunk_steps": args.chunk})
    return 0


if __name__ == "__main__":
    sys.exit(main())
