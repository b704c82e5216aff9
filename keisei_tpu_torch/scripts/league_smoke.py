"""League mode end to end through SelfPlayTrainer, with its checks: the
league configuration (configs/katago-league.toml, its in-process
tournament on) at its full width with the cuts below, a few epochs of the
learner against K frozen opponents from the tiered pool and the
maintenance after each (results and Elo, learner snapshots, tier reviews,
the historical library, the gauntlet, a tournament round when one is
due), then the VecEnv host shim driven with random legal moves.

    python -m keisei_tpu_torch.scripts.league_smoke [--device cuda] [--epochs 3]
        [--games 64] [--steps 16] [--opponents 4] [--max-ply 64] [--batch 256] [--blocks N]

prints the cuts, one line per epoch, the maintenance seconds per phase and
a `league` summary line; raises if a check fails: parity mismatches,
non-finite losses, parameters that did not move, fewer than three pool
entries with weight files (after 2+ epochs), no gauntlet or Elo rows, a
tournament round that was asked for (`tournament=`) and did not complete,
or a tensor of the slice off the requested device. chip_smoke.py phase 8
calls `run_league` and `drive_vec_env`; phase 9 calls `run_league` with a
round (scripts/tournament_smoke.py).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
import tomllib

import numpy as np
import torch

from .. import db
from ..env.vec_env import VecEnv
from ..training.config import Config, config_from_dict
from ..training.loop import SelfPlayTrainer

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "configs", "katago-league.toml")


def league_config(tmp: str, *, games: int, steps: int, opponents: int, max_ply: int,
                  batch: int = 256, blocks: int | None = None, every_epoch: bool = True,
                  extra: dict | None = None) -> tuple[Config, list[str]]:
    """configs/katago-league.toml with the smoke run's cuts, and the cuts
    as `section.key = value` strings. every_epoch=False keeps the config's
    maintenance cadences (snapshots, history, gauntlet); `extra` adds cuts
    of its own (`section.key` -> value)."""
    with open(CONFIG, "rb") as f:
        raw = tomllib.load(f)
    tr, lg = raw["training"], raw["league"]
    cuts = {
        "training.num_games": games,
        "training.steps_per_epoch": steps,
        "league.opponents_per_epoch": opponents,
        "training.max_ply": max_ply,
        "training.algorithm_params.batch_size": batch,  # (T/2 + 1) * N = 576 at N=64
        "training.algorithm_params.epochs_per_batch": 1,
        "training.checkpoint_interval": 10**9,
    }
    if every_epoch:
        cuts.update({
            "league.snapshot_interval": 1,
            "league.history.refresh_interval_epochs": 1,
            "league.history.min_epoch_for_selection": 0,
            "league.gauntlet.interval_epochs": 1,
            "league.gauntlet.games_per_matchup": 2,
        })
    if blocks is not None:
        cuts["model.params.num_blocks"] = blocks
    cuts.update(extra or {})
    for key, value in cuts.items():
        section = raw
        *path, leaf = key.split(".")
        for part in path:
            section = section.setdefault(part, {})
        section[leaf] = value
    tr["checkpoint_dir"] = os.path.join(tmp, "ck")
    lg.setdefault("storage", {})["league_dir"] = os.path.join(tmp, "league")
    raw["display"]["db_path"] = os.path.join(tmp, "league.db")
    return config_from_dict(raw, source=CONFIG), [f"{k} = {v}" for k, v in cuts.items()]


def _tensors(obj):
    """Every tensor inside obj (tensors, dicts, lists, tuples, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for f in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, f))


def run_league(device: torch.device | str, tmp: str, *, epochs: int = 3, games: int = 64,
               steps: int = 16, opponents: int = 4, max_ply: int = 64, batch: int = 256,
               blocks: int | None = None, tournament: dict | None = None,
               label: str = "league") -> dict:
    """`epochs` league epochs through SelfPlayTrainer.run, checked. Returns
    the per-epoch metrics, the maintenance seconds per phase and what was
    counted in the league's database.

    The gauntlet's games end at `max_ply` (cut from its 512). `tournament`
    sets attributes of the trainer's LeagueTournament (min_epoch, max_ply,
    chunk_steps) so that a round is due and short; the run must then
    complete at least one round."""
    device = torch.device(device)
    cfg, cuts = league_config(
        tmp, games=games, steps=steps, opponents=opponents, max_ply=max_ply, batch=batch,
        blocks=blocks,
        extra=None if tournament is None else {"league.tournament_interval_epochs": 1})
    seen, rollouts = [], []
    trainer = SelfPlayTrainer(cfg, device=device, metrics_sink=seen.append)
    trainer.gauntlet.max_ply = max_ply  # so that gauntlet games end
    cuts.append(f"gauntlet.max_ply = {max_ply}")
    for key, value in (tournament or {}).items():
        setattr(trainer.tournament, key, value)
        cuts.append(f"tournament.{key} = {value}")
    for cut in cuts:
        print(f"{label} cut {cut}")
    real = trainer._rollout

    def rollout(*args, **kwargs):
        out = real(*args, **kwargs)
        rollouts.append((out[3], out[1].valid.shape[0], list(_tensors(out[:3]))))
        return out

    trainer._rollout = rollout
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    t0 = time.monotonic()
    trainer.run(epochs)
    wall = time.monotonic() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    path = "compact" if rollouts[0][1] == steps // 2 + 1 else "dynamic"
    for m, (stats, _, _) in zip(seen, rollouts):
        print(f"{label} epoch={m['epoch']} path={path} K={opponents} N={games} T={steps} "
              f"rollout_s={m['rollout_time']:.3f} update_s={m['update_time']:.3f} "
              f"env_steps_per_s={games * steps / m['rollout_time']:.1f} "
              f"policy_loss={m['policy_loss']:.4f} value_loss={m['value_loss']:.4f} "
              f"episodes={m['episodes']} parity_mismatch={stats.parity_mismatch} "
              f"opp_wdl={stats.opp_wins}/{stats.opp_losses}/{stats.opp_draws}")
    phases = dict(trainer._maint_phase_s)
    print(f"{label} maintenance_s " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()))

    # -- checks ------------------------------------------------------------------
    if len(seen) != epochs or any(s.parity_mismatch for s, _, _ in rollouts):
        raise AssertionError(f"{label}: parity mismatches or missing epochs: "
                             f"{[s.parity_mismatch for s, _, _ in rollouts]}")
    for m in seen:
        for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"{label} epoch {m['epoch']}: {k} = {m[k]}")
    if all(torch.equal(before[k], v) for k, v in trainer.model.state_dict().items()):
        raise AssertionError(f"{label}: the learner's parameters did not move")
    entries = trainer.store.list_entries()
    on_disk = [e for e in entries
               if os.path.isfile(os.path.join(e.checkpoint_path, "state.pt"))]
    db_path = trainer.store.db_path
    data = db.read_league_data(db_path)
    counts = {"entries": len(entries), "with_weights": len(on_disk),
              "gauntlet_rows": len(data["gauntlet_results"]),
              "elo_rows": len(db.read_elo_history(db_path)),
              "result_rows": len(data["results"])}
    round_stats = db.read_tournament_stats(db_path)
    if round_stats is not None:
        counts["tournament"] = {k: round_stats[k] for k in (
            "pairings_requested", "pairings_completed", "total_games", "round_duration_s")}
    print(f"{label} pool {counts}")
    if (len(on_disk) < min(3, epochs + 1) or counts["gauntlet_rows"] < 1
            or counts["elo_rows"] < 1):
        raise AssertionError(f"{label}: league bookkeeping missing: {counts}")
    if tournament is not None and (
            round_stats is None or round_stats["pairings_completed"] < 1
            or round_stats["pairings_completed"] != round_stats["pairings_requested"]):
        raise AssertionError(f"{label}: no complete tournament round: {round_stats}")
    slice_tensors = [t for _, _, ts in rollouts for t in ts]
    slice_tensors += list(_tensors([trainer.env_carry, trainer.learner_color,
                                    trainer._cohort_vars, list(trainer.store._cache.values())]))
    slice_tensors += list(trainer.model.state_dict().values())
    off = {str(t.device) for t in slice_tensors if t.device.type != device.type}
    if off:
        raise AssertionError(f"{label}: tensors off {device}: {sorted(off)}")
    print(f"{label} tensors_checked={len(slice_tensors)} all_on={device.type} wall_s={wall:.2f}")
    return {"metrics": seen, "maintenance_s": phases, "counts": counts, "path": path,
            "wall_s": wall, "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                            if device.type == "cuda" else None)}


def drive_vec_env(device: torch.device | str, games: int = 64, steps: int = 200,
                  seed: int = 0) -> dict:
    """`steps` random legal moves through the VecEnv host shim (spatial
    actions, 50 planes); returns host steps/s, episodes and env 0's SFEN."""
    env = VecEnv(games, 512, "katago", "spatial", device=device)
    masks = env.reset().legal_masks
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    for _ in range(steps):
        masks = env.step(np.array([rng.choice(np.flatnonzero(m)) for m in masks])).legal_masks
    wall = time.monotonic() - t0
    return {"steps_per_s": steps / wall, "episodes": env.episodes_completed,
            "sfen": env.get_sfen(0), "spectators": len(env.get_spectator_data())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--opponents", type=int, default=4)
    parser.add_argument("--max-ply", type=int, default=64)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--blocks", type=int, default=None)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        run_league(args.device, tmp, epochs=args.epochs, games=args.games, steps=args.steps,
                   opponents=args.opponents, max_ply=args.max_ply, batch=args.batch,
                   blocks=args.blocks)
    print(f"vec_env {drive_vec_env(args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
