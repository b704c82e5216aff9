"""Where a self-play epoch's time goes on the card, per rollout forward, and
where a league epoch's goes (--league).

For each forward (fused bf16, int8, auto = the eager model) and each
number of games N, builds SelfPlayTrainer from configs/katago-b40c256.toml
(T=16 plies, PPO batch 256, one PPO epoch per batch), runs one warm-up
epoch and three timed epochs through `run_epoch` (medians printed, with
the three rollout times sorted) with the program's tracer on
(utils/tracing.py), and reads the rollout's two parts from the timed
epochs' spans: the mean `forward` (the rollout forward at B=N) and
`engine.step` (`EnvCore.step`), each in CUDA-event ms and in host ms up to
its last launch (a step whose host time equals its device time is
launch-bound). With --league, the same epochs of league mode instead:
SelfPlayTrainer from configs/katago-league.toml (scripts/league_smoke.py's
cuts, the config's own maintenance cadences: no snapshot falls in the
timed epochs), K=4 on the compact path (one learner forward over N/2
boards and two opponent forwards over N/4 each per ply), and the learner's
`forward` and the `engine.step` read from their spans alike.

    python -m keisei_tpu_torch.scripts.profile_rollout [--games 64 256 1024]
                                                       [--forwards fused int8] [--league]

prints the card's name and power limit, then one line per (forward, N).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from ..training.config import load_config
from ..training.loop import SelfPlayTrainer
from ..utils import tracing
from ..utils.timing import card

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "configs", "katago-b40c256.toml")
STEPS = 16
EPOCHS = 3  # timed epochs per (forward, N); the medians are printed


def timed_epochs(trainer) -> tuple[list, dict]:
    """EPOCHS epochs with the tracer on: their EpochMetrics, and the mean
    device and host ms of their `forward` and `engine.step` spans."""
    tracing.enable(events={"forward", "engine.step"})
    try:
        ems = [trainer.run_epoch() for _ in range(EPOCHS)]
    finally:
        tracing.disable()
    spans = tracing.spans()
    parts = {}
    for name, key in (("forward", "forward"), ("engine.step", "step")):
        mine = [s for s in spans if s["name"] == name]
        parts[f"{key}_ms"] = sum(s["device_ms"] for s in mine) / len(mine)
        parts[f"{key}_host_ms"] = sum(s["end_ns"] - s["start_ns"] for s in mine) / len(mine) / 1e6
    return ems, parts


def profile(forward: str, games: int, ckpt_dir: str) -> dict:
    config = load_config(CONFIG)
    tc = dataclasses.replace(config.training, rollout_forward=forward, num_games=games,
                             steps_per_epoch=STEPS, checkpoint_interval=10**9,
                             checkpoint_dir=ckpt_dir)
    ap = dataclasses.replace(config.algorithm_params, batch_size=256, epochs_per_batch=1)
    cfg = dataclasses.replace(config, training=tc, algorithm_params=ap,
                              display=dataclasses.replace(config.display, db_path=""))
    trainer = SelfPlayTrainer(cfg, device="cuda")
    trainer.run_epoch()  # warm-up: first calls, allocator, cuDNN autotuning
    ems, parts = timed_epochs(trainer)
    rollout_s = sorted(em.rollout_time for em in ems)
    return {"rollout_s": rollout_s, "update_s": sorted(em.update_time for em in ems),
            "env_steps_per_s": games * STEPS / rollout_s[EPOCHS // 2], **parts,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_league(games: int, tmp: str, opponents: int = 4) -> dict:
    from .league_smoke import league_config

    cfg, _ = league_config(tmp, games=games, steps=STEPS, opponents=opponents, max_ply=512,
                           every_epoch=False)
    trainer = SelfPlayTrainer(cfg, device="cuda")
    trainer.run_epoch()  # warm-up
    ems, parts = timed_epochs(trainer)
    trainer.drain_maintenance()
    rollout_s = sorted(em.rollout_time for em in ems)
    return {"rollout_s": rollout_s, "update_s": sorted(em.update_time for em in ems),
            "env_steps_per_s": games * STEPS / rollout_s[EPOCHS // 2], **parts,
            "forwards_per_ply": 1 + opponents // 2, "rows": STEPS // 2 + 1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def parts_line(r: dict) -> str:
    return (f"forward_ms={r['forward_ms']:.3f} forward_host_ms={r['forward_host_ms']:.3f} "
            f"env_step_ms={r['step_ms']:.3f} env_step_host_ms={r['step_host_ms']:.3f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, nargs="+", default=[64, 256, 1024])
    parser.add_argument("--forwards", nargs="+", default=["fused", "int8"],
                        choices=["fused", "int8", "auto"])
    parser.add_argument("--league", action="store_true",
                        help="league epochs (K=4, eager forwards) in place of self-play")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rollout: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    if args.league:
        for games in args.games:
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as tmp:
                r = profile_league(games, tmp)
            spread = ",".join(f"{s:.4f}" for s in r["rollout_s"])
            print(f"profile_rollout league K=4 N={games} T={STEPS} "
                  f"rollout_s={r['rollout_s'][EPOCHS // 2]:.4f} ({spread}) "
                  f"env_steps_per_s={r['env_steps_per_s']:.1f} "
                  f"forwards_per_ply={r['forwards_per_ply']} traj_rows={r['rows']} "
                  f"update_s={r['update_s'][EPOCHS // 2]:.3f} {parts_line(r)} "
                  f"peak_mem_gb={r['peak_mem_gb']:.2f}", flush=True)
        return 0
    for games in args.games:
        for forward in args.forwards:
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as tmp:
                r = profile(forward, games, tmp)
            spread = ",".join(f"{s:.4f}" for s in r["rollout_s"])
            print(f"profile_rollout forward={forward} N={games} T={STEPS} "
                  f"rollout_s={r['rollout_s'][EPOCHS // 2]:.4f} ({spread}) "
                  f"env_steps_per_s={r['env_steps_per_s']:.1f} "
                  f"update_s={r['update_s'][EPOCHS // 2]:.3f} {parts_line(r)} "
                  f"peak_mem_gb={r['peak_mem_gb']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
