"""Where a self-play epoch's time goes on the card, per rollout forward, and
where a league epoch's goes (--league).

For each forward (fused bf16, int8, auto = the eager model) and each
number of games N, builds SelfPlayTrainer from configs/katago-b40c256.toml
(T=16 plies, PPO batch 256, one PPO epoch per batch), runs one warm-up
epoch and three timed epochs through `run_epoch` (medians printed, with
the three rollout times sorted), then times the rollout's two parts apart
with CUDA events: one forward of the trainer's rollout forward at B=N, and one
`EnvCore.step` with random legal actions, also on the host clock up to its
last launch (a step whose enqueue time equals its device time is
launch-bound). With --league, the same epochs of league mode instead:
SelfPlayTrainer from configs/katago-league.toml (scripts/league_smoke.py's
cuts, the config's own maintenance cadences: no snapshot falls in the
timed epochs), K=4 on the compact path (one learner forward over N/2
boards and two opponent forwards over N/4 each per ply).

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
import time

import torch

from ..models.fused_infer import make_fused_forward, make_quantized_forward
from ..training.config import load_config
from ..training.loop import SelfPlayTrainer
from ..training.rollout import EagerForward
from ..utils.timing import card, cuda_ms

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "configs", "katago-b40c256.toml")
STEPS = 16
EPOCHS = 3  # timed epochs per (forward, N); the medians are printed


def enqueue_ms(fn, iters: int = 20) -> float:
    """Host time per call of fn() up to the last launch, before the device
    is waited for. Beside cuda_ms: equal means the host (launches, syncs
    inside fn) is what the device waits on."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


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
    ems = [trainer.run_epoch() for _ in range(EPOCHS)]
    rollout_s = sorted(em.rollout_time for em in ems)
    update_s = sorted(em.update_time for em in ems)

    fwd = {"fused": make_fused_forward, "int8": make_quantized_forward,
           "auto": lambda _: EagerForward()}[forward](trainer.model_cfg)
    weights = fwd.prepare(trainer.model)
    states, obs, masks = trainer.env_carry
    obs = obs.reshape(games, -1, 9, 9)
    forward_ms = cuda_ms(lambda: fwd(weights, obs))
    g = torch.Generator(device="cuda").manual_seed(0)
    actions = torch.multinomial(masks.float(), 1, generator=g)[:, 0]
    step_ms = cuda_ms(lambda: trainer.env_core.step(states, actions))
    step_host_ms = enqueue_ms(lambda: trainer.env_core.step(states, actions))
    return {"rollout_s": rollout_s, "update_s": update_s,
            "env_steps_per_s": games * STEPS / rollout_s[EPOCHS // 2],
            "forward_ms": forward_ms, "step_ms": step_ms, "step_host_ms": step_host_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_league(games: int, tmp: str, opponents: int = 4) -> dict:
    from .league_smoke import league_config

    cfg, _ = league_config(tmp, games=games, steps=STEPS, opponents=opponents, max_ply=512,
                           every_epoch=False)
    trainer = SelfPlayTrainer(cfg, device="cuda")
    trainer.run_epoch()  # warm-up
    ems = [trainer.run_epoch() for _ in range(EPOCHS)]
    trainer.drain_maintenance()
    rollout_s = sorted(em.rollout_time for em in ems)
    return {"rollout_s": rollout_s, "update_s": sorted(em.update_time for em in ems),
            "env_steps_per_s": games * STEPS / rollout_s[EPOCHS // 2],
            "forwards_per_ply": 1 + opponents // 2, "rows": STEPS // 2 + 1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


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
                  f"update_s={r['update_s'][EPOCHS // 2]:.3f} "
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
                  f"update_s={r['update_s'][EPOCHS // 2]:.3f} forward_ms={r['forward_ms']:.3f} "
                  f"env_step_ms={r['step_ms']:.3f} env_step_enqueue_ms={r['step_host_ms']:.3f} "
                  f"peak_mem_gb={r['peak_mem_gb']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
