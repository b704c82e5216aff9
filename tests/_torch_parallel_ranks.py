"""Helpers of the data-parallel tests (tests/test_torch_parallel*.py): ranks
spawned over gloo on the CPU, and what each rank runs. Imports no JAX, so
a spawned rank starts quickly: the parent computes the JAX references.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.multiprocessing as tmp

from keisei_tpu_torch.env.vec_env import EnvCore
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.parallel.distributed import (free_port, setup_distributed,
                                                   teardown_distributed)
from keisei_tpu_torch.parallel.mesh import Mesh, make_mesh
from keisei_tpu_torch.scripts.parallel_smoke import recorded_writes
from keisei_tpu_torch.training import ppo as P
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.league_rollout import make_league_rollout
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.training.value_adapter import get_value_adapter

TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}
ADAPTER = dict(lambda_value=1.5, lambda_score=0.1, score_blend_alpha=0.1)


# -- spawning ranks -----------------------------------------------------------------


def _entry(rank: int, target, world: int, port: int, payload, out_dir: str) -> None:
    torch.set_num_threads(1)
    setup_distributed(f"localhost:{port}", world_size=world, rank=rank, device="cpu",
                      timeout=timedelta(seconds=120))
    try:
        result = target(make_mesh(world, device="cpu"), payload)
    finally:
        teardown_distributed()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(target, world: int, payload, out_dir: str, timeout: float = 300.0) -> list:
    """target(mesh, payload) on `world` spawned CPU ranks joined over gloo;
    their results in rank order. A rank that fails or a run past `timeout`
    raises."""
    ctx = tmp.start_processes(_entry, args=(target, world, free_port(), payload, out_dir),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- models, trajectories and configs -------------------------------------------------


def tiny_model(state: dict | None = None) -> torch.nn.Module:
    model, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    if state is not None:
        model.load_state_dict(state)
    return model


def trajectory(seed: int, T: int = 4, N: int = 8, league: bool = False):
    """A random (T, N) trajectory as numpy arrays (legal actions, labels at
    terminals; with `league` a sparse `valid`), and its (N,) next values."""
    rng = np.random.default_rng(seed)
    A, C = 81 * 139, 50
    masks = rng.random((T, N, A)) < 0.02
    masks[..., 0] = True
    actions = np.array([[rng.choice(np.flatnonzero(masks[t, n])) for n in range(N)]
                        for t in range(T)])
    term = rng.random((T, N)) < 0.2
    trunc = (rng.random((T, N)) < 0.1) & ~term
    rewards = np.where(term, rng.choice([-1.0, 0.0, 1.0], size=(T, N)), 0.0).astype(np.float32)
    data = {
        "obs": (rng.random((T, N, C, 81)) < 0.2).astype(np.float32),
        "actions": actions.astype(np.int64),
        "log_probs": (-np.log(masks.sum(-1)) + rng.normal(size=(T, N)) * 0.1).astype(np.float32),
        "values": rng.uniform(-1, 1, (T, N)).astype(np.float32),
        "rewards": rewards, "dones": term | trunc, "terminated": term,
        "legal_masks": masks,
        "value_cats": np.where(term, np.where(rewards > 0, 0, np.where(rewards < 0, 2, 1)),
                               -1).astype(np.int64),
        "score_targets": (rng.normal(size=(T, N)) * 0.1).astype(np.float32),
        "next_value_override": np.where(trunc, rng.uniform(-1, 1, (T, N)),
                                        np.nan).astype(np.float32),
    }
    if league:
        valid = rng.random((T, N)) < 0.67
        for name in ("rewards", "score_targets"):
            data[name] = np.where(valid, data[name], 0.0).astype(np.float32)
        for name in ("dones", "terminated"):
            data[name] = data[name] & valid
        data["value_cats"] = np.where(valid, data["value_cats"], -1)
        data["next_value_override"] = np.where(data["dones"] & ~data["terminated"],
                                               data["next_value_override"], np.nan)
        data["valid"] = valid
    return data, rng.uniform(-1, 1, N).astype(np.float32)


def tiny_config(root: str, *, league: bool = False, num_devices: int = 2, **training):
    raw = {
        "model": {"architecture": "se_resnet", "params": dict(TINY)},
        "training": {"num_games": 8, "max_ply": 16, "steps_per_epoch": 4,
                     "checkpoint_interval": 1, "checkpoint_dir": os.path.join(root, "ck"),
                     "algorithm_params": {"batch_size": 8, "epochs_per_batch": 1},
                     **training},
        "display": {"db_path": os.path.join(root, "obs.db")},
        "distributed": {"num_devices": num_devices},
    }
    if league:
        raw["league"] = {"opponents_per_epoch": 2, "snapshot_interval": 1,
                         "tournament_enabled": True, "tournament_mode": "sidecar",
                         "tournament_interval_epochs": 1,
                         "storage": {"league_dir": os.path.join(root, "league")}}
    return config_from_dict(raw)


def state_of(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """Parameters, BatchNorm statistics and Adam moments, cloned."""
    names = {p: n for n, p in model.named_parameters()}
    adam = {names[p]: {k: v.clone() for k, v in st.items()}
            for p, st in optimizer.state.items()}
    return {"model": {k: v.clone() for k, v in model.state_dict().items()}, "adam": adam}


# -- what the ranks run ---------------------------------------------------------------


def run_update(case: dict, mesh: Mesh | None = None) -> tuple[dict, dict]:
    """One PPO update of the tiny model on `case`'s trajectory with its
    permutations; with a mesh, on this rank's columns."""
    model = tiny_model(case["state"])
    cfg = P.KataGoPPOParams(**case["cfg"])
    opt = P.make_optimizer(model, cfg)
    # a copy: Adam's state tensors would alias the case's (shared with the
    # other rank through torch.multiprocessing) and move in place
    opt.load_state_dict(copy.deepcopy(case["optimizer"]))
    traj = {k: torch.from_numpy(v) for k, v in case["traj"].items()}
    nv = torch.from_numpy(case["nv"])
    if mesh is not None:
        cols = mesh.env_slice(nv.shape[0])
        traj, nv = {k: v[:, cols] for k, v in traj.items()}, nv[cols]
    update = P.make_ppo_update(model, get_value_adapter("katago", **ADAPTER), cfg, opt, mesh)
    metrics = update(P.Trajectory(**traj), nv, None, 0.01, perms=case["perms"])
    return metrics, state_of(model, opt)


def _train(mesh: Mesh, config, epochs: int, record: bool, root: str) -> dict:
    rows = []
    with recorded_writes(root) as writes:
        trainer = SelfPlayTrainer(config, device="cpu", mesh=mesh,
                                  metrics_sink=lambda m: rows.append(
                                      (m, dataclasses.asdict(trainer.rollout_stats_local))))
        trainer.run(epochs)
        trainer.close()
    out = {"swap": _swap_last_block(trainer) if trainer.league_enabled else None}
    out.update({"state": state_of(trainer.model, trainer.optimizer), "epochs": rows,
           "writes": writes if record else None, "generator": trainer.generator.get_state(),
           "store": trainer.store is not None if trainer.league_enabled else None,
           "cohort": trainer._cohort_vars if trainer.league_enabled else None})
    return out


def _swap_last_block(trainer: SelfPlayTrainer) -> dict:
    """Two cohorts in a row that differ in slot K-1 only, sampled by rank 0
    (the oldest pool entry everywhere, then the newest in slot K-1): which
    of this rank's envs the second one restarted, the keys every rank
    received, and the colors after."""
    if trainer.is_main:
        entries = sorted(trainer.store.list_entries(), key=lambda e: (e.created_epoch, e.id))
        cohorts = iter([[entries[0]] * trainer.K, [entries[0]] * (trainer.K - 1) + [entries[-1]]])
        trainer._sample_cohort = lambda: next(cohorts)
    trainer._cohort_for_epoch()
    states, obs, masks = trainer.env_carry
    trainer.env_carry = (states, obs + 7, masks)  # marks every env; a reset clears it
    trainer._cohort_for_epoch()
    fresh = trainer.env_core.init()[1]
    return {"reset": [bool(torch.equal(a, f)) for a, f in zip(trainer.env_carry[1], fresh)],
            "keys": trainer._cohort_key, "color": trainer.learner_color.clone()}


def session(mesh: Mesh, payload: dict) -> dict:
    """Everything test_torch_parallel.py asks of two ranks, in one spawn."""
    out = {"updates": {name: run_update(case, mesh)
                       for name, case in payload["updates"].items()}}
    root = payload["root"]
    out["selfplay"] = _train(mesh, tiny_config(os.path.join(root, "sp")), 2, mesh.rank == 1,
                             root)
    out["league"] = _train(mesh, tiny_config(os.path.join(root, "lg"), league=True), 2,
                           mesh.rank == 1, root)
    resumed = SelfPlayTrainer(tiny_config(payload["w1_root"]), device="cpu", mesh=mesh)
    out["resumed"] = {"state": state_of(resumed.model, resumed.optimizer),
                      "epoch": resumed.epoch, "generator": resumed.generator.get_state(),
                      "rollout_generator": resumed.rollout_generator.get_state()}
    resumed.close()
    return out


def league_rollout(case: dict, mesh: Mesh) -> dict:
    """This rank's league rollout of `case`, JAX's draws replayed: the
    sampler hands each forward the columns of its recorded draw that lie
    on this rank. Returns the rank's trajectory, next values, carry and
    its own (local) and the summed LeagueStats."""
    N, T, K, max_ply, cr = case["N"], case["T"], case["K"], case["max_ply"], case["cr"]
    cols = mesh.env_slice(N)
    model, _ = build_model("se_resnet", case["model_params"])
    model.load_state_dict(case["learner"])
    # the opponents play on bf16 weights, as in the reference harness
    stacked = {k: v.to(torch.bfloat16) for k, v in case["stacked"].items()}
    env = EnvCore(cols.stop - cols.start, max_ply, 50, device="cpu")
    roll = make_league_rollout(env, model, get_value_adapter("katago", **ADAPTER), T, K,
                               color_randomization=cr, mesh=mesh)
    draws = case["draws"]  # {(ply, seat, block): (global lo, hi, actions)}
    calls = []

    def take(key, rows):
        lo, hi, values = draws[key]
        a, b = max(lo, cols.start), min(hi, cols.stop)
        assert b - a == rows, (key, a, b, rows)
        return torch.from_numpy(values[a - lo:b - lo].astype(np.int64))

    def sampler(ply, seat, block, masks):
        calls.append((ply, seat, block))
        return take((ply, seat, block), masks.shape[0])

    def recolor(ply):
        return take((ply, "color", None), cols.stop - cols.start).int()

    colors = torch.from_numpy(np.asarray(case["colors"])[cols])
    (es, obs, masks, color), traj, nv, stats = roll(stacked, *env.init(), colors, None,
                                                    sampler=sampler, recolor=recolor)
    return {"traj": {f.name: getattr(traj, f.name) for f in dataclasses.fields(traj)},
            "nv": nv, "obs": obs, "masks": masks, "color": color, "local": stats,
            "summed": stats.summed(mesh), "calls": calls}


def league_rollouts(mesh: Mesh, cases: dict) -> dict:
    return {name: league_rollout(case, mesh) for name, case in cases.items()}


def simulated_mesh(rank: int, world: int) -> Mesh:
    """One rank's columns of a `world`-rank layout, run in this process
    with no group (the rollout is column-separable)."""
    return Mesh(world_size=world, rank=rank, local_world_size=world)
