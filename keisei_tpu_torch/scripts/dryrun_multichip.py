"""The multi-device dry run of the port (twin of __graft_entry__.dryrun_multichip).

Spawns W ranks (one process each, joined in a process group) and checks,
on tiny shapes, the pieces of data-parallel training that the JAX package
checks over its n-device mesh:

1. a train step: each rank's self-play rollout on its 2 envs, then the
   update over the W ranks (global BatchNorm, gradients summed in one
   bucket); the parameters stay the same bits on every rank;
2. the league split-merge rollout (K = 2 bf16 opponents, parity colors
   sharded) and an update on its trajectory;
3. a checkpoint saved by rank 0 at W ranks, restored exactly into one
   process's model (W = 1), restored on every rank and trained on;
4. with W >= 4: learner ranks [0, W-2) train while rank W-2 plays a
   tournament round of 3 pairings claimed from the DB queue on its own
   card (the learner ranks ∥ a tournament device).

    python -m keisei_tpu_torch.scripts.dryrun_multichip [--ranks 2] [--device cuda|cpu]
        [--backend nccl|gloo] [--share-card]

`--share-card` puts every rank on cuda:0 (with gloo: NCCL refuses two
ranks on one card); otherwise rank r takes cuda:r. Raises if a check fails;
prints one line per part.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..env.vec_env import EnvCore
from ..models.registry import build_model
from ..parallel.distributed import free_port, process_seed, setup_distributed, teardown_distributed
from ..parallel.mesh import Mesh, make_mesh, replicate, shard_env_batch
from ..training.checkpoint import load_checkpoint, save_checkpoint
from ..training.league_rollout import make_league_rollout, parity_colors
from ..training.ppo import KataGoPPOParams, make_optimizer, make_ppo_update
from ..training.rollout import make_selfplay_rollout
from ..training.value_adapter import get_value_adapter

TINY = {"num_blocks": 1, "channels": 16, "se_reduction": 4, "global_pool_channels": 8,
        "policy_channels": 4, "value_fc_size": 16, "score_fc_size": 8}
T = 4


def _model(seed: int, dev: torch.device) -> torch.nn.Module:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _ = build_model("se_resnet", TINY)
    return model.to(dev)


def _same_on_every_rank(mesh: Mesh, model: torch.nn.Module) -> bool:
    """Whether every rank holds the same bits of the model's state."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in model.state_dict().values()])
    return bool(torch.equal(mesh.all_gather(flat[None], dim=0),
                            flat[None].expand(mesh.world_size, -1)))


def _train_step(mesh: Mesh, model, update, rollout_gen, update_gen) -> float:
    env = EnvCore(2, 16, 50, mesh.device)
    rollout = make_selfplay_rollout(env, model, update.adapter, T)
    _, traj, nv, _ = rollout(*env.init(), rollout_gen)
    return update(traj, nv, update_gen, 0.01)["policy_loss"]


def _rank(rank: int, world: int, port: int, platform: str, backend: str | None,
          share_card: bool, out_dir: str) -> None:
    dev = torch.device("cpu") if platform == "cpu" else torch.device(
        "cuda", 0 if share_card else rank)
    setup_distributed(f"localhost:{port}", world_size=world, rank=rank, device=dev,
                      backend=backend)
    try:
        losses = _dryrun(make_mesh(world, device=dev), out_dir)
    finally:
        teardown_distributed()
    if rank == 0:
        torch.save({"ranks": world, "losses": losses}, os.path.join(out_dir, "report.pt"))


def _dryrun(mesh: Mesh, out_dir: str) -> dict:
    dev, W, rank = mesh.device, mesh.world_size, mesh.rank
    N = 2 * W
    adapter = get_value_adapter("katago")
    cfg = KataGoPPOParams(batch_size=N * T // 2, epochs_per_batch=1)
    model = _model(0, dev)
    replicate(mesh, model)
    opt = make_optimizer(model, cfg)
    update = make_ppo_update(model, adapter, cfg, opt, mesh)
    rollout_gen = torch.Generator(dev).manual_seed(process_seed(1, rank))
    update_gen = torch.Generator(dev).manual_seed(2)
    losses = {}

    # 1. the train step
    losses["train"] = _train_step(mesh, model, update, rollout_gen, update_gen)
    if not torch.isfinite(torch.tensor(losses["train"])) or not _same_on_every_rank(mesh, model):
        raise RuntimeError(f"train step: loss {losses['train']} or ranks diverged")
    if rank == 0:
        print(f"dryrun_multichip({W}): train step ok, policy_loss={losses['train']:.4f}")

    # 2. the league split-merge, K = 2 bf16 opponents
    K = 2
    opps = [_model(10 + i, dev).state_dict() for i in range(K)]
    stacked = {k: torch.stack([o[k] for o in opps]).to(torch.bfloat16) for k in opps[0]}
    env = EnvCore(2, 16, 50, dev)
    league = make_league_rollout(env, model, adapter, T, K, mesh=mesh)
    colors = shard_env_batch(mesh, parity_colors(N, dev))
    _, traj, nv, stats = league(stacked, *env.init(), colors, rollout_gen)
    stats = stats.summed(mesh)
    losses["league"] = update(traj, nv, update_gen, 0.01)["policy_loss"]
    if stats.parity_mismatch or not torch.isfinite(torch.tensor(losses["league"])):
        raise RuntimeError(f"league split-merge: mismatch {stats.parity_mismatch}, "
                           f"loss {losses['league']}")
    if rank == 0:
        print(f"dryrun_multichip({W}): league split-merge ok, policy_loss={losses['league']:.4f}")

    # 3. checkpoint: rank 0 writes at W ranks; W = 1 and every rank restore it
    ck = os.path.join(out_dir, "ck")
    if rank == 0:
        save_checkpoint(ck, model, opt, epoch=1, architecture="se_resnet",
                        generator=update_gen)
    mesh.barrier()
    fresh = _model(9, dev)
    fresh_opt = make_optimizer(fresh, cfg)
    load_checkpoint(ck, fresh, fresh_opt, torch.Generator(dev), architecture="se_resnet")
    want = model.state_dict()
    if rank == 0 and not all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items()):
        raise RuntimeError("checkpoint restored at W = 1 differs from the W-rank state")
    resumed = make_ppo_update(fresh, adapter, cfg, fresh_opt, mesh)
    losses["resumed"] = _train_step(mesh, fresh, resumed, rollout_gen, update_gen)
    if not torch.isfinite(torch.tensor(losses["resumed"])) or not _same_on_every_rank(mesh,
                                                                                       fresh):
        raise RuntimeError(f"resumed step: loss {losses['resumed']} or ranks diverged")
    if rank == 0:
        print(f"dryrun_multichip({W}): checkpoint save at W={W}, restore at W=1 exact, "
              f"resumed policy_loss={losses['resumed']:.4f}")

    # 4. learner ranks ∥ a tournament device
    if W >= 4:
        losses.update(_role_split(mesh, cfg, adapter, out_dir))
    return losses


def _role_split(mesh: Mesh, cfg, adapter, out_dir: str) -> dict:
    """Ranks [0, W-2) train as a learner group while rank W-2 claims and
    plays a 3-pairing round from the DB queue on its own card."""
    n_learner = mesh.world_size - 2
    sub = dist.new_group(list(range(n_learner)))  # every rank enters new_group
    out = {}
    if mesh.rank < n_learner:
        lm = Mesh(world_size=n_learner, rank=mesh.rank, device=mesh.device, group=sub)
        model = _model(0, mesh.device)
        opt = make_optimizer(model, cfg)
        update = make_ppo_update(model, adapter, cfg, opt, lm)
        out["learner"] = _train_step(lm, model, update,
                                     torch.Generator(mesh.device).manual_seed(3 + mesh.rank),
                                     torch.Generator(mesh.device).manual_seed(4))
    elif mesh.rank == n_learner:
        out["played"] = float(_tournament_round(mesh.device, out_dir))
    mesh.barrier()
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.world_size}): role split ok, learner ranks "
              f"[0, {n_learner}) ∥ a 3-pairing round on rank {n_learner}'s device")
    return out


def _tournament_round(dev: torch.device, out_dir: str) -> int:
    from .. import db
    from ..db import queue as dbq
    from ..league.config import ConcurrencyConfig, LeagueConfig
    from ..league.store import OpponentStore, Role
    from ..league.tournament import TournamentDispatcher
    from ..league.worker import TournamentWorker

    root = os.path.join(out_dir, "role-split")
    store = OpponentStore(os.path.join(root, "l.db"), os.path.join(root, "league"), device=dev)
    for i in range(3):
        store.add_entry(_model(20 + i, dev).state_dict(), architecture="se_resnet",
                        model_params=dict(TINY), created_epoch=0, role=Role.FRONTIER_STATIC)
    lc = LeagueConfig(tournament_enabled=True, tournament_num_envs=2,
                      concurrency=ConcurrencyConfig(parallel_matches=1))
    if TournamentDispatcher(store, lc).enqueue_round(epoch=3) != 3:
        raise RuntimeError("the dispatcher did not queue 3 pairings")
    worker = TournamentWorker(store.db_path, store.league_dir, config=lc,
                              worker_id="dryrun-split", parallel_matches=1, store=store,
                              device=dev)
    worker._tourney.max_ply = 32
    played = 0
    while got := worker.run_once():
        played += got
    results = db.read_league_data(store.db_path)["results"]
    if played != 3 or dbq.get_active_queue_depth(store.db_path) or len(results) != 3:
        raise RuntimeError(f"worker played {played}/3 pairings, {len(results)} results")
    return played


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend: str | None = None,
                     share_card: bool = False) -> dict:
    """Run the dry run over `n_ranks` spawned ranks; returns rank 0's
    report {"ranks", "losses", "seconds"}. A rank's failure raises here."""
    platform = torch.device(device).type
    if platform == "cuda" and not share_card and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"{n_ranks} ranks need {n_ranks} cards "
                         f"({torch.cuda.device_count()} visible); --share-card with gloo "
                         "puts them all on cuda:0")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.start_processes(
            _rank, args=(n_ranks, free_port(), platform, backend, share_card, out_dir),
            nprocs=n_ranks, start_method="spawn")
        report = torch.load(os.path.join(out_dir, "report.pt"), weights_only=True)
    report["seconds"] = time.monotonic() - t0
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: the device's)")
    parser.add_argument("--share-card", action="store_true")
    args = parser.parse_args(argv)
    report = dryrun_multichip(args.ranks, args.device, args.backend, args.share_card)
    print(f"dryrun_multichip({report['ranks']}): {report['seconds']:.1f} s, "
          f"losses {report['losses']}")


if __name__ == "__main__":
    main()
