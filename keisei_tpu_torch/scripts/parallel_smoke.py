"""Data parallelism on one card, with its checks (chip_smoke.py phase 12).

One card cannot hold two NCCL ranks, so the multi-rank path runs as two
ranks sharing the card over gloo (gloo carries the card's tensors through
the host), and the NCCL path at world size 1:

(a) two ranks on one card over gloo: configs/katago-league-multihost.toml
    at full width, cut in scale (the cuts are printed: 64 global games,
    16 plies, batch 256, 1 PPO epoch, K = 4, tournament rounds only
    enqueued), 2 league epochs; then 2 self-play epochs of
    configs/katago-b40c256.toml at num_devices = 2. Hard gates: parameters,
    BatchNorm statistics and Adam moments the same bits on both ranks after
    every epoch; equal losses and equal global counts on both ranks, each
    the sum of the ranks' own; parity_mismatch 0; rank 1 wrote nothing;
    every tensor on the device, finite losses, parameters moved; the first
    minibatch's gradient of a float32 twin of the model, summed over the
    ranks, within F32_L2_REL of one process's on the same rows; the W = 2
    checkpoint resumes in a W = 1 trainer with the same parameters. The
    bf16 model's distance is printed, not gated: at 40 blocks one process
    moves its own bf16 gradient ~45% by reordering its rows, so no bf16
    tolerance separates a fault from summation order. Beside it go the
    readings of that reorder shift that tell its causes apart: with the
    PPO clip turned off, and cut to PROBE_BLOCKS blocks.
(b) NCCL at world size 1: one self-play epoch of b40c256 (64 games) with
    the update's collectives on NCCL; the gradient bucket's all-reduce
    timed, and the collectives per minibatch counted.
(c) scripts/dryrun_multichip.py at two ranks over gloo on the card.

    python -m keisei_tpu_torch.scripts.parallel_smoke [--device cuda] [--games 64]
        [--steps 16] [--batch 256] [--blocks N]

prints the cuts, a line per rank and epoch (rollout and update seconds,
peak GB of the rank's process) and a summary; raises if a check fails.
On the CPU (`--device cpu`, a rehearsal at a cut depth) (b) runs gloo.
Neither part measures the speed of several cards.
"""

from __future__ import annotations

import argparse
import builtins
import contextlib
import dataclasses
import math
import os
import shutil
import sqlite3
import sys
import tempfile
import time
import tomllib
from datetime import timedelta

import torch

from ..models.registry import build_model
from ..models.se_resnet import FlaxBatchNorm
from ..parallel.distributed import free_port, setup_distributed, teardown_distributed
from ..parallel.mesh import Mesh, make_mesh
from ..training.config import config_from_dict
from ..training.loop import SelfPlayTrainer
from ..training.ppo import PPOUpdate, make_optimizer
from .dryrun_multichip import dryrun_multichip
from .league_smoke import _tensors

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                       "configs")
# the float32 twin's gradient summed over two ranks against one process's
# on the same rows: ||diff|| / ||g|| at most F32_L2_REL
F32_L2_REL = 1e-2
# the depth of the cut copy whose reorder shift is read beside the whole model's
PROBE_BLOCKS = 4


@contextlib.contextmanager
def recorded_writes(root: str):
    """Every attempt of this process to write a file under `root` (the
    run's DB, checkpoints and league live there), as (call, path): open()
    for writing, torch.save, sqlite3.connect, os.replace / makedirs /
    remove, shutil.rmtree."""
    writes: list[tuple[str, str]] = []
    patched = []
    root = os.path.realpath(root)

    def under_root(path) -> bool:
        return isinstance(path, (str, os.PathLike)) and os.path.realpath(path).startswith(root)

    def patch(obj, name, pred=lambda *a, **k: True):
        orig = getattr(obj, name)

        def wrapper(*a, **k):
            if a and under_root(a[0]) and pred(*a, **k):
                writes.append((name, str(a[0])))
            return orig(*a, **k)

        setattr(obj, name, wrapper)
        patched.append((obj, name, orig))

    patch(builtins, "open", lambda f, mode="r", *a, **k: any(c in mode for c in "wax+"))
    patch(torch, "save")
    patch(sqlite3, "connect")
    for name in ("replace", "makedirs", "remove"):
        patch(os, name)
    patch(shutil, "rmtree")
    try:
        yield writes
    finally:
        for obj, name, orig in reversed(patched):
            setattr(obj, name, orig)


def config(name: str, tmp: str, *, games: int, steps: int, batch: int, blocks: int | None,
           num_devices: int, league: bool, checkpoint_interval: int = 1) -> tuple:
    """configs/<name>.toml cut in scale (and in depth with `blocks`), its
    paths under tmp; (Config, cuts as strings)."""
    with open(os.path.join(CONFIGS, f"{name}.toml"), "rb") as f:
        raw = tomllib.load(f)
    cuts = {"training.num_games": games, "training.steps_per_epoch": steps,
            "training.algorithm_params.batch_size": batch,
            "training.algorithm_params.epochs_per_batch": 1,
            "training.checkpoint_interval": checkpoint_interval,
            "distributed.num_devices": num_devices}
    if league:
        cuts.update({"league.opponents_per_epoch": 4, "league.tournament_interval_epochs": 1})
    if blocks is not None:
        cuts["model.params.num_blocks"] = blocks
    for key, value in cuts.items():
        section = raw
        *path, leaf = key.split(".")
        for part in path:
            section = section.setdefault(part, {})
        section[leaf] = value
    raw["training"]["checkpoint_dir"] = os.path.join(tmp, "ck")
    raw.setdefault("display", {})["db_path"] = os.path.join(tmp, "obs.db")
    if league:
        raw["league"].setdefault("storage", {})["league_dir"] = os.path.join(tmp, "league")
    return config_from_dict(raw, source=name), [f"{k} = {v}" for k, v in cuts.items()]


def bit_checksums(tensors: list[torch.Tensor], device) -> torch.Tensor:
    """(n, 2) int64 on `device`: per tensor, the sum of its elements' bit
    patterns and a position-weighted sum; equal rows mean equal bits
    (up to a collision of both sums)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    rows = []
    for t in tensors:
        bits = t.detach().reshape(-1).contiguous().view(ints[t.element_size()]).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]).to(device))
    return torch.stack(rows)


def state_tensors(trainer: SelfPlayTrainer) -> list[torch.Tensor]:
    """Parameters, BatchNorm statistics and Adam moments, in a fixed order."""
    out = list(trainer.model.state_dict().values())
    for p in trainer.model.parameters():
        st = trainer.optimizer.state.get(p, {})
        out += [st[k] for k in ("exp_avg", "exp_avg_sq", "step") if k in st]
    return out


def _same_on_ranks(mesh: Mesh, x: torch.Tensor) -> bool:
    got = mesh.all_gather(x[None], dim=0)
    return bool((got == x[None]).all())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"phase12 check failed: {what}")


def _grad_check(trainer: SelfPlayTrainer, batch: int) -> dict | None:
    """The first minibatch's gradient summed over the ranks against one
    process's on the same rows, from the same parameters, for the trainer's
    bf16 model and for a float32 twin of it (`l2_rel`, `max_rel`). Beside
    each, the one process's own change when only the order of its rows
    (and so of its sums) changes (`reorder_l2_rel`), also with the PPO clip
    turned off (`reorder_l2_rel_noclip`: no row can cross the clip's
    boundary) and for a copy cut to PROBE_BLOCKS blocks (`cut_blocks`) with the same
    weights where they exist (`reorder_l2_rel_cut`). BatchNorm statistics
    are restored after every pass. Rank 0 returns the readings."""
    dev, mesh = trainer.device, trainer.mesh
    _, traj, nv, _ = trainer._rollout(*trainer.env_carry, trainer.rollout_generator)
    update: PPOUpdate = trainer._update
    data = update.prepare(traj, nv)
    S = data["advantages"].shape[0]
    ix = torch.randperm(S, generator=torch.Generator(dev).manual_seed(0), device=dev)[:batch]
    arch, params = trainer.config.model.architecture, trainer.config.model.params
    noclip = dataclasses.replace(update.cfg, clip_epsilon=1e9)
    cut = min(PROBE_BLOCKS, params["num_blocks"])

    def twin(**change) -> torch.nn.Module:
        model, _ = build_model(arch, {**params, **change})
        missing, _ = model.load_state_dict(trainer.model.state_dict(), strict=False)
        _check(not missing, f"the cut copy lacks {missing[:3]}")
        return model.to(dev)

    def grads(model, cfg, rows: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        opt = make_optimizer(model, cfg)
        upd = PPOUpdate(model, trainer.adapter, cfg, opt, mesh)
        buffers = {k: v.clone() for k, v in model.named_buffers()}
        model.train()
        upd.backward(data, rows, 0.01)
        g = torch.cat([p.grad.reshape(-1) for p in upd.params])
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(buffers[k])
        return g

    def shift(model, cfg) -> float:
        one, reordered = grads(model, cfg, ix), grads(model, cfg, ix.flip(0))
        return float((reordered - one).norm() / one.norm())

    out = {}
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        model = trainer.model if name == "bf16" else twin(dtype=dtype)
        summed = grads(model, update.cfg, ix, mesh)
        if mesh.is_main:
            one = grads(model, update.cfg, ix)
            out[name] = {"l2_rel": float((summed - one).norm() / one.norm()),
                         "max_rel": float((summed - one).abs().max() / one.abs().max()),
                         "reorder_l2_rel": shift(model, update.cfg),
                         "reorder_l2_rel_noclip": shift(model, noclip),
                         "reorder_l2_rel_cut": shift(twin(dtype=dtype, num_blocks=cut),
                                                     update.cfg),
                         "cut_blocks": cut}
        del model
    return out


def _epochs(trainer: SelfPlayTrainer, epochs: int, label: str) -> list[dict]:
    """`epochs` epochs with the per-epoch gates; one row per epoch."""
    mesh = trainer.mesh
    rows = []
    for _ in range(epochs):
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(trainer.device)
        em = trainer.run_epoch()
        local = trainer.rollout_stats_local
        base = local.base if hasattr(local, "base") else local
        counts = torch.tensor([em.episodes, em.wins_black, em.wins_white, em.draws,
                               em.truncated], device=trainer.device)
        mine = torch.tensor([base.episodes, base.wins_black, base.wins_white, base.draws,
                             base.truncated], device=trainer.device)
        losses = torch.tensor([em.policy_loss, em.value_loss, em.score_loss, em.entropy,
                               em.gradient_norm], dtype=torch.float64, device=trainer.device)
        _check(bool(torch.isfinite(losses).all()), f"{label}: non-finite losses {losses}")
        _check(_same_on_ranks(mesh, losses), f"{label}: losses differ across ranks")
        _check(_same_on_ranks(mesh, counts), f"{label}: global counts differ across ranks")
        _check(bool((mesh.all_gather(mine[None], 0).sum(0) == counts).all()),
               f"{label}: global counts are not the sum of the ranks' own")
        if hasattr(local, "parity_mismatch"):
            _check(local.parity_mismatch == 0, f"{label}: parity mismatch")
        _check(_same_on_ranks(mesh, bit_checksums(state_tensors(trainer), trainer.device)),
               f"{label}: parameters, BatchNorm statistics or Adam moments differ across ranks")
        peak = (torch.cuda.max_memory_allocated(trainer.device) / 1e9
                if trainer.device.type == "cuda" else float("nan"))
        row = {"epoch": em.epoch, "rank": mesh.rank, "rollout_s": em.rollout_time,
               "update_s": em.update_time, "peak_gb": peak, "policy_loss": em.policy_loss,
               "episodes": em.episodes}
        print(f"{label} rank={mesh.rank} epoch={em.epoch} rollout_s={em.rollout_time:.3f} "
              f"update_s={em.update_time:.3f} peak_gb={peak:.2f} policy={em.policy_loss:.4f} "
              f"episodes={em.episodes} (own {base.episodes})", flush=True)
        rows.append(row)
    return rows


def _on_device(trainer: SelfPlayTrainer) -> bool:
    """Parameters, BatchNorm statistics, Adam moments (not Adam's step
    counts, which PyTorch keeps on the host), the env carry, and in league
    mode the learner colors and the cohort, all on the trainer's device."""
    tensors = [t for t in state_tensors(trainer) if t.dim() > 0]
    tensors += list(_tensors(trainer.env_carry))
    if trainer.league_enabled:
        tensors += [trainer.learner_color, *trainer._cohort_vars.values()]
    return all(t.device.type == trainer.device.type for t in tensors)


def _two_ranks_body(mesh: Mesh, args: dict) -> dict:
    """What each of the two ranks runs in (a)."""
    dev, tmp = mesh.device, args["tmp"]
    out = {"rank": mesh.rank}
    with recorded_writes(tmp) as writes:
        for name, league in (("katago-league-multihost", True), ("katago-b40c256", False)):
            label = f"{args['label']}a {'league' if league else 'selfplay'}"
            cfg, cuts = config(name, os.path.join(tmp, name), games=args["games"],
                               steps=args["steps"], batch=args["batch"],
                               blocks=args["blocks"], num_devices=2, league=league)
            if mesh.is_main:
                for cut in cuts:
                    print(f"{label} cut {cut}", flush=True)
            trainer = SelfPlayTrainer(cfg, device=dev, mesh=mesh)
            start = bit_checksums(list(trainer.model.parameters()), dev)
            if not league:
                out["grad"] = _grad_check(trainer, args["batch"])
            rows = _epochs(trainer, 2, label)
            _check(_on_device(trainer), f"{label}: a tensor of the slice is off {dev}")
            moved = bit_checksums(list(trainer.model.parameters()), dev)
            _check(bool((moved != start).any()), f"{label}: the parameters did not move")
            if league:
                _check(trainer.store is not None if mesh.is_main else trainer.store is None,
                       f"{label}: only rank 0 owns the league store")
                trainer.drain_maintenance()
            path = trainer.save()
            out[name] = {"rows": rows, "checkpoint": path,
                         "final": bit_checksums(list(trainer.model.state_dict().values()),
                                                "cpu")}
            trainer.close()
            del trainer
    out["writes"] = writes
    if mesh.rank == 1:
        _check(writes == [], f"rank 1 wrote {writes[:5]}")
    return out


def _two_ranks_entry(rank: int, port: int, platform: str, args: dict) -> None:
    dev = torch.device("cuda", 0) if platform == "cuda" else torch.device("cpu")
    setup_distributed(f"localhost:{port}", world_size=2, rank=rank, device=dev,
                      backend="gloo", timeout=timedelta(minutes=5))
    try:
        out = _two_ranks_body(make_mesh(2, device=dev), args)
    finally:
        teardown_distributed()
    torch.save(out, os.path.join(args["tmp"], f"rank{rank}.pt"))


def _nccl_world_one(dev: torch.device, tmp: str, args: dict) -> dict:
    """(b): one self-play epoch with the update's collectives on NCCL at
    world size 1 (gloo on the CPU); the bucket's all-reduce timed."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    setup_distributed(f"localhost:{free_port()}", world_size=1, rank=0, device=dev,
                      backend=backend)
    try:
        mesh = make_mesh(1, device=dev)
        cfg, _ = config("katago-b40c256", os.path.join(tmp, "b"), games=args["games"],
                        steps=args["steps"], batch=args["batch"], blocks=args["blocks"],
                        num_devices=1, league=False, checkpoint_interval=10**9)
        trainer = SelfPlayTrainer(cfg, device=dev, mesh=mesh)
        mesh.collectives.clear()
        em = trainer.run_epoch()
        _check(math.isfinite(em.policy_loss), f"(b) non-finite loss {em.policy_loss}")
        update: PPOUpdate = trainer._update
        minibatches = args["games"] * args["steps"] // args["batch"]
        bn_layers = sum(isinstance(m, FlaxBatchNorm) for m in trainer.model.modules())
        # an epoch: the rollout's counts (1 all-reduce), the trajectory's
        # gathers (f32, int64 and byte fields, next values), and per minibatch
        # the gradient bucket plus each BatchNorm layer forward and backward
        counts = dict(mesh.collectives)
        per_mb = (counts["all_reduce"] - 1) / minibatches
        _check(per_mb == 1 + 2 * bn_layers and mesh.collectives["all_gather"] == 4,
               f"(b) collectives {dict(mesh.collectives)} over {minibatches} minibatches "
               f"with {bn_layers} BatchNorm layers")
        flat = update.bucket.flat
        reps = 10
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            mesh.all_reduce_(flat)
            start.record()
            for _ in range(reps):
                mesh.all_reduce_(flat)
            end.record()
            torch.cuda.synchronize(dev)
            bucket_ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                mesh.all_reduce_(flat)
            bucket_ms = (time.perf_counter() - t0) / reps * 1e3
        trainer.close()
        return {"backend": backend, "update_s": em.update_time, "rollout_s": em.rollout_time,
                "minibatches": minibatches, "collectives": counts,
                "all_reduce_per_minibatch": per_mb, "bn_layers": bn_layers,
                "bucket_mb": flat.numel() * 4 / 1e6, "bucket_ms": bucket_ms,
                "policy_loss": em.policy_loss}
    finally:
        teardown_distributed()


def run_parallel(device: torch.device | str, tmp: str, *, games: int = 64, steps: int = 16,
                 batch: int = 256, blocks: int | None = None, label: str = "phase12") -> dict:
    """(a), the W = 2 -> W = 1 resume, (b) and (c); raises if a check fails."""
    dev = torch.device(device)
    args = {"tmp": tmp, "games": games, "steps": steps, "batch": batch, "blocks": blocks,
            "label": label}
    t0 = time.monotonic()
    torch.multiprocessing.start_processes(_two_ranks_entry,
                                          args=(free_port(), dev.type, args), nprocs=2,
                                          start_method="spawn")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    a_s = time.monotonic() - t0
    grad = ranks[0]["grad"]
    for name, g in grad.items():
        gate = f"gate <= {F32_L2_REL:g}" if name == "f32" else "not gated"
        print(f"{label}a grad {name} W=2 vs W=1 on {batch} rows: l2_rel={g['l2_rel']:.4g} "
              f"max_rel={g['max_rel']:.4g} ({gate}); W=1 rows reordered: l2_rel={g['reorder_l2_rel']:.4g}, clip off "
              f"{g['reorder_l2_rel_noclip']:.4g}, {g['cut_blocks']} blocks "
              f"{g['reorder_l2_rel_cut']:.4g}", flush=True)
    _check(grad["f32"]["l2_rel"] <= F32_L2_REL,
           f"f32: the summed gradient is {grad['f32']['l2_rel']:.4g} of ||g|| from one "
           f"process's on the same rows (gate {F32_L2_REL})")
    for name in ("katago-league-multihost", "katago-b40c256"):
        _check(torch.equal(ranks[0][name]["final"], ranks[1][name]["final"]),
               f"{name}: final states differ across ranks")

    # the W = 2 self-play checkpoint in a W = 1 trainer
    sp = ranks[0]["katago-b40c256"]
    cfg, _ = config("katago-b40c256", os.path.join(tmp, "resume"), games=games, steps=steps,
                    batch=batch, blocks=blocks, num_devices=0, league=False)
    resumed = SelfPlayTrainer(cfg, device=dev, resume_from=sp["checkpoint"])
    _check(torch.equal(bit_checksums(list(resumed.model.state_dict().values()), "cpu"),
                       sp["final"]), "the W=2 checkpoint did not resume exactly at W=1")
    resumed.close()
    del resumed
    print(f"{label}a W=2 checkpoint resumed at W=1 with equal parameters "
          f"({sp['checkpoint']}); two ranks {a_s:.1f} s", flush=True)

    t1 = time.monotonic()
    b = _nccl_world_one(dev, tmp, args)
    b_s = time.monotonic() - t1
    print(f"{label}b {b['backend']} world=1 update_s={b['update_s']:.3f} "
          f"bucket {b['bucket_mb']:.1f} MB all_reduce_ms={b['bucket_ms']:.3f} per minibatch; "
          f"an epoch's collectives {b['collectives']} over {b['minibatches']} minibatches: "
          f"{b['all_reduce_per_minibatch']:g} all-reduces a minibatch (1 bucket + 2 x "
          f"{b['bn_layers']} BatchNorm layers) {b_s:.1f} s", flush=True)

    t2 = time.monotonic()
    c = dryrun_multichip(2, dev.type, backend="gloo", share_card=dev.type == "cuda")
    print(f"{label}c dryrun_multichip(2) gloo losses {c['losses']} {c['seconds']:.1f} s",
          flush=True)
    rows = [row for r in ranks for n in ("katago-league-multihost", "katago-b40c256")
            for row in r[n]["rows"]]
    return {"a": {"rows": rows, "grad": grad, "seconds": a_s}, "b": b, "c": c,
            "seconds": time.monotonic() - t0}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--blocks", type=int, default=None)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        r = run_parallel(args.device, tmp, games=args.games, steps=args.steps,
                         batch=args.batch, blocks=args.blocks)
    print(f"phase12 done in {r['seconds']:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
