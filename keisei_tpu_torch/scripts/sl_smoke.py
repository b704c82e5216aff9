"""The supervised warm start end to end, with its checks (a cut-down twin
of scripts/sl_corpus_scale.py): a CSA corpus played by the port's engine
-> `prepare_sl_data` with the encoder on the device -> `SLTrainer` at the
width of configs/katago-b40c256.toml -> `evaluate` on a held-out split ->
`sl_to_rl` into a checkpoint directory that already holds an RL
`epoch_000002` -> RL epochs resumed from `sl_final`, their periodic saves
asynchronous.

    python -m keisei_tpu_torch.scripts.sl_smoke [--device cuda] [--games 256]
        [--envs 256] [--max-ply 320] [--steps 100] [--batch 256] [--big-batch 1024]
        [--big-steps 10] [--rl-games 64] [--rl-steps 16] [--blocks N] [--busy-steps 5]
        [--probe-rows 4096]
    python -m keisei_tpu_torch.scripts.sl_smoke --device cuda --probe-batch 2048 4096

The cuts are printed. The checks (each raises): the corpus parses; the
encoder kept every move (`dropped_moves == 0`: the engine played these
games itself) and wrote positions that `SLDataset` reads back; 8 games
re-encoded on the CPU give the bits of the device's shards; SL training
gives finite losses, a lower policy loss over its last 10 steps than over
its first 10, moved parameters, and leaves every tensor on the device;
after `sl_to_rl` the RL trainer is at epoch 0 with `sl_final`'s weights
bit for bit and no optimizer state, and its epochs give finite losses;
every asynchronous checkpoint reloads to the state it was taken from;
3 steps at `--probe-rows` rows (4,096, the default batch of `sl_to_rl`;
0 skips them) fit and give finite losses.
`--busy-steps N` also traces N more SL steps at each batch size on a card
for the device's busy share and the kernels per step. `--probe-batch B ...`
runs only 3 SL steps at each B rows, with and without the per-block
recompute, and prints each one's peak memory and seconds a step, or the
out-of-memory error.
chip_smoke.py phase 10 calls `run_sl`.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
import tomllib
from pathlib import Path

import numpy as np
import torch

from ..models.registry import build_model
from ..sl.dataset import SLDataset, write_meta, write_shard
from ..sl.encode import GameEncoder
from ..sl.parsers import CSAParser, GameFilter, build_parser_registry
from ..sl.prepare import _iter_game_files, prepare_sl_data
from ..sl import trainer as sl_trainer
from ..sl.trainer import SLConfig, SLTrainer
from ..training.checkpoint import STATE_NAME, load_checkpoint
from ..training.config import Config, config_from_dict
from ..training.loop import SelfPlayTrainer
from ..training.ppo import make_optimizer
from ..training.transition import sl_to_rl
from ..utils.timing import device_busy
from .generate_sl_corpus import generate_corpus

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "configs", "katago-b40c256.toml")


def model_spec(blocks: int | None = None) -> tuple[str, dict]:
    with open(CONFIG, "rb") as f:
        model = tomllib.load(f)["model"]
    params = dict(model["params"])
    if blocks is not None:
        params["num_blocks"] = blocks
    return model["architecture"], params


def rl_config(tmp: str, *, games: int, steps: int, batch: int,
              blocks: int | None) -> tuple[Config, list[str]]:
    """configs/katago-b40c256.toml with the transition's cuts: periodic
    saves every epoch, asynchronous."""
    with open(CONFIG, "rb") as f:
        raw = tomllib.load(f)
    cuts = {
        "training.num_games": games,
        "training.steps_per_epoch": steps,
        "training.algorithm_params.batch_size": batch,
        "training.algorithm_params.epochs_per_batch": 1,
        "training.checkpoint_interval": 1,
        "training.async_checkpoint": True,
    }
    if blocks is not None:
        cuts["model.params.num_blocks"] = blocks
    for key, value in cuts.items():
        section = raw
        *path, leaf = key.split(".")
        for part in path:
            section = section.setdefault(part, {})
        section[leaf] = value
    raw["training"]["checkpoint_dir"] = os.path.join(tmp, "ck")
    raw["display"]["db_path"] = ""
    return config_from_dict(raw, source=CONFIG), [f"{k} = {v}" for k, v in cuts.items()]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gb(device: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _state_copy(model, optimizer, generator) -> dict:
    """Model, optimizer state and generator as they are now (clones)."""
    return {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer": {i: {k: v.detach().clone() if torch.is_tensor(v) else v
                              for k, v in s.items()}
                          for i, s in optimizer.state_dict()["state"].items()},
            "generator": generator.get_state().clone()}


def _same_state(a: dict, b: dict) -> bool:
    """Equal bits in every tensor of two `_state_copy`s."""
    def same(x, y):
        if torch.is_tensor(y):
            return torch.equal(x.to(y.device), y)
        if isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in y)
        return x == y
    return same(a, b)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def train_sl(device: torch.device, ds: SLDataset, arch: str, params: dict, *, batch: int,
             steps: int, train_idx: np.ndarray, label: str) -> tuple[SLTrainer, dict]:
    """One epoch of `steps` SL steps at `batch` rows on the first
    steps * batch positions of `train_idx`, timed and checked."""
    cfg = SLConfig(batch_size=batch, epochs=1, seed=0)
    trainer = SLTrainer(cfg, arch, params, ds, train_indices=train_idx[: steps * batch],
                        device=device)
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    _reset_peak(device)
    _sync(device)
    t0 = time.monotonic()
    out = trainer.train_epoch()
    _sync(device)
    wall = time.monotonic() - t0
    rows = trainer.step_metrics
    r = {"batch": batch, "steps": out["batches"], "wall_s": wall,
         "steps_per_s": out["batches"] / wall, "positions_per_s": out["batches"] * batch / wall,
         "peak_gb": _peak_gb(device), "policy_loss": out["policy_loss"],
         "value_loss": out["value_loss"], "score_loss": out["score_loss"],
         "first_lr": rows[0]["learning_rate"], "last_lr": rows[-1]["learning_rate"]}
    print(f"{label} B={batch} steps={r['steps']} wall_s={wall:.3f} "
          f"steps_per_s={r['steps_per_s']:.3f} positions_per_s={r['positions_per_s']:.1f} "
          f"peak_gb={r['peak_gb']} policy_loss={out['policy_loss']:.4f} "
          f"value_loss={out['value_loss']:.4f} score_loss={out['score_loss']:.5f} "
          f"lr={r['first_lr']:.6g}->{r['last_lr']:.6g}")
    if out["batches"] != steps:
        raise AssertionError(f"{label}: {out['batches']} steps, wanted {steps}")
    for row in rows:
        for k in ("policy_loss", "value_loss", "score_loss"):
            if not math.isfinite(row[k]):
                raise AssertionError(f"{label}: {k} = {row[k]}")
    if steps >= 20:
        first = float(np.mean([row["policy_loss"] for row in rows[:10]]))
        last = float(np.mean([row["policy_loss"] for row in rows[-10:]]))
        r["policy_first10"], r["policy_last10"] = first, last
        print(f"{label} policy_loss first10={first:.4f} last10={last:.4f}")
        if not last < first:
            raise AssertionError(f"{label}: the policy loss did not fall ({first} -> {last})")
    if all(torch.equal(before[k], v) for k, v in trainer.model.state_dict().items()):
        raise AssertionError(f"{label}: the parameters did not move")
    tensors = list(trainer.model.state_dict().values())
    tensors += [v for s in trainer.optimizer.state.values() for v in s.values()
                if torch.is_tensor(v) and v.dim() > 0]
    off = {str(t.device) for t in tensors if t.device.type != device.type}
    if off:
        raise AssertionError(f"{label}: tensors off {device}: {sorted(off)}")
    r["tensors_checked"] = len(tensors)
    return trainer, r


def step_busy(trainer: SLTrainer, ds: SLDataset, order: np.ndarray, label: str,
              calls: int) -> dict | None:
    """On a card: the device's busy share and the kernels launched per SL
    step, over `calls` more steps on one batch (utils/timing.py)."""
    if trainer.device.type != "cuda" or calls <= 0:
        return None
    b = trainer._to_device(next(ds.batches(trainer.config.batch_size, order=order)))
    r = device_busy(lambda: trainer._train_step(b), calls)
    print(f"{label} B={trainer.config.batch_size} busy_share={r['busy_share']:.4f} "
          f"kernels_per_step={r['kernels_per_call']:.0f} window_ms={r['window_ms']:.1f} "
          f"busy_ms={r['busy_ms']:.1f} steps={calls}")
    return r


def probe_batch(device: torch.device, ds: SLDataset, arch: str, params: dict,
                batch: int, *, recompute: bool | None = None, steps: int = 3,
                strict: bool = False) -> dict:
    """`steps` SL steps at `batch` rows on one batch: the peak memory, the
    seconds of each step after the first (the first builds cuDNN's plans)
    and the last step's losses. `recompute` None leaves the choice to the
    trainer (`sl/trainer.py:RECOMPUTE_ABOVE`); True or False forces the
    per-block recompute on or off. An out-of-memory error is recorded,
    unless `strict`, where it and non-finite losses raise."""
    if len(ds) < batch:
        raise ValueError(f"{len(ds)} positions, fewer than the {batch} rows asked for")
    mode = {None: "default", True: "recompute", False: "plain"}[recompute]
    saved = sl_trainer.RECOMPUTE_ABOVE
    if recompute is not None:
        sl_trainer.RECOMPUTE_ABOVE = batch - 1 if recompute else batch
    trainer = SLTrainer(SLConfig(batch_size=batch, epochs=1, seed=0), arch, params, ds,
                        device=device)
    r = {"batch": batch, "mode": mode, "recomputes": batch > sl_trainer.RECOMPUTE_ABOVE}
    try:
        b = trainer._to_device(next(ds.batches(batch, order=np.arange(batch))))
        _reset_peak(device)
        times = []
        for _ in range(steps):
            _sync(device)
            t0 = time.monotonic()
            losses = trainer._train_step(b)
            _sync(device)
            times.append(time.monotonic() - t0)
        losses = losses.tolist()
        r.update(fits=True, peak_gb=_peak_gb(device), step_s=times[1:] or times,
                 losses=losses)
    except torch.cuda.OutOfMemoryError as e:
        if strict:
            raise
        r.update(fits=False, peak_gb=_peak_gb(device), error=str(e).splitlines()[0])
    finally:
        sl_trainer.RECOMPUTE_ABOVE = saved
    print(f"sl probe {r}")
    if strict and not all(math.isfinite(v) for v in r["losses"]):
        raise AssertionError(f"SL step at {batch} rows: losses {r['losses']}")
    return r


def run_sl(device: torch.device | str, tmp: str, *, games: int = 256, envs: int = 256,
           max_ply: int = 320, steps: int = 100, batch: int = 256, big_batch: int = 1024,
           big_steps: int = 10, eval_positions: int = 4096, transition_positions: int = 2560,
           rl_games: int = 64, rl_steps: int = 16, rl_batch: int = 256,
           blocks: int | None = None, busy_steps: int = 0, probe_rows: int = 4096,
           label: str = "sl") -> dict:
    """The whole warm start, checked; returns what was measured.
    `busy_steps` > 0 traces that many more SL steps at each batch size on a
    card (slow: a step launches ~11k kernels, each a traced event).
    `probe_rows` > 0 runs 3 steps at that many rows (the default batch of
    `sl_to_rl`) as the trainer runs them, and raises if they fail."""
    device = torch.device(device)
    arch, params = model_spec(blocks)
    cuts = [f"corpus games = {games}", f"corpus envs = {envs}", f"corpus max_ply = {max_ply}",
            f"sl steps = {steps} at B={batch}, {big_steps} at B={big_batch} (1 epoch each, "
            "on the first steps * B positions of the training split)",
            f"eval positions = {eval_positions}",
            f"probe: 3 steps at B={probe_rows} on one batch",
            f"transition SL positions = {transition_positions} (sl_epochs = 1, "
            f"sl_batch_size = {batch})"]
    if blocks is not None:
        cuts.append(f"model.params.num_blocks = {blocks}")
    for cut in cuts:
        print(f"{label} cut {cut}")
    res: dict = {}

    # -- corpus ----------------------------------------------------------------
    corpus = os.path.join(tmp, "corpus")
    t0 = time.monotonic()
    stats = generate_corpus(corpus, games=games, envs=envs, max_ply=max_ply, device=str(device))
    wall = time.monotonic() - t0
    parsed = [rec for p in sorted(Path(corpus).glob("*.csa")) for rec in CSAParser().parse(p)]
    res["corpus"] = {"games": stats["games"], "plies": stats["plies"], "wall_s": wall,
                     "games_per_s": stats["games"] / wall, "terminations": stats["terminations"]}
    print(f"{label} corpus games={stats['games']} plies={stats['plies']} wall_s={wall:.3f} "
          f"games_per_s={stats['games'] / wall:.2f} plies_per_s={stats['plies'] / wall:.1f} "
          f"terminations={stats['terminations']}")
    if len(parsed) != stats["games"] or any(not rec.moves for rec in parsed):
        raise AssertionError(f"{label}: {len(parsed)} of {stats['games']} games parsed")

    # -- prepare ---------------------------------------------------------------
    shards = os.path.join(tmp, "shards")
    _sync(device)
    t0 = time.monotonic()
    summary = prepare_sl_data([corpus], shards, device=str(device))
    _sync(device)
    wall = time.monotonic() - t0
    res["prepare"] = {**summary, "wall_s": wall, "positions_per_s": summary["positions"] / wall}
    print(f"{label} prepare {summary} wall_s={wall:.3f} "
          f"positions_per_s={summary['positions'] / wall:.1f}")
    if summary["positions"] <= 0 or summary["dropped_moves"] != 0:
        raise AssertionError(f"{label}: prepare kept {summary['positions']} positions and "
                             f"dropped {summary['dropped_moves']} moves")
    ds = SLDataset(shards)
    if len(ds) != summary["positions"] or ds[len(ds) - 1]["value_target"] not in (0, 1, 2):
        raise AssertionError(f"{label}: the shards read back {len(ds)} positions")
    # the first 8 kept games, re-encoded on the CPU, against the device's shards
    registry = build_parser_registry()
    keep = GameFilter(min_ply=40)
    records = [rec for f in _iter_game_files([corpus], registry)
               for rec in registry[f.suffix.lower()].parse(f) if keep.accepts(rec)][:8]
    obs, pol, val, sc, st = GameEncoder(device="cpu").encode_games(records)
    n = len(pol)
    rows = next(ds.batches(n, order=np.arange(n), drop_last=False))
    same = (_same_bits(obs, rows["observation"]) and _same_bits(pol, rows["policy_target"])
            and _same_bits(val, rows["value_target"]) and _same_bits(sc, rows["score_target"]))
    print(f"{label} cpu re-encode games={len(records)} positions={n} same_bits={same}")
    if not same or st["dropped_moves"]:
        raise AssertionError(f"{label}: the CPU encoding of {len(records)} games differs from "
                             "the device's shards")

    # -- SL training -------------------------------------------------------------
    perm = np.random.default_rng(7).permutation(len(ds))
    eval_idx, train_idx = perm[:eval_positions], perm[eval_positions:]
    need = max(steps * batch, big_steps * big_batch)
    if len(train_idx) < need:
        raise AssertionError(f"{label}: {len(train_idx)} training positions, fewer than {need}")
    trainer, res["train"] = train_sl(device, ds, arch, params, batch=batch, steps=steps,
                                     train_idx=train_idx, label=f"{label} train")
    _sync(device)
    t0 = time.monotonic()
    m = trainer.evaluate(eval_idx)
    _sync(device)
    m["wall_s"] = time.monotonic() - t0
    res["eval"] = m
    print(f"{label} eval positions={m['positions']} top1={m['policy_top1']:.4f} "
          f"top5={m['policy_top5']:.4f} nll={m['policy_nll']:.4f} "
          f"value_acc={m['value_acc']:.4f} score_mse={m['score_mse']:.5f} "
          f"wall_s={m['wall_s']:.3f}")
    if not all(math.isfinite(m[k]) for k in ("policy_nll", "score_mse")):
        raise AssertionError(f"{label}: evaluate gave {m}")
    res["train"]["busy"] = step_busy(trainer, ds, train_idx, f"{label} busy", busy_steps)
    del trainer
    trainer, res["train_big"] = train_sl(device, ds, arch, params, batch=big_batch,
                                         steps=big_steps, train_idx=train_idx,
                                         label=f"{label} train")
    res["train_big"]["busy"] = step_busy(trainer, ds, train_idx, f"{label} busy",
                                         busy_steps)
    del trainer
    if probe_rows:
        res["probe"] = probe_batch(device, ds, arch, params, probe_rows, strict=True)

    # -- transition ----------------------------------------------------------------
    sub = os.path.join(tmp, "transition_shards")
    os.makedirs(sub)
    first = next(ds.batches(transition_positions, order=train_idx[:transition_positions]))
    write_shard(os.path.join(sub, "shard_00000.bin"), first["observation"],
                first["policy_target"], first["value_target"], first["score_target"])
    write_meta(Path(sub), [transition_positions])
    cfg, rl_cuts = rl_config(os.path.join(tmp, "rl"), games=rl_games, steps=rl_steps,
                             batch=rl_batch, blocks=blocks)
    for cut in rl_cuts:
        print(f"{label} transition cut {cut}")
    stale = SelfPlayTrainer(cfg, device=device)
    stale.epoch = 2
    stale.save()
    del stale
    _sync(device)
    t0 = time.monotonic()
    rl = sl_to_rl(sl_data_dir=sub, sl_epochs=1, rl_config=cfg, sl_batch_size=batch,
                  device=device)
    _sync(device)
    t_transition = time.monotonic() - t0
    sl_final = os.path.join(cfg.training.checkpoint_dir, "sl_final")
    saved = torch.load(os.path.join(sl_final, STATE_NAME), map_location=device,
                       weights_only=True)["model"]
    live = rl.model.state_dict()
    equal = saved.keys() == live.keys() and all(torch.equal(saved[k], live[k]) for k in saved)
    print(f"{label} transition sl_to_rl_s={t_transition:.3f} epoch={rl.epoch} "
          f"weights_equal_sl_final={equal} optimizer_state={len(rl.optimizer.state)}")
    if rl.epoch != 0 or not equal or len(rl.optimizer.state) != 0:
        raise AssertionError(f"{label}: the RL trainer did not warm-start from sl_final")

    # -- RL epochs with asynchronous periodic saves ----------------------------------
    taken, metrics = {}, []
    for _ in range(2):
        em = rl.run_epoch()
        metrics.append(em)
        taken[em.epoch] = _state_copy(rl.model, rl.optimizer, rl.generator)
        print(f"{label} rl epoch={em.epoch} rollout_s={em.rollout_time:.3f} "
              f"update_s={em.update_time:.3f} save_s={em.maint_time:.4f} "
              f"policy_loss={em.policy_loss:.4f} value_loss={em.value_loss:.4f}")
        for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
            if not math.isfinite(getattr(em, k)):
                raise AssertionError(f"{label}: RL epoch {em.epoch}: {k} = {getattr(em, k)}")
    rl.close()
    t0 = time.monotonic()
    rl.save(os.path.join(tmp, "blocking_save"))
    blocking_s = time.monotonic() - t0
    fresh, _ = build_model(arch, params)
    fresh.to(device)
    for epoch, want in taken.items():
        path = os.path.join(cfg.training.checkpoint_dir, f"epoch_{epoch:06d}")
        opt = make_optimizer(fresh, cfg.algorithm_params)
        gen = torch.Generator(device=device)
        meta = load_checkpoint(path, fresh, opt, gen, architecture=arch)
        same = meta["epoch"] == epoch and _same_state(_state_copy(fresh, opt, gen), want)
        print(f"{label} async checkpoint epoch_{epoch:06d} reload_equal={same}")
        if not same:
            raise AssertionError(f"{label}: epoch_{epoch:06d} does not hold the state it was "
                                 "taken from")
    res["transition"] = {"sl_to_rl_s": t_transition,
                         "rl_epochs": [{"rollout_s": em.rollout_time, "update_s": em.update_time,
                                        "save_s": em.maint_time} for em in metrics],
                         "blocking_save_s": blocking_s}
    print(f"{label} blocking save_s={blocking_s:.4f} "
          f"async save_s={[round(em.maint_time, 4) for em in metrics]}")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--envs", type=int, default=256)
    parser.add_argument("--max-ply", type=int, default=320)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--big-batch", type=int, default=1024)
    parser.add_argument("--big-steps", type=int, default=10)
    parser.add_argument("--eval-positions", type=int, default=4096)
    parser.add_argument("--transition-positions", type=int, default=2560)
    parser.add_argument("--rl-games", type=int, default=64)
    parser.add_argument("--rl-steps", type=int, default=16)
    parser.add_argument("--rl-batch", type=int, default=256)
    parser.add_argument("--blocks", type=int, default=None)
    parser.add_argument("--busy-steps", type=int, default=0)
    parser.add_argument("--probe-rows", type=int, default=4096)
    parser.add_argument("--probe-batch", type=int, nargs="+", default=None,
                        help="only SL steps at these many rows on a fresh corpus, each "
                        "with and without the per-block recompute")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        if args.probe_batch is not None:
            corpus, shards = os.path.join(tmp, "corpus"), os.path.join(tmp, "shards")
            generate_corpus(corpus, games=args.games, envs=args.envs, max_ply=args.max_ply,
                            device=args.device)
            prepare_sl_data([corpus], shards, device=args.device)
            arch, params = model_spec(args.blocks)
            for batch in args.probe_batch:
                for recompute in (True, False):
                    probe_batch(torch.device(args.device), SLDataset(shards), arch, params,
                                batch, recompute=recompute)
            return 0
        run_sl(args.device, tmp, games=args.games, envs=args.envs, max_ply=args.max_ply,
               steps=args.steps, batch=args.batch, big_batch=args.big_batch,
               big_steps=args.big_steps, eval_positions=args.eval_positions,
               transition_positions=args.transition_positions, rl_games=args.rl_games,
               rl_steps=args.rl_steps, rl_batch=args.rl_batch, blocks=args.blocks,
               busy_steps=args.busy_steps, probe_rows=args.probe_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
