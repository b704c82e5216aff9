"""Self-play training loop (counterpart of keisei_tpu/training/loop.py, no-league
path): per epoch one rollout (T plies x N envs on the device) and one PPO
update, plus host-side orchestration: entropy schedule, plateau LR,
periodic checkpoints, episode statistics and the SQLite observer.

Run:  python -m keisei_tpu_torch.training.loop --config configs/katago-b40c256.toml \
          --device cuda

League mode and multi-device training are not ported yet and raise.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace

import torch

from keisei_tpu.training.observability import TrainingObserver

from ..env.vec_env import EnvCore
from ..models.registry import build_model, get_model_contract
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint, load_meta, prune_checkpoints, save_checkpoint
from .config import Config
from .ppo import (entropy_coeff_schedule, get_learning_rate, make_optimizer, make_ppo_update,
                  set_learning_rate)
from .rollout import make_selfplay_rollout
from .value_adapter import get_value_adapter

logger = logging.getLogger(__name__)


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (mode=min) on the policy loss."""

    factor: float = 0.5
    patience: int = 50
    min_lr: float = 1e-5
    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, value: float, current_lr: float) -> float:
        if value < self.best:
            self.best = value
            self.bad_epochs = 0
            return current_lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


@dataclass
class EpochMetrics:
    epoch: int
    policy_loss: float
    value_loss: float
    score_loss: float
    entropy: float
    gradient_norm: float
    learning_rate: float
    episodes: int
    wins_black: int
    wins_white: int
    draws: int
    truncated: int
    mean_episode_length: float
    rollout_time: float
    update_time: float
    maint_time: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class SelfPlayTrainer:
    """No-league self-play trainer on one device."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 metrics_sink=None, observer=None, resume_from: str | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.metrics_sink = metrics_sink or (lambda m: None)
        self.observer = observer or TrainingObserver(config.display.db_path)
        self._resume_from = resume_from
        tc = config.training
        if self.device.type == "cuda":
            # f32 matmuls and convs in full f32, as the JAX reference computes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.num_channels = 46 if tc.observation_mode == "default" else 50
        if config.model.params.get("obs_channels", 50) != self.num_channels:
            raise ValueError(
                f"model obs_channels {config.model.params.get('obs_channels')} != env "
                f"channels {self.num_channels} for observation_mode {tc.observation_mode!r}")
        if config.distributed.num_devices not in (0, 1):
            raise NotImplementedError("multi-device training is not yet ported "
                                      "(distributed.num_devices must be 0 or 1)")

        self.env_core = EnvCore(tc.num_games, tc.max_ply, self.num_channels, self.device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tc.seed)
            self.model, self.model_cfg = build_model(config.model.architecture,
                                                     config.model.params)
        self.model.to(self.device)
        ap = config.algorithm_params
        self.adapter = get_value_adapter(
            get_model_contract(config.model.architecture), lambda_value=ap.lambda_value,
            lambda_score=ap.lambda_score, score_blend_alpha=ap.score_blend_alpha)
        self.optimizer = make_optimizer(self.model, ap)
        self.T = tc.effective_steps_per_epoch
        self._rollout = make_selfplay_rollout(
            self.env_core, self.model, self.adapter, self.T,
            forward_fn=self._rollout_forward_fn(tc.rollout_forward))
        self._update = make_ppo_update(self.model, self.adapter, ap, self.optimizer)
        self.lr_sched = PlateauScheduler(factor=tc.lr_plateau_factor,
                                         patience=tc.lr_plateau_patience, min_lr=tc.lr_min)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tc.seed)
        self.epoch = 0
        self.env_carry = self.env_core.init()
        self._maybe_resume()
        self.total_episodes = 0
        self.total_ply = 0

    def _rollout_forward_fn(self, mode: str):
        """The rollout's inference path (TrainingConfig.rollout_forward).

        "auto"/"flax" -> the eager nn.Module forward. "fused" -> the CUDA
        kernels of ops/ (on a CPU device the same path runs their plain
        versions). "int8" is not ported yet.
        """
        if mode in ("auto", "flax"):
            return None
        if mode == "int8":
            raise NotImplementedError("rollout_forward='int8' is not yet ported "
                                      "to keisei_tpu_torch")
        from ..models.fused_infer import make_fused_forward
        from ..ops.fused_block import SUPPORTED_C

        arch = self.config.model.architecture
        cuda_ok = self.device.type != "cuda" or self.model_cfg.channels in SUPPORTED_C
        if arch != "se_resnet" or not cuda_ok:
            raise ValueError(
                f"rollout_forward={mode!r} needs architecture=se_resnet and, on a CUDA "
                f"device, channels in {SUPPORTED_C} (got arch={arch!r}, "
                f"channels={self.model_cfg.channels}, device={self.device})")
        return make_fused_forward(self.model_cfg)

    # -- checkpoints ----------------------------------------------------------

    def latest_checkpoint(self) -> str | None:
        d = self.config.training.checkpoint_dir
        if not os.path.isdir(d):
            return None
        best, best_epoch = None, -1
        for name in os.listdir(d):
            p = os.path.join(d, name)
            if os.path.isfile(os.path.join(p, "keisei_meta.json")):
                ep = load_meta(p).get("epoch", -1)
                if ep > best_epoch:
                    best, best_epoch = p, ep
        return best

    def _maybe_resume(self) -> None:
        path = self._resume_from or self.latest_checkpoint()
        if path is None:
            return
        meta = load_checkpoint(path, self.model, self.optimizer, self.generator,
                               architecture=self.config.model.architecture)
        self.epoch = meta["epoch"]
        if meta.get("learning_rate"):
            set_learning_rate(self.optimizer, meta["learning_rate"])
        if "lr_plateau_best" in meta:
            self.lr_sched.best = meta["lr_plateau_best"]
            self.lr_sched.bad_epochs = meta.get("lr_plateau_bad_epochs", 0)
        logger.info("resumed from %s at epoch %d", path, self.epoch)

    def save(self, path: str | None = None) -> str:
        d = self.config.training.checkpoint_dir
        os.makedirs(d, exist_ok=True)
        path = path or os.path.join(d, f"epoch_{self.epoch:06d}")
        save_checkpoint(
            path, self.model, self.optimizer, epoch=self.epoch,
            architecture=self.config.model.architecture, generator=self.generator,
            extra_meta={
                "learning_rate": get_learning_rate(self.optimizer),
                "model_params": {k: str(v) for k, v in self.config.model.params.items()},
                "lr_plateau_best": self.lr_sched.best,
                "lr_plateau_bad_epochs": self.lr_sched.bad_epochs,
            })
        prune_checkpoints(d, self.config.training.checkpoint_keep)
        return path

    # -- training ---------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_epoch(self) -> EpochMetrics:
        tc = self.config.training
        t0 = time.monotonic()
        self.observer.heartbeat(self.epoch, self.epoch * self.T, "rollout")
        carry, traj, next_value, stats = self._rollout(*self.env_carry, self.generator)
        self.env_carry = carry
        self._sync()
        t1 = time.monotonic()

        self.observer.heartbeat(self.epoch, self.epoch * self.T, "update")
        entropy_coeff = entropy_coeff_schedule(
            self.config.algorithm_params, self.epoch, tc.entropy_warmup_epochs,
            tc.entropy_warmup_coeff)
        metrics = self._update(traj, next_value, self.generator, entropy_coeff)
        del traj
        t2 = time.monotonic()

        lr = get_learning_rate(self.optimizer)
        new_lr = self.lr_sched.step(metrics["policy_loss"], lr)
        if new_lr != lr:
            logger.info("LR reduced: %.6f -> %.6f (monitor=policy_loss)", lr, new_lr)
            set_learning_rate(self.optimizer, new_lr)

        self.epoch += 1
        self.total_episodes += stats.episodes
        self.total_ply += stats.total_ply
        ckpt = self.save() if self.epoch % tc.checkpoint_interval == 0 else None
        t3 = time.monotonic()
        em = EpochMetrics(
            epoch=self.epoch, learning_rate=new_lr,
            episodes=stats.episodes, wins_black=stats.wins_black,
            wins_white=stats.wins_white, draws=stats.draws, truncated=stats.truncated,
            mean_episode_length=stats.total_ply / stats.episodes if stats.episodes else 0.0,
            rollout_time=t1 - t0, update_time=t2 - t1, maint_time=t3 - t2, **metrics)
        self.metrics_sink(em.as_dict())
        self.observer.on_epoch(em.as_dict(), self.epoch * self.T, ckpt)
        if self.observer.enabled:
            self._snapshot()
        return em

    def _snapshot(self) -> None:
        """Live boards of the first envs for the dashboard; never fatal."""
        try:
            env_states, obs, _ = self.env_carry
            k = min(self.observer.max_snapshot_games, obs.shape[0])
            self.model.eval()
            with torch.no_grad():
                out = self.model(obs[:k].reshape(k, self.num_channels, 9, 9))
            values = self.adapter.scalar_value_blended(out).cpu().numpy()
            host = SimpleNamespace(**{
                f: getattr(env_states, f)[:k].cpu().numpy()
                for f in ("board", "hands", "stm", "ply", "in_check")})
            self.observer.snapshot_envs(host, values=values)
        except Exception:
            logger.exception("board snapshot failed — continuing")

    def run(self, num_epochs: int | None = None) -> None:
        n = self.config.run.default_epochs if num_epochs is None else num_epochs
        target = self.epoch + n
        self.observer.on_start(self.config, total_epochs=target)
        wall0 = time.monotonic()
        steps = self.T * self.config.training.num_games
        run_steps = 0
        while self.epoch < target:
            em = self.run_epoch()
            run_steps += steps
            logger.info(
                "epoch %d: policy=%.4f value=%.4f entropy=%.3f eps=%d (B%d/W%d/D%d) "
                "rollout=%.2fs (%.0f steps/s) update=%.2fs amortized=%.0f steps/s",
                em.epoch, em.policy_loss, em.value_loss, em.entropy, em.episodes,
                em.wins_black, em.wins_white, em.draws, em.rollout_time,
                steps / max(em.rollout_time, 1e-9), em.update_time,
                run_steps / max(time.monotonic() - wall0, 1e-9))
        self.save()
        self.observer.on_stop("stopped")


def main(argv=None):
    import argparse

    from .config import load_config

    parser = argparse.ArgumentParser(description="keisei_tpu_torch self-play training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s", force=True)
    config = load_config(args.config)
    tc = config.training
    if args.steps_per_epoch is not None:
        tc = replace(tc, steps_per_epoch=args.steps_per_epoch)
    if args.seed is not None:
        tc = replace(tc, seed=args.seed)
    trainer = SelfPlayTrainer(replace(config, training=tc), device=args.device)
    trainer.run(args.epochs)


if __name__ == "__main__":
    main()
