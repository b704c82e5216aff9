"""Self-play training loop (counterpart of keisei_tpu/training/loop.py):
per epoch one rollout (T plies x N envs on the device) and one PPO
update, plus host-side orchestration: entropy schedule, plateau LR,
periodic checkpoints, episode statistics and the SQLite observer.

With `[league] enabled = true` the rollout is the split-merge league
rollout (the learner against K frozen opponents from the tiered pool,
training/league_rollout.py) and each epoch ends with league maintenance:
Elo and results, learner snapshots into the pool, tier reviews, the
historical library and the gauntlet, on a worker thread by default
(`league.async_maintenance`). With `tournament_enabled`, the maintenance
also plays tournament rounds (in_process: league/tournament.py, on the
trainer's card or `tournament_device`) or enqueues them for sidecar
workers (league/worker.py).

Run:  python -m keisei_tpu_torch.training.loop --config configs/katago-b40c256.toml \
          --device cuda

Data parallelism (`[distributed] num_devices`, parallel/): `main` starts
one rank per card (spawned processes, one per local card, on every host
named by KEISEI_COORDINATOR / KEISEI_NUM_PROCESSES / KEISEI_PROCESS_ID).
Each rank runs SelfPlayTrainer on its own N/W envs; the update computes
the global batch's (training/ppo.py:PPOUpdate). Rank 0 alone owns the
observer, the checkpoints and the league (store, pool, scheduler,
Dynamic trainer, historical library, gauntlet, tournament, maintenance
worker) and broadcasts each epoch's cohort, as process 0 does in the JAX
package. One rank runs with no process group at all.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from types import SimpleNamespace

import torch

from .. import db
from ..engine.core import select_envs
from ..env.vec_env import EnvCore
from ..league.dynamic_trainer import DynamicTrainer
from ..league.historical import HistoricalGauntlet, HistoricalLibrary
from ..league.league_ops import (record_epoch_results, stack_cohort_variables,
                                 stacked_cohort_template)
from ..league.scheduler import MatchScheduler, PriorityScorer, build_match_class_weights
from ..league.store import OpponentStore, Role
from ..league.tiers import TieredPool
from ..league.tournament import LeagueTournament, TournamentDispatcher
from ..models.registry import build_model, get_model_contract
from ..parallel.distributed import (broadcast_from_main, free_port, get_distributed_context,
                                    process_seed, rank_layout, setup_distributed,
                                    teardown_distributed, torchrun_layout)
from ..parallel.mesh import Mesh, make_mesh, replicate, shard_env_batch
from ..parallel.placement import learner_device
from ..utils.device import parse_device, resolve_device
from .checkpoint import (META_NAME, checkpoint_payload, load_checkpoint, load_meta,
                         prune_checkpoints, write_checkpoint)
from .config import Config
from .league_rollout import compact_supported, make_league_rollout, parity_colors
from .observability import TrainingObserver
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
    """Self-play (and league) trainer on one device, or one rank of a
    data-parallel `mesh` (parallel/mesh.py) on its own N/W envs."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 metrics_sink=None, observer=None, resume_from: str | None = None,
                 mesh: Mesh | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh(device=self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"the mesh's device {self.mesh.device} is not the trainer's "
                             f"{self.device}")
        self.is_main = self.mesh.is_main
        self.metrics_sink = metrics_sink or (lambda m: None)
        # rank 0 alone writes the observability DB
        self.observer = observer or TrainingObserver(
            config.display.db_path if self.is_main else "")
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
        self._check_ranks()

        self.env_core = EnvCore(tc.num_games // self.mesh.world_size, tc.max_ply,
                                self.num_channels, self.device)
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
        self.league_enabled = bool(config.league is not None and config.league.enabled)
        if self.league_enabled:
            if tc.rollout_forward not in ("auto", "flax"):
                raise ValueError(
                    f"rollout_forward={tc.rollout_forward!r} is not supported in league "
                    "mode (the split-merge rollout runs each opponent block on its own "
                    "weights; only the eager forward takes them)")
            self.K = config.league.opponents_per_epoch
            if tc.num_games % self.K != 0:
                raise ValueError(f"num_games {tc.num_games} must divide by "
                                 f"opponents_per_epoch {self.K}")
            self._rollout = make_league_rollout(
                self.env_core, self.model, self.adapter, self.T, self.K,
                color_randomization=config.league.color_randomization, mesh=self.mesh)
        else:
            self._rollout = make_selfplay_rollout(
                self.env_core, self.model, self.adapter, self.T,
                forward_fn=self._rollout_forward_fn(tc.rollout_forward))
        self._update = make_ppo_update(self.model, self.adapter, ap, self.optimizer, self.mesh)
        self.lr_sched = PlateauScheduler(factor=tc.lr_plateau_factor,
                                         patience=tc.lr_plateau_patience, min_lr=tc.lr_min)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tc.seed)
        self.epoch = 0
        self.env_carry = self.env_core.init()
        # periodic saves with async_checkpoint: one write in flight, on one
        # worker thread, from a device copy of the state (see save())
        self._ckpt_executor = None
        self._ckpt_future = None
        self._maybe_resume()
        self.rollout_generator = self._rank_generator()
        if self.mesh.group is not None:
            self._replicate()
        self.total_episodes = 0
        self.total_ply = 0
        self.rollout_stats_local = None  # this rank's counts of the last rollout

        # league maintenance runs FIFO on one worker (snapshot before the
        # gauntlet that should see it); a backlog is bounded in
        # _league_epoch_end
        self._maint_executor = None
        self._maint_futures: deque = deque()
        self._maint_phase_s: dict[str, float] = {}  # worker seconds per phase
        if self.league_enabled:
            self._init_league()
            if self.is_main and config.league.async_maintenance:
                self._maint_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="keisei-league")

    # -- ranks ---------------------------------------------------------------------

    def _check_ranks(self) -> None:
        """distributed.num_devices against the mesh this trainer runs on.
        A request for several ranks never trains alone: without a mesh it
        raises (main() starts the ranks)."""
        tc = self.config.training
        n, W = self.config.distributed.num_devices, self.mesh.world_size
        if self.mesh.group is None:
            cards = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if n > 1 or (n == -1 and cards > 1):
                raise ValueError(
                    f"distributed.num_devices = {n} asks for {n if n > 1 else cards} ranks, "
                    "one per card: start them with `python -m keisei_tpu_torch.training.loop` "
                    "or give each rank's trainer its mesh; this trainer would train alone")
        elif n not in (-1, W) and not (n in (0, 1) and W == 1):
            raise ValueError(f"distributed.num_devices = {n} but the mesh has {W} ranks")
        if tc.num_games % W:
            raise ValueError(f"num_games {tc.num_games} must divide evenly over {W} ranks")
        if W > 1 and tc.rollout_forward not in ("auto", "flax"):
            raise ValueError(
                f"rollout_forward={tc.rollout_forward!r} needs a single rank (the JAX package "
                "refuses its Pallas forwards under a mesh); use auto or flax")

    def _rank_generator(self) -> torch.Generator:
        """The rollout's generator. One rank: the trainer's own (the one a
        checkpoint holds). Several: rank r draws from its own generator,
        seeded with process_seed(seed + epoch * W, r) (process_seed(seed, r)
        at a fresh start), so that no two ranks, and no two resumes at the
        same W, draw the same noise. The trainer's generator, in the same
        state on every rank, draws the update's permutations."""
        W = self.mesh.world_size
        if W == 1:
            return self.generator
        g = torch.Generator(device=self.device)
        g.manual_seed(process_seed(self.config.training.seed + self.epoch * W, self.mesh.rank))
        return g

    def _replicate(self) -> None:
        """Every rank from rank 0's state: parameters, BatchNorm statistics
        and Adam moments. The ranks must have resumed at the same epoch."""
        epoch = broadcast_from_main(
            {"epoch": torch.tensor([self.epoch], device=self.device)}, self.mesh)["epoch"]
        if int(epoch) != self.epoch:
            raise RuntimeError(f"rank {self.mesh.rank} resumed at epoch {self.epoch} and rank 0 "
                               f"at {int(epoch)}: every rank must read the same checkpoint_dir")
        replicate(self.mesh, self.model, self.optimizer)

    # -- league wiring -----------------------------------------------------------

    def _init_league(self) -> None:
        """Opponent pool, tiers, scheduler, Dynamic trainer, historical
        library and gauntlet, the tournament (or its dispatcher), and the
        per-env learner colors."""
        lc = self.config.league
        self.learner_color = self._fresh_colors()
        self._cohort: list = []
        self._cohort_slot_ids = None
        self._cohort_key = None
        self._cohort_vars = None
        if not self.is_main:
            # rank 0 owns the league; the others receive its cohort
            self.store = self.pool = self.scorer = self.scheduler = None
            self.dyn_trainer = self.historical = self.gauntlet = None
            self.tournament = self.dispatcher = None
            self.learner_entry_id = None
            return

        db_path = self.config.display.db_path or os.path.join(
            lc.storage.league_dir, "league.db")
        self.store = OpponentStore(
            db_path, lc.storage.league_dir, cache_size=lc.storage.cache_entries,
            cache_bytes=lc.storage.cache_bytes_gb * 1e9, device=self.device)
        # clamp update_counts whose async weight flush was lost to a crash
        # back to the committed generation (no flush can be in flight yet)
        self.store.reconcile_update_counts()
        self.pool = TieredPool(self.store, lc)
        self.scorer = PriorityScorer(lc.priority, build_match_class_weights(lc.scheduler))
        self.scheduler = MatchScheduler(lc.scheduler, self.scorer)
        # Dynamic updates ride tournament rounds: on the tournament's card
        # (tournament_device, else the trainer's); a bad spec fails here
        tournament_device = parse_device(lc.tournament_device, default=self.device)
        self.dyn_trainer = DynamicTrainer(
            self.store, self.model, lc.dynamic,
            learner_lr=self.config.algorithm_params.learning_rate,
            contract=get_model_contract(self.config.model.architecture),
            device=tournament_device)
        self.dyn_trainer.architecture = self.config.model.architecture
        self.historical = HistoricalLibrary(self.store, lc.history)
        self.gauntlet = HistoricalGauntlet(self.store, lc.gauntlet,
                                           historical_k=lc.elo.historical_k)
        self.tournament = None
        self.dispatcher = None
        if lc.tournament_enabled:
            if lc.tournament_mode == "in_process":
                self.tournament = LeagueTournament(
                    self.store, lc, self.scheduler, self.scorer, self.dyn_trainer,
                    heartbeat=lambda: self.observer.heartbeat(
                        self.epoch, self.epoch * self.T, "tournament"),
                    learner_id_fn=lambda: self.learner_entry_id,
                    device=tournament_device)
            else:
                self.dispatcher = TournamentDispatcher(self.store, lc, self.scheduler,
                                                       self.scorer)

        # bootstrap: the pool must never be empty
        self.pool.bootstrap_from_flat_pool(self.epoch)
        if self.store.pool_size() == 0:
            entry = self.pool.snapshot_learner(
                self.model.state_dict(), self.config.model.architecture,
                dict(self.config.model.params), self.epoch)
            self.learner_entry_id = entry.id
            return
        st = db.read_training_state(db_path) if self.config.display.db_path else None
        if st and st.get("learner_entry_id"):
            self.learner_entry_id = st["learner_entry_id"]
        else:
            # the NEWEST snapshot (list_entries orders by Elo; the strongest
            # entry may be an old frontier anchor)
            latest = max(self.store.list_entries(), key=lambda e: (e.created_epoch, e.id))
            self.learner_entry_id = latest.id

    def _fresh_colors(self) -> torch.Tensor:
        """Learner colors for this rank's envs, fresh: the global parity
        pattern's share on the compact path, a draw with color
        randomization, else Black."""
        lc = self.config.league
        n = self.env_core.num_envs
        if compact_supported(self.T, self.K, lc.color_randomization):
            return shard_env_batch(
                self.mesh, parity_colors(self.config.training.num_games, self.device))
        if lc.color_randomization:
            return (torch.rand(n, generator=self.rollout_generator, device=self.device)
                    < 0.5).int()
        return torch.zeros(n, dtype=torch.int32, device=self.device)

    def _sample_cohort(self) -> list:
        """K distinct opponents for this epoch, cycled to fill K env blocks."""
        want_params = dict(self.config.model.params)

        def compatible(e):
            # same arch AND same shape params: a reused league_dir can hold
            # same-architecture entries of other sizes
            return (e.architecture == self.config.model.architecture
                    and e.model_params == want_params)

        by_role = {r: [e for e in self.store.list_by_role(r) if compatible(e)]
                   for r in (Role.DYNAMIC, Role.FRONTIER_STATIC, Role.RECENT_FIXED)}
        cohort = self.scheduler.sample_k_for_learner(by_role, self.K) if any(
            by_role.values()) else []
        if not cohort:  # no opponents yet: play the learner's own snapshot
            cohort = [self.store.get_entry(self.learner_entry_id)]
        base = list(cohort)
        while len(cohort) < self.K:  # cycle the sampled set to fill K blocks
            cohort.append(base[len(cohort) % len(base)])
        return cohort[: self.K]

    def _cohort_for_epoch(self) -> dict:
        """Sample this epoch's cohort and return its K-stacked bf16 state
        dict, reused while the (entry, update_count) keys are unchanged.

        Env block k plays whoever sits in slot k, so a game straddling the
        epoch boundary would switch opponents mid-game and credit its
        result to an entry that played only its tail: the blocks whose
        slot changed entries are reset instead (the boundary already
        bootstrapped those games' values). An update_count change of the
        same entry keeps the games.

        Several ranks: rank 0 samples; its (entry, update_count) keys, and
        the stacked cohort when they change, are broadcast to every rank."""
        keys = torch.zeros(self.K, 2, dtype=torch.int64, device=self.device)
        if self.is_main:
            self._cohort = self._sample_cohort()
            keys = torch.tensor([(e.id, e.update_count) for e in self._cohort],
                                dtype=torch.int64, device=self.device)
        keys = broadcast_from_main({"keys": keys}, self.mesh)["keys"]
        ck = tuple(map(tuple, keys.tolist()))
        new_ids = tuple(entry_id for entry_id, _ in ck)
        old_ids = self._cohort_slot_ids
        if old_ids is not None and new_ids != old_ids:
            self._reset_swapped_blocks([k for k, (a, b) in enumerate(zip(old_ids, new_ids))
                                        if a != b])
        self._cohort_slot_ids = new_ids
        if self._cohort_key != ck:
            sd = self.model.state_dict()
            if self.is_main:
                stacked = stack_cohort_variables(self.store, self._cohort, sd,
                                                 dtype=torch.bfloat16)
            else:
                stacked = stacked_cohort_template(sd, self.K, dtype=torch.bfloat16)
            self._cohort_vars = broadcast_from_main(stacked, self.mesh)
            self._cohort_key = ck
        return self._cohort_vars

    def _reset_swapped_blocks(self, slots: list[int]) -> None:
        """Restart the env blocks whose cohort slot changed entries (the
        truncation path), and give them fresh learner colors. Blocks are
        global: env e is in block e // (N/K), on whichever rank holds it."""
        if not slots:
            return
        N = self.config.training.num_games
        block = shard_env_batch(self.mesh, torch.arange(N, device=self.device)) // (N // self.K)
        mask = torch.isin(block, torch.tensor(slots, device=self.device))
        fresh = self.env_core.init()
        self.env_carry = tuple(select_envs(mask, f, c) for f, c in zip(fresh, self.env_carry))
        self.learner_color = torch.where(mask, self._fresh_colors(), self.learner_color)
        logger.debug("cohort swap: reset %d env blocks %s", len(slots), slots)

    def _rollout_forward_fn(self, mode: str):
        """The rollout's inference path (TrainingConfig.rollout_forward).

        "auto"/"flax" -> the eager nn.Module forward. "fused" -> the bf16
        CUDA kernels of ops/, "int8" -> the int8 trunk (ops/qblock.py); on a
        CPU device both run their kernels' plain versions. "int8" also needs
        num_games divisible by 32 (the quantization tile).
        """
        if mode in ("auto", "flax"):
            return None
        from ..models.fused_infer import make_fused_forward, make_quantized_forward
        from ..ops.fused_block import SUPPORTED_C
        from ..ops.qblock import int8_batch_tile

        arch = self.config.model.architecture
        cuda_ok = self.device.type != "cuda" or self.model_cfg.channels in SUPPORTED_C
        if arch != "se_resnet" or not cuda_ok:
            raise ValueError(
                f"rollout_forward={mode!r} needs architecture=se_resnet and, on a CUDA "
                f"device, channels in {SUPPORTED_C} (got arch={arch!r}, "
                f"channels={self.model_cfg.channels}, device={self.device})")
        if mode == "fused":
            return make_fused_forward(self.model_cfg)
        int8_batch_tile(self.config.training.num_games)  # fail here, not in the first rollout
        return make_quantized_forward(self.model_cfg)

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
        if self._resume_from is not None:
            path = self._resume_from
            if not os.path.isfile(os.path.join(path, META_NAME)):
                raise FileNotFoundError(
                    f"explicit resume checkpoint has no keisei_meta.json: {path}")
        else:
            path = self.latest_checkpoint()
        if path is None:
            return
        from_sl = load_meta(path).get("phase") == "sl"
        # SL warm start: the weights only; the SL optimizer is discarded,
        # the trainer keeps its own generator and starts at epoch 0
        meta = load_checkpoint(path, self.model, self.optimizer, self.generator,
                               architecture=self.config.model.architecture,
                               skip_optimizer=from_sl)
        if from_sl:
            self.epoch = 0
            logger.info("warm-started from SL checkpoint %s (optimizer reset)", path)
            return
        self.epoch = meta["epoch"]
        if meta.get("learning_rate"):
            set_learning_rate(self.optimizer, meta["learning_rate"])
        if "lr_plateau_best" in meta:
            self.lr_sched.best = meta["lr_plateau_best"]
            self.lr_sched.bad_epochs = meta.get("lr_plateau_bad_epochs", 0)
        logger.info("resumed from %s at epoch %d", path, self.epoch)

    def save(self, path: str | None = None, *, blocking: bool = True) -> str:
        """Checkpoint the trainer. blocking=True (every explicit call)
        returns with the checkpoint on disk. blocking=False (the periodic
        saves when training.async_checkpoint is on) copies the model's and
        the optimizer's state on the device first, because the next update
        changes the live tensors in place, then writes and prunes on the
        checkpoint thread. One write is in flight at a time: every save
        waits for the one before, and a failed write raises there."""
        d = self.config.training.checkpoint_dir
        path = path or os.path.join(d, f"epoch_{self.epoch:06d}")
        if not self.is_main:
            # rank 0 writes; a blocking save returns with the file on disk everywhere
            if blocking and self.mesh.group is not None:
                self.mesh.barrier()
            return path
        meta = dict(epoch=self.epoch, architecture=self.config.model.architecture,
                    extra_meta={
                        "learning_rate": get_learning_rate(self.optimizer),
                        "model_params": dict(self.config.model.params),
                        "lr_plateau_best": self.lr_sched.best,
                        "lr_plateau_bad_epochs": self.lr_sched.bad_epochs,
                    })
        keep = self.config.training.checkpoint_keep
        os.makedirs(d, exist_ok=True)
        self._drain_checkpoint()
        payload = checkpoint_payload(self.model, self.optimizer, self.generator,
                                     copy=not blocking)
        if blocking:
            write_checkpoint(path, payload, **meta)
            prune_checkpoints(d, keep)
            if self.mesh.group is not None:
                self.mesh.barrier()
            return path

        def write() -> None:
            write_checkpoint(path, payload, **meta)
            prune_checkpoints(d, keep)

        if self._ckpt_executor is None:
            self._ckpt_executor = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="keisei-ckpt")
        self._ckpt_future = self._ckpt_executor.submit(write)
        return path

    def _drain_checkpoint(self) -> None:
        """Wait for the checkpoint write in flight, if any; its exception,
        if it failed, is raised here."""
        future, self._ckpt_future = self._ckpt_future, None
        if future is not None:
            future.result()

    def close(self) -> None:
        """Drain the checkpoint writer and the league maintenance: call it
        before dropping a trainer whose periodic saves are asynchronous."""
        self._drain_checkpoint()
        self.drain_maintenance()
        if self._ckpt_executor is not None:
            self._ckpt_executor.shutdown(wait=True)
            self._ckpt_executor = None

    def __del__(self):
        # a trainer dropped without close(): its last periodic write still
        # lands; a failure can only be logged here
        future = getattr(self, "_ckpt_future", None)
        if future is not None:
            try:
                future.result()
            except Exception:
                logger.exception("checkpoint write failed before the trainer was dropped")

    # -- training ---------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_epoch(self) -> EpochMetrics:
        tc = self.config.training
        t0 = time.monotonic()
        self.observer.heartbeat(self.epoch, self.epoch * self.T, "rollout")
        league_stats = None
        if self.league_enabled:
            opp_vars = self._cohort_for_epoch()
            carry, traj, next_value, league_stats = self._rollout(
                opp_vars, *self.env_carry, self.learner_color, self.rollout_generator)
            *carry, self.learner_color = carry
            self.rollout_stats_local = league_stats
            league_stats = league_stats.summed(self.mesh)
            stats = league_stats.base
            if league_stats.parity_mismatch:
                logger.warning(
                    "league parity invariant violated for %d env-steps this epoch: "
                    "learner/opponent actions went to the wrong seat",
                    league_stats.parity_mismatch)
        else:
            carry, traj, next_value, stats = self._rollout(*self.env_carry,
                                                           self.rollout_generator)
            self.rollout_stats_local = stats
            stats = stats.summed(self.mesh)
        self.env_carry = tuple(carry)
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
        if self.league_enabled:
            self._league_epoch_end(league_stats)
        ckpt = None
        if self.epoch % tc.checkpoint_interval == 0:
            ckpt = self.save(blocking=not tc.async_checkpoint)
        t3 = time.monotonic()
        em = EpochMetrics(
            epoch=self.epoch, learning_rate=new_lr,
            episodes=stats.episodes, wins_black=stats.wins_black,
            wins_white=stats.wins_white, draws=stats.draws, truncated=stats.truncated,
            mean_episode_length=stats.total_ply / stats.episodes if stats.episodes else 0.0,
            rollout_time=t1 - t0, update_time=t2 - t1, maint_time=t3 - t2, **metrics)
        self.metrics_sink(em.as_dict())
        self.observer.on_epoch(em.as_dict(), self.epoch * self.T, ckpt)
        # rank 0's first envs are the global first; across hosts the JAX
        # package skips the snapshot, and so does the port
        if self.observer.enabled and self.mesh.single_host:
            self._snapshot()
        return em

    def _league_epoch_end(self, league_stats) -> None:
        """Post-epoch league bookkeeping: Elo, snapshots, reviews,
        historical refresh, the gauntlet and the tournament.

        With league.async_maintenance (default) only the weights copy
        stays here, on the training thread, when a snapshot is due: a
        detached copy of every state-dict tensor (bf16 where
        storage.snapshot_dtype says so), taken before the next update
        changes the parameters in place. The rest runs FIFO on the
        maintenance worker and overlaps the next epoch. Rank 0 only: the
        other ranks own no league."""
        if self.store is None:
            return
        lc = self.config.league
        epoch = self.epoch
        snapshot_due = epoch % lc.epochs_per_seat == 0 or epoch % lc.snapshot_interval == 0
        vars_copy = None
        if snapshot_due:
            sd = self.model.state_dict()
            if lc.storage.snapshot_dtype == "bfloat16":
                vars_copy = {k: v.detach().to(torch.bfloat16) if v.is_floating_point()
                             else v.detach().clone() for k, v in sd.items()}
            else:
                vars_copy = {k: v.detach().clone() for k, v in sd.items()}
        # captured by value: the worker must see THIS epoch's cohort and learner
        args = (epoch, list(self._cohort), self.learner_entry_id, league_stats, vars_copy)
        if self._maint_executor is None:
            self._league_maintenance(*args)
            return
        while self._maint_futures and self._maint_futures[0].done():
            self._maint_futures.popleft().result()  # surface worker crashes
        if len(self._maint_futures) >= 4:
            # each queued snapshot pins a copy of the parameters on the
            # device: block until the worker catches up
            logger.warning("league maintenance backlog hit %d epochs; blocking until the "
                           "worker drains", len(self._maint_futures))
            while len(self._maint_futures) > 1:
                self._maint_futures.popleft().result()
        self._maint_futures.append(self._maint_executor.submit(self._league_maintenance, *args))
        # a round on the learner's own card blocks training
        # (tournament_overlap="auto"): overlapped, its launches and host
        # syncs would interleave with the next epochs' on one device
        if (self.tournament is not None and self.tournament.is_due(epoch)
                and self._tournament_blocks()):
            self.drain_maintenance()

    def _tournament_blocks(self) -> bool:
        mode = self.config.league.tournament_overlap
        if mode == "always":
            return False
        if mode == "never":
            return True
        return self.tournament.device == self.device

    def _league_maintenance(self, epoch: int, cohort: list, learner_id: int,
                            league_stats, vars_copy) -> None:
        """The maintenance body: on the worker in async mode (inline
        otherwise), from captured values only. The store is an RLock plus
        a connection per call; the gauntlet plays on the store's device
        through its own modules and generators."""
        last = time.monotonic()
        lc = self.config.league

        def mark(phase: str) -> None:
            nonlocal last
            now = time.monotonic()
            self._maint_phase_s[phase] = self._maint_phase_s.get(phase, 0.0) + now - last
            last = now

        role_k = {Role.FRONTIER_STATIC: lc.elo.frontier_k, Role.DYNAMIC: lc.elo.dynamic_k,
                  Role.RECENT_FIXED: lc.elo.recent_k}
        try:
            record_epoch_results(self.store, self.scheduler, learner_id, cohort,
                                 league_stats, epoch, lc.elo_k_factor, role_k,
                                 elo_floor=lc.elo_floor)
        except Exception:
            logger.exception("league result recording failed; continuing")
        mark("record_results")
        try:
            if vars_copy is not None:
                entry = self.pool.snapshot_learner(
                    vars_copy, self.config.model.architecture,
                    dict(self.config.model.params), epoch)
                self.learner_entry_id = entry.id
                if self.config.display.db_path:
                    db.update_training_progress(self.config.display.db_path, epoch,
                                                epoch * self.T, learner_entry_id=entry.id)
            mark("snapshot")
            self.store.carry_forward_elo(epoch)
            self.pool.maybe_review_frontier(epoch)
            # retired/evicted entries release dynamic-trainer caches
            self.dyn_trainer.retain_only({e.id for e in self.store.list_by_role(Role.DYNAMIC)})
            mark("elo_review")
            if self.historical.is_due_for_refresh(epoch):
                self.historical.refresh(epoch)
            if self.gauntlet.is_due(epoch):
                self.gauntlet.run_gauntlet(epoch, self.store.get_entry(self.learner_entry_id))
            mark("historical_gauntlet")
            if self.tournament is not None and self.tournament.is_due(epoch):
                # skip rounds that went stale in a backlog: training has
                # already queued (or will queue) a fresher one
                if self.epoch - epoch >= lc.tournament_interval_epochs:
                    logger.warning("skipping stale tournament round for epoch %d "
                                   "(training is at %d)", epoch, self.epoch)
                else:
                    self.observer.heartbeat(epoch, epoch * self.T, "tournament")
                    stats = self.tournament.run_round(epoch)
                    # a firing Elo-ceiling alert means the Frontier anchors
                    # are stale now: review at once instead of on the calendar
                    if (stats.get("elo_ceiling_streak", 0)
                            >= self.tournament.ELO_CEILING_STREAK):
                        self.pool.maybe_review_frontier(epoch, force=True)
            mark("tournament")
            if self.dispatcher is not None:
                self.dispatcher.enqueue_round(epoch)
        except Exception:
            logger.exception("league epoch maintenance failed; continuing")

    def drain_maintenance(self) -> None:
        """Block until every queued maintenance task has completed: the
        synchronization point for tests and teardown."""
        while self._maint_futures:
            self._maint_futures.popleft().result()

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
        self.drain_maintenance()
        self.save()  # drains the periodic write first; blocking
        if self.league_enabled and self.store is not None:
            # queued async weight flushes land before exit; a failed final
            # flush is loud but does not abort the rest of the teardown
            try:
                self.store.wait_for_flushes()
            except RuntimeError:
                logger.exception("final league weight flush failed")
        self.observer.on_stop("stopped")


@dataclass(frozen=True)
class RankLaunch:
    """What a spawned rank needs to join the group and train."""

    config: Config
    epochs: int | None
    coordinator: str
    world_size: int
    local_world_size: int
    first_rank: int  # global rank of this host's local rank 0
    platform: str    # "cuda" or "cpu"


def _train_rank(local_rank: int, launch: RankLaunch) -> None:
    """One rank: join the group, train on cuda:<local_rank> (or the CPU),
    leave the group."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s", force=True)
    device = learner_device(launch.platform, local_rank)
    setup_distributed(launch.coordinator, world_size=launch.world_size,
                      rank=launch.first_rank + local_rank, device=device)
    try:
        mesh = make_mesh(launch.config.distributed.num_devices, device=device,
                         local_rank=local_rank, local_world_size=launch.local_world_size)
        trainer = SelfPlayTrainer(launch.config, device=device, mesh=mesh)
        try:
            trainer.run(launch.epochs)
        finally:
            trainer.close()
    finally:
        teardown_distributed()


def main(argv=None):
    import argparse

    from .config import load_config

    parser = argparse.ArgumentParser(description="keisei_tpu_torch self-play training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda, cuda:N or cpu; with several ranks (distributed.num_devices) "
                        "cuda or cpu, rank i taking its host's cuda:i")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s", force=True)
    config = load_config(args.config)
    tc = config.training
    if args.steps_per_epoch is not None:
        tc = replace(tc, steps_per_epoch=args.steps_per_epoch)
    if args.seed is not None:
        tc = replace(tc, seed=args.seed)
    config = replace(config, training=tc)
    device = torch.device(args.device)
    ctx = get_distributed_context()
    if ctx.auto:  # a launcher (torchrun) started one process per rank
        coordinator, world, local, first_rank, local_rank = torchrun_layout()
        _train_rank(local_rank, RankLaunch(config, args.epochs, coordinator, world, local,
                                           first_rank, device.type))
        return
    world, local = rank_layout(config.distributed.num_devices, ctx, device.type)
    if world == 1:
        SelfPlayTrainer(config, device=device).run(args.epochs)
        return
    if device.index is not None:
        raise ValueError(f"--device {args.device} names one card; with {world} ranks rank i "
                         "takes cuda:i of its host (pass --device cuda)")
    launch = RankLaunch(config, args.epochs, ctx.coordinator or f"localhost:{free_port()}",
                        world, local, ctx.process_id * local, device.type)
    if local == 1:
        _train_rank(0, launch)
    else:
        torch.multiprocessing.start_processes(_train_rank, args=(launch,), nprocs=local,
                                              start_method="spawn")


if __name__ == "__main__":
    main()
