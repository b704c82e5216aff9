"""League configuration tree: frozen dataclasses with validation
(counterpart of keisei_tpu/league/config.py: the same fields, defaults,
validation and `league_config_from_dict`, so the same [league] sections
parse to the same values; only the comments speak of the port).

`opponent_device` is N/A by design (opponents ride the learner's rollout
on its device); `tournament_device` and the tournament's fields are read
by the port's tournament (league/tournament.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields


@dataclass(frozen=True)
class FrontierStaticConfig:
    slots: int = 5
    review_interval_epochs: int = 250
    min_tenure_epochs: int = 100
    promotion_margin_elo: float = 50.0
    min_games_for_promotion: int = 64
    topk: int = 3
    streak_epochs: int = 50
    max_lineage_overlap: int = 2
    replace_policy: str = "weakest_or_stalest_after_cooldown"
    span_selection: bool = True

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"frontier.slots must be >= 1, got {self.slots}")
        if self.topk < 1:
            raise ValueError(f"frontier.topk must be >= 1, got {self.topk}")
        if self.review_interval_epochs < 1:
            raise ValueError("frontier.review_interval_epochs must be >= 1")
        if self.replace_policy != "weakest_or_stalest_after_cooldown":
            raise ValueError(
                f"unsupported replace_policy {self.replace_policy!r}"
            )


@dataclass(frozen=True)
class RecentFixedConfig:
    slots: int = 5
    min_games_for_review: int = 32
    min_unique_opponents: int = 6
    promotion_margin_elo: float = 25.0
    max_elo_spread: float = 200.0
    spread_window: int = 50
    soft_overflow: int = 1
    retire_if_below_dynamic_floor: bool = True

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"recent.slots must be >= 1, got {self.slots}")
        if self.min_games_for_review < 0:
            raise ValueError("recent.min_games_for_review must be >= 0")


@dataclass(frozen=True)
class DynamicConfig:
    slots: int = 10
    protection_matches: int = 24
    min_games_before_eviction: int = 40
    training_enabled: bool = True
    update_epochs_per_batch: int = 2
    lr_scale: float = 0.25
    grad_clip: float = 1.0
    update_every_matches: int = 4
    # each update's async weight flush copies a full tree off the device
    # and writes it; a high rate would queue flushes faster than they drain
    max_updates_per_minute: int = 6
    checkpoint_flush_every: int = 8
    # write an entry's updated WEIGHTS to disk only every Nth update
    # (intermediate generations stay pinned in the store's device cache;
    # wait_for_flushes lands the newest at teardown). Readers in other
    # processes lag by < N generations, which sidecar semantics already
    # tolerate. 1 = flush every update.
    weight_flush_every: int = 4
    disable_on_error: bool = True
    max_buffer_depth: int = 8
    max_consecutive_errors: int = 3
    batch_reuse: int = 1
    global_error_threshold: int = 5
    global_error_window_seconds: float = 300.0
    gpu_memory_backpressure: float = 0.9  # accepted for file compatibility
    # park Adam moments on the host between updates: at 10 slots the
    # device-resident moments alone are ~10 x 2 x params. With the device
    # cache below, only entries evicted from it pay the round trip.
    offload_optimizer: bool = True
    # keep the K most-recently-trained entries' moments ON DEVICE even
    # with offload_optimizer: tournament rounds train the same few
    # entries repeatedly, and a host round trip moves ~2 x 2 x params
    # bytes per update. 0 = round-trip every update.
    optimizer_device_cache: int = 2
    # hard cap on dynamic updates per tournament round, on top of the
    # per-minute rate limit: bounds the worst-case round duration that
    # overlapped training epochs must absorb
    max_updates_per_round: int = 4

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"dynamic.slots must be >= 1, got {self.slots}")
        if not (0 < self.lr_scale <= 1.0):
            raise ValueError(f"dynamic.lr_scale must be in (0, 1], got {self.lr_scale}")
        if self.grad_clip <= 0:
            raise ValueError("dynamic.grad_clip must be > 0")
        if self.update_every_matches < 1:
            raise ValueError("dynamic.update_every_matches must be >= 1")
        if self.max_consecutive_errors < 1:
            raise ValueError("dynamic.max_consecutive_errors must be >= 1")
        if self.optimizer_device_cache < 0:
            raise ValueError("dynamic.optimizer_device_cache must be >= 0")
        if self.weight_flush_every < 1:
            raise ValueError("dynamic.weight_flush_every must be >= 1")
        if self.max_updates_per_round < 1:
            raise ValueError("dynamic.max_updates_per_round must be >= 1")


@dataclass(frozen=True)
class MatchSchedulerConfig:
    learner_dynamic_ratio: float = 0.50
    learner_frontier_ratio: float = 0.30
    learner_recent_ratio: float = 0.20
    tournament_games_per_pair: int = 3
    tournament_mode: str = "full"  # "full" | "weighted" | "random"
    weighted_round_size: int = 0
    pairing_policy: str = "role_weighted_sparse_h2h"
    dynamic_dynamic_weight: float = 0.40
    dynamic_recent_weight: float = 0.25
    dynamic_frontier_weight: float = 0.20
    recent_frontier_weight: float = 0.10
    recent_recent_weight: float = 0.05
    challenge_threshold: float = 0.70
    challenge_window: int = 100
    min_coverage_ratio: float = 0.5

    def __post_init__(self):
        s = (self.learner_dynamic_ratio + self.learner_frontier_ratio
             + self.learner_recent_ratio)
        if abs(s - 1.0) > 1e-6:
            raise ValueError(f"learner mix ratios must sum to 1.0, got {s}")
        w = (self.dynamic_dynamic_weight + self.dynamic_recent_weight
             + self.dynamic_frontier_weight + self.recent_frontier_weight
             + self.recent_recent_weight)
        if abs(w - 1.0) > 1e-6:
            raise ValueError(f"match-class weights must sum to 1.0, got {w}")
        if self.tournament_mode not in ("full", "weighted", "random"):
            raise ValueError(f"bad tournament_mode {self.tournament_mode!r}")
        if not (0.0 <= self.min_coverage_ratio <= 1.0):
            raise ValueError("min_coverage_ratio must be in [0, 1]")


@dataclass(frozen=True)
class HistoricalLibraryConfig:
    enabled: bool = True
    slots: int = 5
    refresh_interval_epochs: int = 100
    min_epoch_for_selection: int = 10
    selection: str = "log_spaced"
    active_league_participation: bool = False

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("history.slots must be >= 1")
        if self.selection != "log_spaced":
            raise ValueError(f"unsupported selection {self.selection!r}")
        if self.active_league_participation:
            raise ValueError("historical entries never join active matchmaking")


@dataclass(frozen=True)
class GauntletConfig:
    enabled: bool = True
    interval_epochs: int = 100
    games_per_matchup: int = 16

    def __post_init__(self):
        if self.interval_epochs < 1:
            raise ValueError("gauntlet.interval_epochs must be >= 1")
        if self.games_per_matchup < 1:
            raise ValueError("gauntlet.games_per_matchup must be >= 1")


@dataclass(frozen=True)
class RoleEloConfig:
    frontier_k: float = 16.0
    dynamic_k: float = 24.0
    recent_k: float = 32.0
    historical_k: float = 12.0
    track_role_specific: bool = True

    def __post_init__(self):
        for name in ("frontier_k", "dynamic_k", "recent_k", "historical_k"):
            if getattr(self, name) <= 0:
                raise ValueError(f"elo.{name} must be > 0")


@dataclass(frozen=True)
class PriorityScorerConfig:
    under_sample_weight: float = 1.0
    uncertainty_weight: float = 0.5
    recent_fixed_bonus: float = 0.3
    diversity_weight: float = 0.3
    match_class_weight: float = 1.0
    frontier_exposure_weight: float = 0.4
    frontier_exposure_threshold: int = 10
    repeat_penalty: float = -0.5
    lineage_penalty: float = -0.3
    repeat_window_rounds: int = 5

    def __post_init__(self):
        for f_ in fields(self):
            v = getattr(self, f_.name)
            if isinstance(v, float) and not math.isfinite(v):
                raise ValueError(f"priority.{f_.name} must be finite")
        if self.repeat_penalty > 0 or self.lineage_penalty > 0:
            raise ValueError("penalties must be <= 0")


@dataclass(frozen=True)
class ConcurrencyConfig:
    parallel_matches: int = 4
    envs_per_match: int = 16
    model_cache_size: int = 8

    def __post_init__(self):
        if self.parallel_matches < 1:
            raise ValueError("concurrency.parallel_matches must be >= 1")
        if self.envs_per_match < 1:
            raise ValueError("concurrency.envs_per_match must be >= 1")


@dataclass(frozen=True)
class StorageConfig:
    league_dir: str = "league/"
    # device-resident weight LRU bounds (OpponentStore): count cap plus a
    # device-memory byte budget, the binding limit at flagship scale (fp32
    # native trees from dynamic updates are 2x the bf16 inference trees)
    cache_entries: int = 16
    cache_bytes_gb: float = 3.0
    # dtype of learner SNAPSHOTS admitted to the pool. "bfloat16" halves
    # the per-snapshot device->host transfer and disk/device footprint;
    # opponents are inference-only (the model computes in bf16 anyway),
    # and a snapshot cloned into the Dynamic tier is cast back to f32 by
    # the trainer before its first update (one-time ~1e-3 rounding).
    # Training-resume checkpoints are separate and always full precision.
    snapshot_dtype: str = "float32"

    def __post_init__(self):
        if self.cache_entries < 1:
            raise ValueError("storage.cache_entries must be >= 1")
        if self.cache_bytes_gb <= 0:
            raise ValueError("storage.cache_bytes_gb must be > 0")
        if self.snapshot_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"bad storage.snapshot_dtype {self.snapshot_dtype!r} "
                "(float32 | bfloat16)")


@dataclass(frozen=True)
class LeagueConfig:
    enabled: bool = True
    mode: str = "mixed"
    max_active_entries: int | None = None
    snapshot_interval: int = 10
    epochs_per_seat: int = 50
    initial_elo: float = 1000.0
    elo_k_factor: float = 32.0
    elo_floor: float = 500.0
    color_randomization: bool = True
    per_env_opponents: bool = True  # False = single opponent per epoch
    opponents_per_epoch: int = 4
    # N/A by design: split-merge opponents ride the learner's rollout on
    # its device (league_rollout.py). Accepted for file compatibility.
    opponent_device: str | None = None
    tournament_enabled: bool = False
    # the device of in-process tournament rounds (match play + dynamic
    # updates), the reference's learner-GPU-0/tournament-GPU-1 split;
    # None/"default" = the learner's. Consumed by the tournament
    # (league/tournament.py).
    tournament_device: str | None = None
    tournament_num_envs: int = 64
    tournament_games_per_match: int = 3
    # NOTE scheduler.tournament_games_per_pair and dynamic.batch_reuse parse
    # and validate but have no consumer — TRUE IN THE REFERENCE TOO (grep:
    # config-only); kept for config-file compatibility
    tournament_k_factor: float = 16.0
    # accepted for file compatibility: rounds run at
    # tournament_interval_epochs boundaries, with no thread to pace
    tournament_pause_seconds: float = 1.0
    # in_process tournaments run at epoch boundaries on the learner's
    # device unless tournament_device names another; gate how often so
    # match play does not dominate the learner's wall clock.
    tournament_interval_epochs: int = 5
    tournament_mode: str = "in_process"
    # Whether an in-process tournament round may OVERLAP the next training
    # epochs (ride the async maintenance worker) or blocks training until
    # it completes. "auto" (default): overlap only when the round has its
    # own device (tournament_device set): on one device both contend for
    # one stream and every host sync inside the round waits behind the
    # training epoch's queued work. "always"/"never" force it.
    tournament_overlap: str = "auto"
    # Run post-epoch league maintenance (Elo recording, learner snapshots,
    # tier reviews, gauntlet) on a FIFO background worker so its host-side
    # time overlaps the next epoch's device time. False = inline, after
    # each epoch (deterministic for tests; SelfPlayTrainer.drain_maintenance()
    # is the async-mode synchronization point).
    async_maintenance: bool = True
    dispatcher_max_queue_depth: int = 400
    max_staleness_epochs: int = 50
    frontier: FrontierStaticConfig = field(default_factory=FrontierStaticConfig)
    recent: RecentFixedConfig = field(default_factory=RecentFixedConfig)
    dynamic: DynamicConfig = field(default_factory=DynamicConfig)
    scheduler: MatchSchedulerConfig = field(default_factory=MatchSchedulerConfig)
    history: HistoricalLibraryConfig = field(default_factory=HistoricalLibraryConfig)
    gauntlet: GauntletConfig = field(default_factory=GauntletConfig)
    elo: RoleEloConfig = field(default_factory=RoleEloConfig)
    priority: PriorityScorerConfig = field(default_factory=PriorityScorerConfig)
    concurrency: ConcurrencyConfig = field(default_factory=ConcurrencyConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)

    def __post_init__(self):
        if self.mode != "mixed":
            raise ValueError(f"only 'mixed' league mode is supported, got {self.mode!r}")
        if self.snapshot_interval < 1:
            raise ValueError("league.snapshot_interval must be >= 1")
        if self.epochs_per_seat < 1:
            raise ValueError("league.epochs_per_seat must be >= 1")
        if self.elo_floor > self.initial_elo:
            raise ValueError("elo_floor must be <= initial_elo")
        if self.opponents_per_epoch < 1:
            raise ValueError("league.opponents_per_epoch must be >= 1")
        if not self.per_env_opponents and self.opponents_per_epoch > 1:
            raise ValueError(
                "per_env_opponents = false means a single opponent per "
                "epoch - set opponents_per_epoch = 1 (the split-merge "
                "rollout assigns opponents per env block)"
            )
        if self.tournament_mode not in ("in_process", "sidecar"):
            raise ValueError(f"bad tournament_mode {self.tournament_mode!r}")
        if self.tournament_overlap not in ("auto", "always", "never"):
            raise ValueError(
                f"bad tournament_overlap {self.tournament_overlap!r} "
                "(auto | always | never)")
        if self.tournament_interval_epochs < 1:
            raise ValueError("league.tournament_interval_epochs must be >= 1")


_SUB_SECTIONS = {
    "frontier": FrontierStaticConfig,
    "recent": RecentFixedConfig,
    "dynamic": DynamicConfig,
    "scheduler": MatchSchedulerConfig,
    "history": HistoricalLibraryConfig,
    "gauntlet": GauntletConfig,
    "elo": RoleEloConfig,
    "priority": PriorityScorerConfig,
    "concurrency": ConcurrencyConfig,
    "storage": StorageConfig,
}


def league_config_from_dict(raw: dict) -> LeagueConfig:
    """Build a LeagueConfig from a parsed [league] TOML section, rejecting
    unknown keys per sub-section (reference config.py:566-572 discipline)."""
    raw = dict(raw)
    kwargs: dict = {}
    for name, cls in _SUB_SECTIONS.items():
        sub = raw.pop(name, None)
        if sub is not None:
            valid = {f.name for f in fields(cls)}
            unknown = set(sub) - valid
            if unknown:
                raise ValueError(
                    f"unknown keys in [league.{name}]: {sorted(unknown)}"
                )
            kwargs[name] = cls(**sub)
    valid = {f.name for f in fields(LeagueConfig)}
    unknown = set(raw) - valid
    if unknown:
        raise ValueError(f"unknown keys in [league]: {sorted(unknown)}")
    return LeagueConfig(**raw, **kwargs)
