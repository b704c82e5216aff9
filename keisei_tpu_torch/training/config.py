"""TOML -> frozen dataclass config (counterpart of keisei_tpu/training/config.py).

Reads the same configs/*.toml files with the same sections, dataclasses,
defaults and validation. Unknown keys are rejected per section; the
torch-only reference knobs (use_amp, compile_mode, compile_dynamic) are
accepted and ignored, as in the JAX package. `[league]` builds a
LeagueConfig (league/config.py); an enabled league refuses what is not
ported yet: a league over several devices.
"""

from __future__ import annotations

import logging
import tomllib
from dataclasses import dataclass, field, fields

from ..league.config import LeagueConfig, league_config_from_dict
from ..models.registry import VALID_ARCHITECTURES, validate_model_params
from .ppo import KataGoPPOParams

logger = logging.getLogger(__name__)

VALID_ALGORITHMS = frozenset({"katago_ppo", "ppo"})
_IGNORED_TRAINING_KEYS = {"use_amp"}
_IGNORED_ALGO_KEYS = {"use_amp", "compile_mode", "compile_dynamic"}


@dataclass(frozen=True)
class ModelConfig:
    architecture: str = "se_resnet"
    display_name: str = "unnamed"
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.architecture not in VALID_ARCHITECTURES:
            raise ValueError(f"unknown architecture {self.architecture!r}; "
                             f"valid: {sorted(VALID_ARCHITECTURES)}")
        validate_model_params(self.architecture, self.params)


@dataclass(frozen=True)
class TrainingConfig:
    num_games: int = 128
    max_ply: int = 512
    steps_per_epoch: int = 0  # 0 -> max_ply
    algorithm: str = "katago_ppo"
    checkpoint_interval: int = 50
    checkpoint_dir: str = "checkpoints/"
    checkpoint_keep: int = 5  # newest N retained (0 = unlimited)
    observation_mode: str = "katago"  # "default" (46ch) | "katago" (50ch)
    seed: int = 42
    entropy_warmup_epochs: int = 0
    entropy_warmup_coeff: float = 0.02
    lr_plateau_factor: float = 0.5
    lr_plateau_patience: int = 50
    lr_min: float = 1e-5
    # "auto"/"flax": the eager nn.Module forward; "fused": the hand-written
    # bf16 CUDA kernels (ops/); "int8": the int8 trunk (ops/qblock.py; needs
    # num_games divisible by 32)
    rollout_forward: str = "auto"
    # periodic saves copy the state on the device and write on a worker thread
    async_checkpoint: bool = True

    def __post_init__(self):
        if self.num_games <= 0:
            raise ValueError(f"num_games must be > 0, got {self.num_games}")
        if self.max_ply <= 0:
            raise ValueError(f"max_ply must be > 0, got {self.max_ply}")
        if self.algorithm not in VALID_ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"valid: {sorted(VALID_ALGORITHMS)}")
        if self.observation_mode not in ("default", "katago"):
            raise ValueError(f"bad observation_mode {self.observation_mode!r}")
        if self.checkpoint_interval < 1:
            raise ValueError(f"checkpoint_interval must be >= 1, got {self.checkpoint_interval}")
        if self.rollout_forward not in ("auto", "flax", "fused", "int8"):
            raise ValueError(f"bad rollout_forward {self.rollout_forward!r} "
                             "(valid: auto, flax, fused, int8)")

    @property
    def effective_steps_per_epoch(self) -> int:
        return self.steps_per_epoch or self.max_ply


@dataclass(frozen=True)
class DisplayConfig:
    moves_per_minute: int = 30
    db_path: str = ""  # empty = observability DB disabled


@dataclass(frozen=True)
class RunConfig:
    default_epochs: int = 1000


@dataclass(frozen=True)
class DistributedConfig:
    num_devices: int = 0  # 0 -> single device; multi-device is not ported yet
    data_axis: str = "data"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    algorithm_params: KataGoPPOParams = field(default_factory=KataGoPPOParams)
    display: DisplayConfig = field(default_factory=DisplayConfig)
    run: RunConfig = field(default_factory=RunConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    league: LeagueConfig | None = None  # when [league] is present


def _build(cls, section: dict, name: str, ignored: set[str] = frozenset()):
    valid = {f.name for f in fields(cls)}
    clean = {}
    for k, v in section.items():
        if k in ignored:
            logger.info("config: ignoring torch-only key [%s].%s", name, k)
            continue
        if k not in valid:
            raise ValueError(f"unknown key {k!r} in [{name}] (valid: {sorted(valid)})")
        clean[k] = v
    return cls(**clean)


def load_config(path: str) -> Config:
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return config_from_dict(raw, source=path)


def config_from_dict(raw: dict, source: str = "<dict>") -> Config:
    known = {"model", "training", "display", "run", "distributed", "league"}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown config sections in {source}: {sorted(unknown)}")
    model_raw = dict(raw.get("model", {}))
    model_params = model_raw.pop("params", {})
    model = _build(ModelConfig, {**model_raw, "params": model_params}, "model")
    training_raw = dict(raw.get("training", {}))
    algo_raw = dict(training_raw.pop("algorithm_params", {}))
    training = _build(TrainingConfig, training_raw, "training", _IGNORED_TRAINING_KEYS)
    algo = _build(KataGoPPOParams, algo_raw, "training.algorithm_params", _IGNORED_ALGO_KEYS)
    distributed = _build(DistributedConfig, raw.get("distributed", {}), "distributed")
    league = league_config_from_dict(raw["league"]) if "league" in raw else None
    if league is not None and league.enabled:
        if distributed.num_devices not in (0, 1):
            raise NotImplementedError(
                f"{source}: league mode over several devices is not yet ported to "
                "keisei_tpu_torch (distributed.num_devices must be 0 or 1)")
        if not league.color_randomization:
            logger.warning(
                "config: league.color_randomization=false biases learner color "
                "exposure; the split-merge rollout re-rolls colors per episode when "
                "enabled")
    return Config(
        model=model, training=training, algorithm_params=algo,
        display=_build(DisplayConfig, raw.get("display", {}), "display"),
        run=_build(RunConfig, raw.get("run", {}), "run"),
        distributed=distributed, league=league,
    )
