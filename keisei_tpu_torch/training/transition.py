"""SL -> RL transition: warm-start the RL loop from supervised weights
(counterpart of keisei_tpu/training/transition.py).

Validate the model params before the expensive SL run (no shard opened,
no directory made); train; save `checkpoint_dir/sl_final` tagged
phase="sl"; return a trainer pinned to that checkpoint, whose resume loads
the weights only, keeps its own optimizer and generator, and starts at
epoch 0. Pinned, because auto-discovery prefers the highest epoch: an old
RL run in the same directory would otherwise outrank sl_final.
"""

from __future__ import annotations

import logging
import os

import torch

from ..models.registry import validate_model_params
from ..sl.dataset import SLDataset
from ..sl.trainer import SLConfig, SLTrainer
from .config import Config, load_config
from .loop import SelfPlayTrainer

logger = logging.getLogger(__name__)


def sl_to_rl(
    *,
    sl_data_dir: str,
    sl_epochs: int,
    rl_config: Config | str,
    sl_batch_size: int = 4096,
    sl_learning_rate: float = 1e-3,
    device: torch.device | str = "cuda",
) -> SelfPlayTrainer:
    """Run SL training on `device` (the card unless the caller names
    "cpu"), save the checkpoint into the RL checkpoint dir, and return an
    RL trainer resumed from it (optimizer skipped, epoch 0)."""
    config = load_config(rl_config) if isinstance(rl_config, str) else rl_config
    architecture = config.model.architecture
    model_params = dict(config.model.params)
    validate_model_params(architecture, model_params)

    dataset = SLDataset(sl_data_dir)
    if len(dataset) == 0:
        raise ValueError(f"no SL positions found under {sl_data_dir}")
    sl_cfg = SLConfig(
        learning_rate=sl_learning_rate, batch_size=sl_batch_size,
        epochs=sl_epochs, seed=config.training.seed,
    )
    trainer = SLTrainer(sl_cfg, architecture, model_params, dataset, device=device)
    logger.info("SL training: %d epochs over %d positions", sl_epochs, len(dataset))
    trainer.train()

    ckpt_dir = config.training.checkpoint_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    sl_path = os.path.join(ckpt_dir, "sl_final")
    trainer.save(sl_path)
    logger.info("SL checkpoint saved to %s", sl_path)
    return SelfPlayTrainer(config, device=device, resume_from=sl_path)
