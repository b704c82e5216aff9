"""Supervised-learning trainer (counterpart of keisei_tpu/sl/trainer.py):
CE(policy) + 1.5*CE(W/D/L) + 0.02*MSE(score).

The model is the eager nn.Module of models/registry.py in train mode (its
own bf16 autocast, as in the PPO update; BatchNorm statistics move on
every step as flax's `mutable=["batch_stats"]` moves them), with autograd,
optax's clip-by-global-norm (no epsilon) and Adam with optax's defaults.
The learning rate follows optax's cosine decay schedule over
`epochs * max(n_train // batch, 1)` steps, read at the step count before
the step and clamped at the horizon (a split whose tail `batches` drops
trains fewer steps than the horizon; an extra epoch trains past it).
Minibatches come from `np.random.default_rng(seed)` exactly as the JAX
trainer draws them. Losses stay on the device until the epoch ends.

The final checkpoint is written with training/checkpoint.py (phase="sl",
epoch 0), so the RL trainer warm-starts from it: weights only, epoch 0.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..models.registry import build_model, get_model_contract
from ..training.checkpoint import save_checkpoint
from ..training.ppo import clip_by_global_norm_, set_learning_rate
from ..utils.device import resolve_device
from .dataset import SLDataset

logger = logging.getLogger(__name__)

# Above this many rows a step recomputes each trunk block in its backward
# (models/se_resnet.py, `recompute_blocks`) in place of keeping the block's
# activations. b40c256 on an H100 80GB (700 W), without it: 2,048 rows peak
# at 57.60 GB, 4,096 (sl_to_rl's default) run out of memory at 83.67 GB; with
# it 4,096 rows peak at 12.25 GB, at 1.25x the time a row
# (scripts/sl_smoke.py --probe-batch 1024 2048 4096). Steps of at most this
# many rows keep every activation, as before.
RECOMPUTE_ABOVE = 2048


@dataclass(frozen=True)
class SLConfig:
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 10
    lambda_policy: float = 1.0
    lambda_value: float = 1.5
    lambda_score: float = 0.02
    grad_clip: float = 1.0
    min_lr_fraction: float = 0.01
    seed: int = 0


def cosine_decay_lr(init_value: float, decay_steps: int, alpha: float, count: int) -> float:
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha)(count),
    in float32 as the jitted schedule computes it."""
    f32 = np.float32
    c = f32(min(count, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
    return float(f32(init_value) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))


class SLTrainer:
    def __init__(self, config: SLConfig, architecture: str, model_params: dict,
                 dataset: SLDataset, train_indices: np.ndarray | None = None,
                 device: torch.device | str = "cuda"):
        """`train_indices` restricts each training epoch to that subset of
        dataset positions (the complement can then serve as a held-out
        evaluation split for `evaluate()`); None trains on everything.
        `device`: the card unless the caller names "cpu"."""
        self.config = config
        self.architecture = architecture
        self.model_params = dict(model_params)
        self.dataset = dataset
        self.train_indices = (
            None if train_indices is None
            else np.asarray(train_indices, np.int64))
        self.contract = get_model_contract(architecture)
        if self.contract != "katago":
            raise NotImplementedError(
                "the SL trainer's scalar contract is not yet ported to keisei_tpu_torch "
                "(ROADMAP queue A item 7: the scalar-contract models)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 matmuls and convs in full f32, as the JAX reference computes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            self.model, self.model_cfg = build_model(architecture, model_params)
        self.model.to(self.device)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        # Adam with optax's defaults (eps outside the sqrt); the schedule
        # sets the learning rate before every step
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

        n_train = (len(dataset) if self.train_indices is None
                   else len(self.train_indices))
        self.decay_steps = config.epochs * max(n_train // config.batch_size, 1)
        if not self.decay_steps > 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, got "
                f"decay_steps={self.decay_steps}.")
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.rng = np.random.default_rng(config.seed)
        # per step of the last train_epoch: losses and the learning rate used
        self.step_metrics: list[dict[str, float]] = []

    def learning_rate(self, count: int) -> float:
        c = self.config
        return cosine_decay_lr(c.learning_rate, self.decay_steps, c.min_lr_fraction, count)

    def _to_device(self, batch: dict) -> dict[str, torch.Tensor]:
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t

        return {
            "obs": put(batch["observation"]).reshape(-1, 50, 9, 9),
            "policy": put(batch["policy_target"]),
            "value": put(batch["value_target"]),
            "score": put(batch["score_target"]),
        }

    def _train_step(self, b: dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        self.model.train()
        B = b["obs"].shape[0]
        out = self.model(b["obs"], recompute_blocks=B > RECOMPUTE_ABOVE)
        logp = F.log_softmax(out.policy_logits.reshape(B, -1).float(), dim=-1)
        policy_loss = -torch.gather(logp, 1, b["policy"][:, None])[:, 0].mean()
        vlogp = F.log_softmax(out.value_logits.float(), dim=-1)
        value_loss = -torch.gather(vlogp, 1, b["value"][:, None])[:, 0].mean()
        score_loss = ((out.score_lead[:, 0].float() - b["score"]) ** 2).mean()
        loss = (cfg.lambda_policy * policy_loss + cfg.lambda_value * value_loss
                + cfg.lambda_score * score_loss)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_(self.params, cfg.grad_clip)
        self.optimizer.step()
        return torch.stack([policy_loss.detach(), value_loss.detach(), score_loss.detach()])

    def train_epoch(self) -> dict[str, float]:
        order = (None if self.train_indices is None
                 else self.rng.permutation(self.train_indices))
        rows, lrs = [], []
        for batch in self.dataset.batches(self.config.batch_size, self.rng, order=order):
            lr = self.learning_rate(self.step)
            set_learning_rate(self.optimizer, lr)
            rows.append(self._train_step(self._to_device(batch)))
            lrs.append(lr)
            self.step += 1
        keys = ("policy_loss", "value_loss", "score_loss")
        host = torch.stack(rows).tolist() if rows else []  # one sync per epoch
        self.step_metrics = [{**dict(zip(keys, r)), "learning_rate": lr}
                             for r, lr in zip(host, lrs)]
        n = len(host)
        totals = {k: 0.0 for k in keys}
        for r in host:
            for k, v in zip(keys, r):
                totals[k] += v
        out = {k: v / max(n, 1) for k, v in totals.items()}
        out["batches"] = n
        logger.info(
            "SL epoch | policy=%.4f value=%.4f score=%.4f (%d batches)",
            out["policy_loss"], out["value_loss"], out["score_loss"], n,
        )
        return out

    def train(self) -> list[dict[str, float]]:
        return [self.train_epoch() for _ in range(self.config.epochs)]

    @torch.no_grad()
    def _eval_step(self, b: dict[str, torch.Tensor]) -> torch.Tensor:
        self.model.eval()
        out = self.model(b["obs"])
        B = b["obs"].shape[0]
        flat = out.policy_logits.reshape(B, -1).float()
        top1 = (flat.argmax(dim=-1) == b["policy"]).sum()
        # top-5: is the target's logit within the 5 largest? (ties count)
        kth = torch.topk(flat, 5, dim=-1).values[:, -1]
        tgt = torch.gather(flat, 1, b["policy"][:, None])[:, 0]
        top5 = (tgt >= kth).sum()
        logp = F.log_softmax(flat, dim=-1)
        nll = -torch.gather(logp, 1, b["policy"][:, None])[:, 0].sum()
        vacc = (out.value_logits.argmax(dim=-1) == b["value"]).sum()
        smse = ((out.score_lead[:, 0].float() - b["score"]) ** 2).sum()
        return torch.stack([top1.float(), top5.float(), nll, vacc.float(), smse])

    def evaluate(self, indices: np.ndarray,
                 batch_size: int | None = None) -> dict[str, float]:
        """Held-out metrics over a fixed index set: policy top-1/top-5
        accuracy, policy NLL, value-head accuracy, score MSE."""
        bs = batch_size or self.config.batch_size
        rows, n = [], 0
        # drop_last, as the JAX trainer's fixed-shape eval step does
        for batch in self.dataset.batches(bs, order=indices, drop_last=True):
            b = self._to_device(batch)
            rows.append(self._eval_step(b))
            n += len(batch["policy_target"])
        if n == 0:
            raise ValueError("evaluation split smaller than one batch")
        keys = ("top1", "top5", "nll", "value_acc", "score_se")
        totals = {k: 0.0 for k in keys}
        for r in torch.stack(rows).tolist():
            for k, v in zip(keys, r):
                totals[k] += v
        return {
            "positions": n,
            "policy_top1": totals["top1"] / n,
            "policy_top5": totals["top5"] / n,
            "policy_nll": totals["nll"] / n,
            "value_acc": totals["value_acc"] / n,
            "score_mse": totals["score_se"] / n,
        }

    def save(self, path: str) -> str:
        save_checkpoint(
            path, self.model, self.optimizer, epoch=0, architecture=self.architecture,
            generator=self.generator,
            extra_meta={"phase": "sl", "model_params": self.model_params},
        )
        return path
