"""KataGo-style multi-head PPO (counterpart of keisei_tpu/training/ppo.py).

Clipped surrogate, W/D/L cross-entropy with ignore-index, score MSE,
legal-only entropy, global advantage normalisation (population std),
global-norm gradient clipping exactly as optax.clip_by_global_norm
(g * max_norm / ||g|| when ||g|| >= max_norm, no epsilon) and Adam with the
optax defaults. The update mutates the model and optimizer in place; over
a mesh of ranks it computes the single process's update on the global
batch (PPOUpdate).
A league trajectory (`Trajectory.valid` set) takes the sparse branch:
masked GAE, the weighted mean and population variance of the
advantages with empty slots zeroed, and sample weights in every loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import defaultdict
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.se_resnet import synced_batch_stats
from ..parallel.mesh import GradientBucket, Mesh, all_reduce_sum
from .gae import compute_gae, compute_gae_masked
from .value_adapter import MinibatchCounts, MultiHeadValueAdapter

SCORE_NORMALIZATION = 76.0  # shared with the SL pipeline (keisei_tpu/sl/dataset.py)
ILLEGAL_LOGIT = -1e9


@dataclass(frozen=True)
class KataGoPPOParams:
    """Hyperparameters; the same fields, defaults and validation as the JAX
    package's KataGoPPOParams."""

    learning_rate: float = 2e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    epochs_per_batch: int = 4
    batch_size: int = 256
    lambda_policy: float = 1.0
    lambda_value: float = 1.5
    lambda_score: float = 0.02
    lambda_entropy: float = 0.01
    score_normalization: float = SCORE_NORMALIZATION
    grad_clip: float = 1.0
    entropy_decay_epochs: int = 0
    score_blend_alpha: float = 0.0
    use_terminated_for_gae: bool = True

    def __post_init__(self):
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {self.batch_size}")
        if self.epochs_per_batch <= 0:
            raise ValueError(f"epochs_per_batch must be > 0, got {self.epochs_per_batch}")
        if not 0.0 <= self.gamma <= 1.0:
            raise ValueError(f"gamma must be in [0, 1], got {self.gamma}")
        if not 0.0 <= self.gae_lambda <= 1.0:
            raise ValueError(f"gae_lambda must be in [0, 1], got {self.gae_lambda}")
        if self.clip_epsilon < 0.0:
            raise ValueError(f"clip_epsilon must be >= 0, got {self.clip_epsilon}")
        if self.learning_rate <= 0.0:
            raise ValueError(f"learning_rate must be > 0, got {self.learning_rate}")
        if self.grad_clip <= 0.0:
            raise ValueError(f"grad_clip must be > 0, got {self.grad_clip}")


@dataclass
class Trajectory:
    """(T, N, ...) rollout storage on the device."""

    obs: torch.Tensor                  # (T, N, C, 81) f32
    actions: torch.Tensor              # (T, N) int64
    log_probs: torch.Tensor            # (T, N) f32
    values: torch.Tensor               # (T, N) f32
    rewards: torch.Tensor              # (T, N) f32
    dones: torch.Tensor                # (T, N) bool
    terminated: torch.Tensor           # (T, N) bool
    legal_masks: torch.Tensor          # (T, N, A) bool
    value_cats: torch.Tensor           # (T, N) int64: -1 ignore / 0 W / 1 D / 2 L
    score_targets: torch.Tensor        # (T, N) f32 (normalised)
    next_value_override: torch.Tensor  # (T, N) f32, NaN = default bootstrap
    # league mode only: False slots hold no learner transition (split-merge
    # finalization is sparse in time). None = every slot valid (self-play).
    valid: torch.Tensor | None = None  # (T, N) bool


def make_optimizer(model: torch.nn.Module, cfg: KataGoPPOParams) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    sqrt); clipping is done by the update, before the step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def masked_log_softmax(flat_logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log-softmax in f32 with illegal logits set to -1e9 (not -inf)."""
    masked = torch.where(mask, flat_logits.float(), ILLEGAL_LOGIT)
    return F.log_softmax(masked, dim=-1)


def compute_value_cats(rewards: torch.Tensor, terminal: torch.Tensor) -> torch.Tensor:
    """{-1 ignore, 0 win, 1 draw, 2 loss} from terminal rewards."""
    cats = torch.where(rewards > 0, 0, torch.where(rewards < 0, 2, 1))
    return torch.where(terminal, cats, -1).long()


def clip_by_global_norm_(params: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on .grad in place; returns the pre-clip norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def masked_policy_sample(out, legal_masks: torch.Tensor, adapter: MultiHeadValueAdapter,
                         generator: torch.Generator | None = None,
                         actions: torch.Tensor | None = None):
    """(actions, log_probs, values): legal-masked categorical sample in f32
    (Gumbel-max with `generator`), unless `actions` are given, in which case
    their log-probs are returned."""
    b = legal_masks.shape[0]
    masked = torch.where(legal_masks, out.policy_logits.reshape(b, -1).float(), ILLEGAL_LOGIT)
    if actions is None:
        u = torch.rand(masked.shape, generator=generator, device=masked.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        actions = torch.argmax(masked + gumbel, dim=-1)
    actions = actions.long()
    logp_all = F.log_softmax(masked, dim=-1)
    log_probs = torch.gather(logp_all, 1, actions[:, None])[:, 0]
    return actions, log_probs, adapter.scalar_value_blended(out)


def gather_trajectory(traj: Trajectory, next_value: torch.Tensor,
                      mesh: Mesh) -> tuple[Trajectory, torch.Tensor]:
    """The global (T, N) trajectory and (N,) next values on every rank,
    from each rank's (T, N/W) columns in rank order: one all-gather per
    dtype of the fields packed side by side (booleans travel as bytes),
    and one for the next values."""
    T, n = traj.rewards.shape
    present = {f.name: getattr(traj, f.name) for f in dataclasses.fields(Trajectory)
               if getattr(traj, f.name) is not None}
    by_dtype = defaultdict(list)
    for name, t in present.items():
        x = t.view(torch.uint8) if t.dtype == torch.bool else t
        by_dtype[x.dtype].append((name, x.reshape(T, n, -1)))
    gathered = {}
    for items in by_dtype.values():
        full = mesh.all_gather(torch.cat([x for _, x in items], dim=2), dim=1)
        for (name, _), part in zip(items, full.split([x.shape[2] for _, x in items], dim=2)):
            src = present[name]
            part = part.reshape((T, n * mesh.world_size) + src.shape[2:])
            gathered[name] = part.view(torch.bool) if src.dtype == torch.bool else part
    return Trajectory(**gathered), mesh.all_gather(next_value, dim=0)


class PPOUpdate:
    """update(traj, next_value, generator, entropy_coeff, perms=None) ->
    metrics dict of floats. GAE -> advantage normalisation -> epochs x
    minibatches. Samples past the last full minibatch of each epoch's
    permutation are dropped; `perms` (one index permutation of T*N per
    epoch) replaces the generator's, so tests can fix the minibatches.

    The W ranks of `mesh` (one with no mesh) together compute what one
    process computes on the whole batch, as XLA does under the JAX
    package's mesh: rank r takes rows [r B/W, (r+1) B/W) of every global
    minibatch of B rows (unequal slices where W does not divide B), and
    every mean divides by the global count (`MinibatchCounts`). In a
    process group each rank's (T, N/W) trajectory is gathered once, so
    GAE, the advantage normalisation and the permutation (a generator in
    the same state on every rank) are global; BatchNorm takes the global
    batch's statistics; and the gradients and loss terms are summed over
    the ranks in one bucket before the clip. The norm, the Adam step and
    the metrics are then the same on every rank. One rank takes every row
    with share 1.0, which leaves its bits as they were."""

    def __init__(self, model: torch.nn.Module, adapter: MultiHeadValueAdapter,
                 cfg: KataGoPPOParams, optimizer: torch.optim.Optimizer,
                 mesh: Mesh | None = None):
        self.model, self.adapter, self.cfg, self.optimizer = model, adapter, cfg, optimizer
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.mesh = mesh if mesh is not None else Mesh()
        if cfg.batch_size < self.mesh.world_size:
            raise ValueError(f"batch_size {cfg.batch_size} leaves a rank of "
                             f"{self.mesh.world_size} without rows")
        self.bucket = None
        if self.mesh.group is not None:
            self.bucket = GradientBucket(self.mesh, self.params, extra=4)

    def prepare(self, traj: Trajectory, next_value: torch.Tensor) -> dict[str, torch.Tensor]:
        """The (S, ...) global training data: advantages (normalised),
        returns and the flattened trajectory fields."""
        cfg = self.cfg
        if self.mesh.group is not None:
            traj, next_value = gather_trajectory(traj, next_value, self.mesh)
        T, N = traj.rewards.shape
        S = T * N
        if S // cfg.batch_size == 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} exceeds the {S}-sample trajectory; no "
                "minibatch would run — lower algorithm_params.batch_size or raise "
                "steps/num_games")
        if traj.valid is None:
            terminated = traj.terminated if cfg.use_terminated_for_gae else traj.dones
            advantages = compute_gae(
                traj.rewards, traj.values, terminated, next_value, cfg.gamma, cfg.gae_lambda,
                traj.next_value_override, chain_cut=traj.dones, alternating=True)
            weights = None
        else:
            # league split-merge: sparse learner slots, done-bounded chains
            advantages = compute_gae_masked(
                traj.rewards, traj.values, traj.dones, traj.valid, next_value,
                cfg.gamma, cfg.gae_lambda, traj.next_value_override)
            weights = traj.valid.reshape(S).float()
        returns = advantages + traj.values
        adv = advantages.reshape(S)
        if weights is None:
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        else:
            n_v = torch.clamp(weights.sum(), min=1.0)
            mean = (adv * weights).sum() / n_v
            var = (((adv - mean) ** 2) * weights).sum() / n_v
            adv = (adv - mean) / (torch.sqrt(var) + 1e-8) * weights
        data = {
            "obs": traj.obs.reshape(S, -1, 9, 9),
            "actions": traj.actions.reshape(S).long(),
            "old_log_probs": traj.log_probs.reshape(S),
            "advantages": adv,
            "returns": returns.reshape(S),
            "legal_masks": traj.legal_masks.reshape(S, -1),
            "value_cats": traj.value_cats.reshape(S),
            "score_targets": traj.score_targets.reshape(S),
        }
        if weights is not None:
            data["weights"] = weights
        return data

    def backward(self, data: dict[str, torch.Tensor], ix: torch.Tensor,
                 entropy_coeff: float) -> torch.Tensor:
        """Forward and backward of this rank's rows of the global minibatch
        `ix`; in a process group the gradients (in .grad) and the loss terms
        are then summed over the ranks. Returns the minibatch's (policy,
        value + score, score, entropy) losses."""
        cfg, mesh = self.cfg, self.mesh
        B = ix.shape[0]
        lo = mesh.rank * B // mesh.world_size
        hi = (mesh.rank + 1) * B // mesh.world_size
        w = data.get("weights")
        valid = data["value_cats"][ix] >= 0
        if w is not None:
            valid = valid & (w[ix] > 0)
        counts = MinibatchCounts(
            share=(hi - lo) / B, n_valid=valid.sum(),
            weight_sum=None if w is None else torch.clamp(w[ix].sum(), min=1.0))
        mb = {k: v[ix[lo:hi]] for k, v in data.items()}
        sync = contextlib.nullcontext()
        if mesh.group is not None:
            sync = synced_batch_stats(self.model, functools.partial(all_reduce_sum, mesh=mesh),
                                      counts.share)
        with sync:
            out = self.model(mb["obs"])
        b = mb["obs"].shape[0]
        logp_all = masked_log_softmax(out.policy_logits.reshape(b, -1), mb["legal_masks"])
        new_logp = torch.gather(logp_all, 1, mb["actions"][:, None])[:, 0]

        ratio = torch.exp(new_logp - mb["old_log_probs"])
        adv = mb["advantages"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_epsilon, 1 + cfg.clip_epsilon) * adv
        probs = torch.exp(logp_all)
        safe_logp = torch.where(mb["legal_masks"], logp_all, 0.0)
        w = mb.get("weights")
        if w is None:
            policy_loss = -torch.minimum(surr1, surr2).mean() * counts.share
            entropy = (-(probs * safe_logp).sum(dim=-1)).mean() * counts.share
        else:
            policy_loss = -(torch.minimum(surr1, surr2) * w).sum() / counts.weight_sum
            entropy = ((-(probs * safe_logp).sum(dim=-1)) * w).sum() / counts.weight_sum

        value_score_loss, score_loss = self.adapter.value_loss(
            out, returns=mb["returns"], value_cats=mb["value_cats"],
            score_targets=mb["score_targets"], sample_weight=w, counts=counts)
        loss = cfg.lambda_policy * policy_loss + value_score_loss - entropy_coeff * entropy
        loss.backward()
        losses = torch.stack([policy_loss.detach(), value_score_loss.detach(),
                              score_loss.detach(), entropy.detach()])
        if self.bucket is not None:
            losses = self.bucket.all_reduce(losses)
        return losses

    def __call__(self, traj: Trajectory, next_value: torch.Tensor,
                 generator: torch.Generator | None, entropy_coeff: float,
                 perms: list[torch.Tensor] | None = None) -> dict[str, float]:
        cfg = self.cfg
        data = self.prepare(traj, next_value)
        S = data["advantages"].shape[0]
        n_mb = S // cfg.batch_size
        dev = data["advantages"].device
        self.model.train()
        rows = []
        for epoch in range(cfg.epochs_per_batch):
            if perms is not None:
                perm = perms[epoch].to(dev)
            else:
                perm = torch.randperm(S, generator=generator, device=dev)
            idx = perm[: n_mb * cfg.batch_size].reshape(n_mb, cfg.batch_size)
            for ix in idx:
                self.optimizer.zero_grad(set_to_none=True)
                losses = self.backward(data, ix, entropy_coeff)
                grad_norm = clip_by_global_norm_(self.params, cfg.grad_clip)
                self.optimizer.step()
                rows.append(torch.cat([losses, grad_norm.detach()[None]]))
        means = torch.stack(rows).mean(dim=0).tolist()
        return dict(zip(("policy_loss", "value_loss", "score_loss", "entropy",
                         "gradient_norm"), means))


def make_ppo_update(model: torch.nn.Module, adapter: MultiHeadValueAdapter,
                    cfg: KataGoPPOParams, optimizer: torch.optim.Optimizer,
                    mesh: Mesh | None = None) -> PPOUpdate:
    """The PPO update of `model` (see PPOUpdate); it mutates the model and
    the optimizer in place."""
    return PPOUpdate(model, adapter, cfg, optimizer, mesh)


def entropy_coeff_schedule(cfg: KataGoPPOParams, epoch: int, warmup_epochs: int = 0,
                           warmup_coeff: float | None = None) -> float:
    """Host-side entropy coefficient: warmup, then linear decay to
    lambda_entropy over entropy_decay_epochs (also with warmup_epochs=0)."""
    base = cfg.lambda_entropy
    start = warmup_coeff if warmup_coeff is not None else base
    if warmup_epochs > 0 and epoch < warmup_epochs:
        return start
    if cfg.entropy_decay_epochs > 0:
        k = epoch - warmup_epochs
        if k < cfg.entropy_decay_epochs:
            frac = k / cfg.entropy_decay_epochs
            return start + (base - start) * frac
    return base
