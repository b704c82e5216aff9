"""Online PPO for Dynamic league entries from tournament rollouts
(counterpart of keisei_tpu/league/dynamic_trainer.py).

Per-entry rollout buffers on the host, perspective-filtered batches,
eval-mode old log-probs, reward-signed terminal-only advantages, PPO clip
plus the W/D/L cross-entropy (no entropy bonus, no score head), a scaled
learning rate, per-entry Adam moments kept in memory and persisted every
`checkpoint_flush_every` updates, and the circuit breakers (per-entry
consecutive errors, the global error window, the rate limit, the
per-round budget).

The update is eager: the reference's jitted program over a fixed window
of the newest `batch_cap` rows (zero-weight padded) becomes a loop over
`update_epochs_per_batch` permutations, each cut into `_plan_chunks`
minibatches, on a real-parameter module per architecture that the trainer
owns (never the learner's module, never the parameter-free twin that
plays matches). The optimizer is the reference's optax chain written out:
global-norm clipping without epsilon, then Adam with optax's defaults.
Observations take the reference's float16 round trip (record_rollout
buffers them through f16, _build_batch uploads them as f16); legal masks
stay bool, which the reference's bit packing gives back exactly.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque

import numpy as np
import torch
import torch.nn.functional as F

from ..training.ppo import ILLEGAL_LOGIT, clip_by_global_norm_
from .config import DynamicConfig
from .match import MatchRollout
from .store import OpponentEntry, OpponentStore

logger = logging.getLogger(__name__)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _plan_chunks(cap: int, step_batch: int) -> tuple[int, int]:
    """Minibatch plan for a padded batch of `cap` rows: the number of scan
    steps and rows per step, with EVERY step <= step_batch rows.

    ceil-div, not exact-div: a cap that is not a multiple of step_batch must
    never collapse to one full-batch step — that reintroduces the flagship
    OOM this chunking exists to prevent (review r2). When chunks does not
    divide cap, a pass trains on the first chunks*chunk entries of the
    per-epoch permutation, dropping < chunks random rows of a
    weight-padded batch."""
    chunks = max(1, -(-cap // step_batch))
    return chunks, cap // chunks


def adam_init(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """optax.adam's state for a module's parameters as one flat dict of
    tensors (the form store.save_optimizer writes): the step count and the
    first and second moments, zero."""
    state = {"count": torch.zeros((), dtype=torch.int64)}
    for name, p in module.named_parameters():
        state[f"mu.{name}"] = torch.zeros_like(p, dtype=torch.float32, device="cpu")
        state[f"nu.{name}"] = torch.zeros_like(p, dtype=torch.float32, device="cpu")
    return state


def _to(tree: dict, device) -> dict:
    return {k: v.to(device) for k, v in tree.items()}


def _make_update_fn(model, cfg: DynamicConfig, lr: float, clip_epsilon: float = 0.2,
                    contract: str = "katago", step_batch: int = 1024):
    """update(variables, opt_state, batch, generator=None, perms=None) ->
    (new state dict, opt_state, metrics).

    `model` is a real-parameter module; each call loads `variables` (a
    float32 state dict) into it, trains in place and returns detached
    copies. BatchNorm runs in train mode with flax's running update, so
    the statistics that come back are those the last minibatch wrote, as
    the reference's `mutable=["batch_stats"]` returns them. `perms` (one
    permutation of the batch rows per epoch) replaces the generator's."""
    if contract != "katago":
        raise NotImplementedError(
            "scalar-contract models are not ported; the Dynamic update needs a "
            "katago-contract model (W/D/L value head)")
    named = list(model.named_parameters())

    def logp_of(out, masks, actions):
        flat = out.policy_logits.reshape(masks.shape[0], -1).float()
        logp = F.log_softmax(torch.where(masks, flat, ILLEGAL_LOGIT), dim=-1)
        return torch.gather(logp, 1, actions[:, None])[:, 0]

    def losses(mb, old_lp):
        out = model(mb["obs"])
        new_lp = logp_of(out, mb["masks"], mb["actions"])
        w = mb["weights"]
        w_sum = torch.clamp(w.sum(), min=1.0)
        # reward-signed terminal-only advantage
        adv = mb["rewards"] * mb["dones"].float()
        ratio = torch.exp(new_lp - old_lp)
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip_epsilon, 1 + clip_epsilon) * adv)
        policy_loss = -(surr * w).sum() / w_sum
        vlogp = F.log_softmax(out.value_logits.float(), dim=-1)
        cats = mb["value_cats"]
        cat_valid = (cats >= 0) & (w > 0)
        ce = -torch.gather(vlogp, 1, torch.clamp(cats, min=0)[:, None])[:, 0]
        n_cat = torch.clamp(cat_valid.sum(), min=1)
        value_loss = torch.where(cat_valid, ce, 0.0).sum() / n_cat
        return policy_loss, value_loss

    @torch.no_grad()
    def adam_step(opt_state):
        count = opt_state["count"] + 1
        opt_state["count"] = count
        c1 = 1 - ADAM_B1 ** count.float()
        c2 = 1 - ADAM_B2 ** count.float()
        for name, p in named:
            # a parameter no loss reaches (the score head) has a zero
            # gradient, as JAX's grad gives it
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = opt_state[f"mu.{name}"], opt_state[f"nu.{name}"]
            mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * (g * g))
            p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)))

    def update(variables, opt_state, batch, generator=None, perms=None):
        model.load_state_dict(variables)
        dev = batch["obs"].device
        # a copy: a failed update leaves the kept moments as they were
        opt_state = {k: v.to(dev, copy=True) for k, v in opt_state.items()}
        batch = {**batch, "obs": batch["obs"].float()}  # the f16 upload widened
        model.eval()
        with torch.no_grad():
            old_lp = logp_of(model(batch["obs"]), batch["masks"], batch["actions"])
        model.train()
        cap = batch["obs"].shape[0]
        chunks, chunk = _plan_chunks(cap, step_batch)
        params = [p for _, p in named]
        epoch_means = []
        for epoch in range(cfg.update_epochs_per_batch):
            if perms is not None:
                perm = perms[epoch].to(dev)
            else:
                perm = torch.randperm(cap, generator=generator).to(dev)
            rows = []
            for ix in perm[: chunks * chunk].reshape(chunks, chunk):
                mb = {k: v[ix] for k, v in batch.items()}
                for p in params:
                    p.grad = None
                policy_loss, value_loss = losses(mb, old_lp[ix])
                (policy_loss + value_loss).backward()
                clip_by_global_norm_(params, cfg.grad_clip)
                adam_step(opt_state)
                rows.append(torch.stack([policy_loss.detach(), value_loss.detach()]))
            epoch_means.append(torch.stack(rows).mean(dim=0))
        for p in params:
            p.grad = None
        model.eval()
        pl, vl = torch.stack(epoch_means).mean(dim=0).tolist()
        new_vars = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return new_vars, opt_state, {"policy_loss": pl, "value_loss": vl}

    return update


class DynamicTrainer:
    """Rate-limited, fault-isolated online trainer for Dynamic entries."""

    def __init__(
        self,
        store: OpponentStore,
        model,
        config: DynamicConfig,
        learner_lr: float = 2e-4,
        batch_cap: int = 4096,
        contract: str = "katago",
        step_batch: int = 1024,
        device: torch.device | str | None = None,
    ):
        self.store = store
        self.model = model
        self.contract = contract
        self.config = config
        self.learner_lr = learner_lr
        self.batch_cap = batch_cap
        self.step_batch = min(step_batch, batch_cap)
        # where updates run and moments live while hot (the store's device
        # unless a tournament pins its own)
        self.device = torch.device(device) if device is not None else store.device
        self._modules: dict[str, torch.nn.Module] = {}  # arch key -> trainable module
        self._update_fns: dict[str, object] = {}
        self.architecture: str | None = None  # set to gate entries by arch
        self._buffers: dict[int, deque] = {}
        self._opt_states: dict[int, object] = {}  # in-memory Adam continuity
        # entries whose moments are on the device right now (insertion =
        # LRU order); offload_optimizer demotes past optimizer_device_cache
        # to host memory
        self._opt_on_device: OrderedDict[int, None] = OrderedDict()
        self._match_counts: dict[int, int] = {}
        self._error_counts: dict[int, int] = {}
        self._disabled: set[int] = set()
        self._updates_since_flush: dict[int, int] = {}
        self._updates_this_round = 0
        self._recent_update_times: deque[float] = deque(maxlen=64)
        self._recent_errors: deque[float] = deque(maxlen=64)
        self._globally_disabled_until = 0.0
        # per-epoch permutations for the next update in place of the seed's
        # (tests hand over JAX's); consumed by that update
        self.next_perms: list[torch.Tensor] | None = None
        self.last_metrics: dict[str, float] | None = None

    # -- data intake -------------------------------------------------------

    def record_rollout(self, entry_id: int, rollout: MatchRollout, side: str) -> None:
        """Compact to the entry's own transitions and buffer on the HOST.

        The entry's mover-seat rows are selected on the device, the newest
        `cap` of them per match (the update window holds `batch_cap` rows
        of `max_buffer_depth` matches), and fetched once as numpy, obs
        through float16 as the reference fetches them.

        Terminal outcomes are mirrored onto the loser's last row before the
        mover filter: rewards sit on the last mover's row, so an entry that
        gets checkmated would otherwise keep no done=True row at all. Shogi
        strictly alternates movers, so the opponent's final move of a game
        ending at step t is row t-1: it gets done=True and the negated
        reward (negamax; both sides of a draw keep 0).
        """
        self._match_counts[entry_id] = self._match_counts.get(entry_id, 0) + 1
        if rollout.obs is None or rollout.legal_masks is None:
            return  # "light" collection carries nothing trainable
        color = rollout.a_color if side == "a" else 1 - rollout.a_color
        idx = torch.nonzero((rollout.mover_color == color[None, :]).reshape(-1))[:, 0]
        if idx.numel() == 0:
            return
        # per-match cap: _build_batch keeps the newest batch_cap rows of the
        # whole buffer, so rows past batch_cap / depth per match never train
        cap = max(min(256, self.batch_cap),
                  self.batch_cap // max(1, self.config.max_buffer_depth))
        sel = idx[-cap:]
        T, N = rollout.actions.shape
        rewards, dones = rollout.rewards, rollout.dones
        if T > 1:
            # a done at t whose predecessor row belongs to the same game
            # (not itself terminal) and to the other mover is mirrored onto
            # that predecessor; auto-reset boundaries (done at t-1) and
            # same-mover rows (first move of a fresh game) are excluded
            mirror = (dones[1:] & ~dones[:-1]
                      & (rollout.mover_color[1:] != rollout.mover_color[:-1]))
            rewards = torch.cat([torch.where(mirror, -rewards[1:], rewards[:-1]),
                                 rewards[-1:]])
            dones = torch.cat([dones[:-1] | mirror, dones[-1:]])

        def gather(a):
            return a.reshape(T * N, *a.shape[2:])[sel]

        compact = {
            "obs": gather(rollout.obs).to(torch.float16),
            "actions": gather(rollout.actions),
            "masks": gather(rollout.legal_masks),
            "rewards": gather(rewards),
            "dones": gather(dones),
        }
        compact = {k: v.cpu().numpy() for k, v in compact.items()}
        compact["obs"] = compact["obs"].astype(np.float32)
        buf = self._buffers.setdefault(
            entry_id, deque(maxlen=self.config.max_buffer_depth)
        )
        buf.append(compact)

    def disabled_entries(self) -> set[int]:
        return set(self._disabled)

    # -- cache lifecycle -------------------------------------------------------

    def drop_entry(self, entry_id: int) -> None:
        """Free all cached per-entry state.

        _opt_states holds device-resident Adam moments and _buffers host
        rollout batches; without eviction both grow unboundedly as dynamic
        entries cycle over long league runs."""
        self._buffers.pop(entry_id, None)
        self._opt_states.pop(entry_id, None)
        self._opt_on_device.pop(entry_id, None)
        self._match_counts.pop(entry_id, None)
        self._error_counts.pop(entry_id, None)
        self._updates_since_flush.pop(entry_id, None)
        self._disabled.discard(entry_id)

    def retain_only(self, active_ids) -> None:
        """Evict caches for entries no longer in the dynamic tier.

        Called as a reconciliation sweep after tier reviews: retirement and
        eviction happen from several paths (overflow review, hard caps,
        frontier promotion), so sweeping against the live role listing is
        more robust than hooking each one."""
        active = set(active_ids)
        cached = (
            set(self._buffers) | set(self._opt_states) | set(self._match_counts)
            | set(self._error_counts) | set(self._updates_since_flush)
        )
        for eid in cached - active:
            self.drop_entry(eid)

    # -- gating --------------------------------------------------------------

    def _rate_limited(self) -> bool:
        now = time.monotonic()
        recent = [t for t in self._recent_update_times if now - t < 60.0]
        return len(recent) >= self.config.max_updates_per_minute

    def _globally_disabled(self) -> bool:
        now = time.monotonic()
        if now < self._globally_disabled_until:
            return True
        window = self.config.global_error_window_seconds
        errors = [t for t in self._recent_errors if now - t < window]
        if len(errors) >= self.config.global_error_threshold:
            self._globally_disabled_until = now + window
            logger.error(
                "dynamic training globally disabled for %.0fs (%d errors)",
                window, len(errors),
            )
            return True
        return False

    def begin_round(self) -> None:
        """Reset the per-round update budget (called at round start by the
        tournament / per claimed batch by the sidecar worker). The cap
        bounds the worst-case round duration the overlapped training epoch
        must absorb — the per-minute rate limit alone lets a backlogged
        round monopolize the device."""
        self._updates_this_round = 0

    def should_update(self, entry_id: int) -> bool:
        if not self.config.training_enabled:
            return False
        if entry_id in self._disabled or self._globally_disabled():
            return False
        if self._updates_this_round >= self.config.max_updates_per_round:
            return False
        if self._rate_limited():
            return False
        count = self._match_counts.get(entry_id, 0)
        return count > 0 and count % self.config.update_every_matches == 0

    # -- update -----------------------------------------------------------------

    def _park_opt_state(self, entry_id: int, opt_state) -> None:
        """Keep the freshly-updated moments on the device in a bounded LRU;
        demote the coldest past `optimizer_device_cache` to host memory
        (all of them with a cache of 0; none without offload_optimizer)."""
        if not self.config.offload_optimizer:
            self._opt_states[entry_id] = opt_state
            return
        cache = self.config.optimizer_device_cache
        if cache <= 0:
            self._opt_states[entry_id] = _to(opt_state, "cpu")
            return
        self._opt_states[entry_id] = opt_state
        self._opt_on_device[entry_id] = None
        self._opt_on_device.move_to_end(entry_id)
        while len(self._opt_on_device) > cache:
            victim, _ = self._opt_on_device.popitem(last=False)
            if victim in self._opt_states:
                self._opt_states[victim] = _to(self._opt_states[victim], "cpu")

    def _build_batch(self, entry_id: int) -> dict | None:
        """Flatten buffered rollouts into one fixed-size weighted batch on
        the trainer's device.

        A transition belongs to the entry when its mover seat matches the
        entry's color in that match; rewards flip to the entry's perspective
        implicitly (mover == entry, so last-mover rewards ARE entry-persp).
        """
        buf = self._buffers.get(entry_id)
        if not buf:
            return None
        cat = {k: np.concatenate([c[k] for c in buf]) for k in buf[0]}
        S = cat["obs"].shape[0]
        cap = self.batch_cap
        weights = np.ones(S, np.float32)
        if S > cap:  # most recent transitions win
            cat = {k: v[-cap:] for k, v in cat.items()}
            weights = weights[-cap:]
        elif S < cap:
            pad = cap - S
            cat = {
                k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
                for k, v in cat.items()
            }
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        # obs upload as f16 (the reference's transfer compression), widened
        # by the update
        cat["obs"] = cat["obs"].astype(np.float16)
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in cat.items()}
        batch["actions"] = batch["actions"].long()
        batch["weights"] = torch.from_numpy(weights).to(self.device)
        # WDL cats from terminal rewards (truncation -> draw, by design)
        r = batch["rewards"]
        cats = torch.where(r > 0, 0, torch.where(r < 0, 2, 1))
        batch["value_cats"] = torch.where(batch["dones"], cats, -1).long()
        batch["obs"] = batch["obs"].reshape(cap, -1, 9, 9)
        return batch

    def maybe_update(self, entry: OpponentEntry, seed: int = 0) -> bool:
        """Run one training update if gates allow. Returns True on success."""
        if not self.should_update(entry.id):
            return False
        if self.architecture is not None and entry.architecture != self.architecture:
            logger.info(
                "dynamic entry %d arch %s != trainer arch %s — skipping",
                entry.id, entry.architecture, self.architecture,
            )
            return False
        try:
            return self._update_inner(entry, seed)
        except Exception:
            logger.exception("dynamic update failed for entry %d", entry.id)
            self._recent_errors.append(time.monotonic())
            n = self._error_counts.get(entry.id, 0) + 1
            self._error_counts[entry.id] = n
            if self.config.disable_on_error and n >= self.config.max_consecutive_errors:
                self._disabled.add(entry.id)
                self.store.set_training_enabled(entry.id, False)
                logger.error("dynamic entry %d disabled after %d errors", entry.id, n)
            return False

    def _update_fn_for(self, entry: OpponentEntry):
        """(trainable module, update fn) of the entry's architecture and
        shape, built once on the trainer's device."""
        from ..models.registry import build_model

        key = f"{entry.architecture}:{sorted(entry.model_params.items())}"
        if key not in self._update_fns:
            module = build_model(entry.architecture, entry.model_params)[0].to(self.device)
            self._modules[key] = module
            self._update_fns[key] = _make_update_fn(
                module, self.config, self.learner_lr * self.config.lr_scale,
                contract=self.contract, step_batch=self.step_batch)
        return self._modules[key], self._update_fns[key]

    def _update_inner(self, entry: OpponentEntry, seed: int) -> bool:
        perms, self.next_perms = self.next_perms, None
        batch = self._build_batch(entry.id)
        if batch is None or float(batch["weights"].sum()) == 0.0:
            return False
        # bf16 snapshots (storage.snapshot_dtype) train in f32: the
        # entry's own generations are written f32 after its first update
        variables = {k: (v.float() if v.dtype == torch.bfloat16 else v).to(self.device)
                     for k, v in self.store.load_variables_cached(entry).items()}
        module, update = self._update_fn_for(entry)
        # Adam moments live in memory between updates (disk flushes happen
        # every checkpoint_flush_every for restart continuity)
        opt_state = self._opt_states.get(entry.id)
        if opt_state is None:
            opt_state = self.store.load_optimizer(entry) or adam_init(module)
        generator = torch.Generator().manual_seed(seed)
        new_vars, opt_state, metrics = update(variables, opt_state, batch, generator, perms)
        pl = metrics["policy_loss"]
        if not np.isfinite(pl):
            raise RuntimeError(f"non-finite dynamic policy loss: {pl}")

        # update_weights can raise (a prior async flush failed): it comes
        # BEFORE the moments are kept, or a discarded weight update would
        # leave the moments one step ahead of the entry's weights
        n_upd = self._updates_since_flush.get(entry.id, 0) + 1
        flush = ("async" if n_upd % self.config.weight_flush_every == 0
                 else "defer")
        self.store.update_weights(entry.id, new_vars, flush=flush)
        self._park_opt_state(entry.id, opt_state)
        self._updates_since_flush[entry.id] = (
            self._updates_since_flush.get(entry.id, 0) + 1
        )
        if self._updates_since_flush[entry.id] % self.config.checkpoint_flush_every == 0:
            self.store.save_optimizer(entry.id, opt_state)
        self._recent_update_times.append(time.monotonic())
        self._updates_this_round += 1
        self._error_counts[entry.id] = 0
        self.last_metrics = metrics
        logger.info(
            "dynamic update: entry %d policy_loss=%.4f value_loss=%.4f",
            entry.id, pl, metrics["value_loss"],
        )
        return True
