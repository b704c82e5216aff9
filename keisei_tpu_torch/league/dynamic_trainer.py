"""The part of the Dynamic-entry online trainer that a league epoch calls
(counterpart of keisei_tpu/league/dynamic_trainer.py): the trainer's
state, its cache lifecycle (`retain_only` after every tier review) and
its gates (`should_update`, the rate limit, the global error window, the
per-round budget).

Its update path (`record_rollout`, `_build_batch`, `maybe_update`,
`_update_inner`, `_make_update_fn`) has one caller, the in-process
tournament, and is ported with it in the next slice; until then those
raise NotImplementedError.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque

from .config import DynamicConfig
from .match import MatchRollout
from .store import OpponentEntry, OpponentStore

logger = logging.getLogger(__name__)

_NEXT_SLICE = ("the Dynamic-entry update path comes with the in-process tournament "
               "(tournament.py), the next slice of the port")


def _make_update_fn(*args, **kwargs):
    raise NotImplementedError(_NEXT_SLICE)


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
    ):
        self.store = store
        self.model = model
        self.contract = contract
        self.config = config
        self.learner_lr = learner_lr
        self.batch_cap = batch_cap
        self.step_batch = min(step_batch, batch_cap)
        self.architecture: str | None = None  # set to gate entries by arch
        self._buffers: dict[int, deque] = {}
        self._opt_states: dict[int, object] = {}  # in-memory Adam continuity
        self._opt_on_device: OrderedDict[int, None] = OrderedDict()
        self._match_counts: dict[int, int] = {}
        self._error_counts: dict[int, int] = {}
        self._disabled: set[int] = set()
        self._updates_since_flush: dict[int, int] = {}
        self._num_actions: int | None = None
        self._updates_this_round = 0
        self._recent_update_times: deque[float] = deque(maxlen=64)
        self._recent_errors: deque[float] = deque(maxlen=64)
        self._globally_disabled_until = 0.0

    # -- data intake -------------------------------------------------------

    def record_rollout(self, entry_id: int, rollout: MatchRollout, side: str) -> None:
        raise NotImplementedError(_NEXT_SLICE)

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

    def _build_batch(self, entry_id: int) -> dict | None:
        raise NotImplementedError(_NEXT_SLICE)

    def maybe_update(self, entry: OpponentEntry, seed: int = 0) -> bool:
        raise NotImplementedError(_NEXT_SLICE)

    def _update_inner(self, entry: OpponentEntry, seed: int) -> bool:
        raise NotImplementedError(_NEXT_SLICE)
