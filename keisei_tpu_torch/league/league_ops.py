"""Glue between the trainer loop and the league: cohort loading, results
(counterpart of keisei_tpu/league/league_ops.py).

Kept apart from the rollout (training/league_rollout.py) so the host-side
store/DB machinery stays out of the per-ply code.
"""

from __future__ import annotations

import logging

import torch

from .store import OpponentEntry, OpponentStore, _cast_tree

logger = logging.getLogger(__name__)


def stack_cohort_variables(
    store: OpponentStore, cohort: list[OpponentEntry], template: dict,
    dtype=None,
) -> dict:
    """Each cohort entry's state dict (LRU-cached, on the store's device)
    stacked along K: one (K, ...) tensor per key of `template`.

    dtype=torch.bfloat16 halves the stacked tree's device footprint. It is
    action-identical for league opponents: the rollout discards opponent
    value/score outputs, and the policy path computes in bf16 anyway. A
    key an entry lacks is taken from `template` (the learner's state
    dict), cast the same way."""
    loaded = [store.load_variables_cached(e, template=template, dtype=dtype)
              for e in cohort]

    def leaf(sd: dict, k: str) -> torch.Tensor:
        if k in sd:
            return sd[k]
        return _cast_tree({k: template[k]}, dtype)[k] if dtype is not None else template[k]

    return {k: torch.stack([leaf(sd, k).to(store.device) for sd in loaded]) for k in template}


def stacked_cohort_template(template: dict, k: int, dtype=None) -> dict:
    """Zero tree with the exact keys/shapes/dtypes stack_cohort_variables
    produces for a K-cohort of `template`-shaped entries: float tensors
    in `dtype`, everything else unchanged."""
    cast = _cast_tree(template, dtype) if dtype is not None else template
    return {name: torch.zeros((k,) + v.shape, dtype=v.dtype, device=v.device)
            for name, v in cast.items()}


def record_epoch_results(
    store: OpponentStore,
    scheduler,
    learner_entry_id: int,
    cohort: list[OpponentEntry],
    league_stats,
    epoch: int,
    k_factor: float,
    role_elo_k: dict[str, float],
    elo_floor: float = 0.0,
) -> None:
    """Record learner-vs-cohort outcomes from one rollout epoch: Elo +
    league_results + head-to-head per distinct opponent, and the rolling
    tier win rates for challenge-threshold sampling
    (katago_loop.py:1676-1698 semantics)."""
    # cohort may contain repeats (cycled to fill K blocks) — aggregate
    agg: dict[int, list[int]] = {}
    for k, entry in enumerate(cohort):
        w = int(league_stats.opp_wins[k])
        l_ = int(league_stats.opp_losses[k])
        d = int(league_stats.opp_draws[k])
        if w + l_ + d == 0:
            continue
        bucket = agg.setdefault(entry.id, [0, 0, 0])
        bucket[0] += w
        bucket[1] += l_
        bucket[2] += d
    for opp_id, (w, l_, d) in agg.items():
        if opp_id == learner_entry_id:
            continue  # self-pairing (bootstrap cohort) carries no Elo info
        try:
            store.record_result(
                learner_entry_id, opp_id, epoch=epoch,
                wins_a=w, wins_b=l_, draws=d,
                match_type="training", k=k_factor, role_elo_k=role_elo_k,
                elo_floor=elo_floor,
            )
            opp = store.get_entry(opp_id)
            scheduler.record_learner_result(opp.role, won=w > l_)
        except Exception:
            logger.exception("epoch result recording failed for opponent %d", opp_id)
