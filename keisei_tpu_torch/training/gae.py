"""Generalized Advantage Estimation (counterpart of keisei_tpu/training/gae.py).

The JAX package's deliberate deviations from the upstream reference are
kept as they are:
- `chain_cut` cuts the gamma*lambda chain at every episode end (truncations
  included), while `terminated` alone zeroes the bootstrap;
- `alternating=True` negates the carried chain every step, because
  consecutive rows alternate the mover's perspective (negamax);
- an explicit `next_value_override` survives the `terminated` zeroing.
`compute_gae_masked` is the league's GAE over a sparsely valid grid.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def compute_gae(
    rewards: torch.Tensor,      # (T, N)
    values: torch.Tensor,       # (T, N)
    terminated: torch.Tensor,   # (T, N) bool or float
    next_value: torch.Tensor,   # (N,)
    gamma: float,
    lam: float,
    next_value_override: torch.Tensor | None = None,  # (T, N), NaN = default
    chain_cut: torch.Tensor | None = None,             # (T, N); default = terminated
    alternating: bool = False,
) -> torch.Tensor:
    """(T, N) advantages by a reversed loop over T."""
    rewards = rewards.float()
    values = values.float()
    not_done = 1.0 - terminated.float()
    not_cut = not_done if chain_cut is None else 1.0 - chain_cut.float()

    next_vals = torch.cat([values[1:], next_value[None].float()], dim=0)
    boot = not_done
    if next_value_override is not None:
        ov = next_value_override.float()
        has_ov = ~torch.isnan(ov)
        next_vals = torch.where(has_ov, ov, next_vals)
        boot = torch.where(has_ov, 1.0, not_done)

    delta = rewards + gamma * next_vals * boot - values
    decay = (-1.0 if alternating else 1.0) * gamma * lam * not_cut
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(next_value, dtype=torch.float32)
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + decay[t] * carry
        adv[t] = carry
    return adv



@torch.no_grad()
def compute_gae_masked(
    rewards: torch.Tensor,      # (T, N)
    values: torch.Tensor,       # (T, N)
    dones: torch.Tensor,        # (T, N) bool: episode boundaries cut the chain
    valid: torch.Tensor,        # (T, N) bool: False slots are skipped entirely
    next_value: torch.Tensor,   # (N,)
    gamma: float,
    lam: float,
    next_value_override: torch.Tensor | None = None,  # (T, N), NaN = default
) -> torch.Tensor:
    """GAE over a sparsely valid (T, N) grid (league trajectories).

    Invalid slots pass the (advantage, next value) carries through
    unchanged and get advantage 0, so each env's valid slots chain like a
    compacted sequence. Chain and bootstrap cut at `dones`, except that an
    explicit override IS the bootstrap (truncation: -V(terminal)) and
    survives the cut."""
    rewards = rewards.float()
    values = values.float()
    not_done = 1.0 - dones.float()
    valid = valid.bool()
    ov = (torch.full_like(rewards, float("nan")) if next_value_override is None
          else next_value_override.float())
    has_ov = ~torch.isnan(ov)
    ov = torch.nan_to_num(ov)
    boot = torch.where(has_ov, 1.0, not_done)
    adv = torch.empty_like(rewards)
    gae_c = torch.zeros_like(next_value, dtype=torch.float32)
    nv_c = next_value.float()
    for t in range(rewards.shape[0] - 1, -1, -1):
        nv = torch.where(has_ov[t], ov[t], nv_c)
        delta = rewards[t] + gamma * nv * boot[t] - values[t]
        gae = delta + gamma * lam * not_done[t] * gae_c
        adv[t] = torch.where(valid[t], gae, 0.0)
        gae_c = torch.where(valid[t], gae, gae_c)
        nv_c = torch.where(valid[t], values[t], nv_c)
    return adv

@torch.no_grad()
def alternating_perspective_overrides(
    values: torch.Tensor,       # (T, N)
    terminated: torch.Tensor,   # (T, N)
    existing: torch.Tensor | None = None,
) -> torch.Tensor:
    """override[t] = -values[t+1] for every non-terminal cell without an
    existing (non-NaN) override; the last row is left to next_value."""
    ov = torch.full_like(values, float("nan")) if existing is None else existing.clone()
    fill = torch.isnan(ov[:-1]) & ~terminated[:-1].bool()
    ov[:-1] = torch.where(fill, -values[1:], ov[:-1])
    return ov
