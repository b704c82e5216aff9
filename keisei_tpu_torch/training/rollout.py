"""Self-play rollout: T env steps + policy inference per epoch (counterpart
of keisei_tpu/training/rollout.py:make_selfplay_rollout).

`lax.scan` becomes a Python loop writing into preallocated (T, N, ...)
device tensors. Each transition is stored from its mover's perspective;
rewards come from the engine in last-mover perspective, and bootstrap
overrides handle truncation (-V(terminal_obs)) and ply alternation
(-values[t+1]).

The truncation bootstrap is a real branch: the extra forward runs only on
the plies where some env truncated (a host-side check of one flag per ply).

Envs are independent, so a data-parallel rank runs this rollout on its own
N/W envs with its own generator; the trainer sums the ranks' counts
(`RolloutStats.summed`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from ..env.vec_env import EnvCore
from .gae import alternating_perspective_overrides
from .ppo import SCORE_NORMALIZATION, Trajectory, compute_value_cats, masked_policy_sample


class EagerForward:
    """The nn.Module eval forward, in the FusedForward protocol:
    `prepare(model)` once per set of weights, then `fwd(prepared, obs)`."""

    def prepare(self, model: torch.nn.Module) -> torch.nn.Module:
        model.eval()
        return model

    @torch.no_grad()
    def __call__(self, model: torch.nn.Module, obs: torch.Tensor):
        return model(obs)


@dataclass
class RolloutStats:
    """Episode statistics of one rollout (host ints)."""

    episodes: int
    wins_black: int
    wins_white: int
    draws: int
    terminated: int
    truncated: int
    total_ply: int

    def summed(self, mesh) -> "RolloutStats":
        """The counts summed over the ranks of `mesh` (one all-reduce):
        the epoch's counts over the global env batch. Itself on one rank."""
        if mesh.group is None:
            return self
        t = torch.tensor(dataclasses.astuple(self), dtype=torch.int64, device=mesh.device)
        return RolloutStats(*mesh.all_reduce_(t).tolist())


# sampler(step, legal_masks) -> actions: replaces sampling (tests force actions)
Sampler = Callable[[int, torch.Tensor], torch.Tensor]


def make_selfplay_rollout(env_core: EnvCore, model: torch.nn.Module, adapter, num_steps: int,
                          forward_fn=None):
    """rollout(env_states, obs, masks, generator, sampler=None) ->
    ((env_states, obs, masks), traj, next_value, stats)."""
    fwd = forward_fn or EagerForward()
    N, C, T = env_core.num_envs, env_core.num_channels, num_steps
    dev = env_core.device

    @torch.no_grad()
    def rollout(env_states, obs, masks, generator: torch.Generator | None,
                sampler: Sampler | None = None):
        weights = fwd.prepare(model)
        f32 = torch.float32

        def empty(*shape, dtype=f32):
            return torch.empty((T, N) + shape, dtype=dtype, device=dev)

        traj = Trajectory(
            obs=empty(C, 81), actions=empty(dtype=torch.int64), log_probs=empty(),
            values=empty(), rewards=empty(), dones=empty(dtype=torch.bool),
            terminated=empty(dtype=torch.bool),
            legal_masks=empty(env_core.action_space, dtype=torch.bool),
            value_cats=empty(dtype=torch.int64), score_targets=empty(),
            next_value_override=torch.full((T, N), float("nan"), device=dev),
        )
        counts = torch.zeros(7, dtype=torch.int64, device=dev)
        for t in range(T):
            out = fwd(weights, obs.reshape(N, C, 9, 9))
            forced = sampler(t, masks) if sampler is not None else None
            actions, log_probs, values = masked_policy_sample(out, masks, adapter, generator,
                                                              actions=forced)
            last_mover = env_states.stm.long()
            env_states, eo = env_core.step(env_states, actions)
            dones = eo.terminated | eo.truncated

            trunc_only = eo.truncated & ~eo.terminated
            if bool(trunc_only.any()):
                tout = fwd(weights, eo.terminal_obs.reshape(N, C, 9, 9))
                tv = adapter.scalar_value_blended(tout)
                traj.next_value_override[t] = torch.where(trunc_only, -tv, float("nan"))

            traj.obs[t] = obs
            traj.actions[t] = actions
            traj.log_probs[t] = log_probs
            traj.values[t] = values
            traj.rewards[t] = eo.reward
            traj.dones[t] = dones
            traj.terminated[t] = eo.terminated
            traj.legal_masks[t] = masks
            traj.value_cats[t] = compute_value_cats(eo.reward, eo.terminated)
            traj.score_targets[t] = eo.material.float() / SCORE_NORMALIZATION

            win_b = ((eo.reward > 0) & (last_mover == 0)) | ((eo.reward < 0) & (last_mover == 1))
            win_w = ((eo.reward > 0) & (last_mover == 1)) | ((eo.reward < 0) & (last_mover == 0))
            counts += torch.stack([
                dones.sum(), (win_b & eo.terminated).sum(), (win_w & eo.terminated).sum(),
                (eo.terminated & (eo.reward == 0)).sum(), eo.terminated.sum(),
                trunc_only.sum(), torch.where(dones, eo.ply_count, 0).sum(),
            ])
            obs, masks = eo.obs, eo.legal_mask

        traj.next_value_override = alternating_perspective_overrides(
            traj.values, traj.terminated, traj.next_value_override)
        out = fwd(weights, obs.reshape(N, C, 9, 9))
        next_value = -adapter.scalar_value_blended(out)
        stats = RolloutStats(*[int(v) for v in counts.tolist()])
        return (env_states, obs, masks), traj, next_value, stats

    return rollout
