"""Self-play rollout: T env steps + policy inference per epoch (counterpart
of keisei_tpu/training/rollout.py:make_selfplay_rollout).

`lax.scan` becomes a Python loop writing into preallocated (T, N, ...)
device tensors. Each transition is stored from its mover's perspective;
rewards come from the engine in last-mover perspective, and bootstrap
overrides handle truncation (-V(terminal_obs)) and ply alternation
(-values[t+1]).

The pieces of a ply below are also the league rollouts' (league_rollout.py),
so each span and counter of a ply has one call site. The truncation bootstrap
is a real branch: the extra forward runs only on the plies where some env
truncated (a host-side check of one flag per ply).

Envs are independent, so a data-parallel rank runs this rollout on its own
N/W envs with its own generator; the trainer sums the ranks' counts
(`RolloutStats.summed`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from ..env.vec_env import EnvCore
from ..utils import tracing
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

    @classmethod
    def of(cls, counts: list[int]) -> "RolloutStats":
        """The stats of a ply_counts sum read to the host (its first seven)."""
        return cls(*counts[:7])

    def summed(self, mesh) -> "RolloutStats":
        """The counts summed over the ranks of `mesh` (one all-reduce):
        the epoch's counts over the global env batch. Itself on one rank."""
        if mesh.group is None:
            return self
        t = torch.tensor(dataclasses.astuple(self), dtype=torch.int64, device=mesh.device)
        with tracing.span("rollout.summed", sync=1):
            return RolloutStats(*mesh.all_reduce_(t).tolist())


# sampler(step, legal_masks) -> actions: replaces sampling (tests force actions)
Sampler = Callable[[int, torch.Tensor], torch.Tensor]


def empty_trajectory(rows: int, n: int, C: int, A: int, dev, valid: bool = False) -> Trajectory:
    """(rows, n, ...) storage, next_value_override NaN; `valid` for the league."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty((rows, n) + shape, dtype=dtype, device=dev)

    return Trajectory(
        obs=empty(C, 81), actions=empty(dtype=torch.int64), log_probs=empty(),
        values=empty(), rewards=empty(), dones=empty(dtype=torch.bool),
        terminated=empty(dtype=torch.bool), legal_masks=empty(A, dtype=torch.bool),
        value_cats=empty(dtype=torch.int64), score_targets=empty(),
        next_value_override=torch.full((rows, n), float("nan"), device=dev),
        valid=empty(dtype=torch.bool) if valid else None)


def write_row(traj: Trajectory, t: int, cols: slice, row: dict) -> None:
    for name, value in row.items():
        getattr(traj, name)[t, cols] = value


@contextlib.contextmanager
def ply(t: int):
    with tracing.span("ply", index=t):
        tracing.count("plies")
        yield


class Learner:
    """The learner's forward in the `prepare(model)` / `fwd(weights, obs)`
    protocol, prepared once per rollout call, and the draw of a move."""

    def __init__(self, forward_fn, model, adapter, generator, num_channels: int):
        self.fwd, self.weights = forward_fn, forward_fn.prepare(model)
        self.adapter, self.generator, self.C = adapter, generator, num_channels

    def out(self, obs):
        return self.fwd(self.weights, obs.reshape(-1, self.C, 9, 9))

    def value(self, obs):
        """V(obs) to the side to move."""
        return self.adapter.scalar_value_blended(self.out(obs))

    def act(self, obs, masks, hook=None):
        """(actions, log_probs, values) of the learner's forward over `obs`."""
        with tracing.span("forward", device=obs.device):
            out = self.out(obs)
        return self.sample(out, masks, hook)

    def sample(self, out, masks, hook=None):
        """masked_policy_sample, looked up in this module at call time;
        hook(masks), if given, forces the actions."""
        with tracing.span("sample"):
            forced = hook(masks) if hook is not None else None
            return masked_policy_sample(out, masks, self.adapter, self.generator, actions=forced)


def engine_step(env_core: EnvCore, env_states, actions):
    with tracing.span("engine.step", device=env_core.device):
        return env_core.step(env_states, actions)


def truncation_bootstrap(mask: torch.Tensor, value_fn: Callable[[], torch.Tensor]):
    """value_fn() if any env of `mask` needs the bootstrap (one host read),
    else None."""
    with tracing.span("truncation.check", sync=1):
        cut = bool(mask.any())
    if not cut:
        return None
    with tracing.span("truncation.forward"):
        return value_fn()


def ply_counts(eo, done, trunc, pre_stm, r_l=None, block=None, k: int = 0) -> torch.Tensor:
    """(7 + 3k,) counts of a ply (`trunc`: cut, not terminated): RolloutStats' fields, then
    for k opponent blocks (`block`: each column's) the learner's wins, losses, draws (`r_l`)."""
    term = eo.terminated
    win_b = ((eo.reward > 0) & (pre_stm == 0)) | ((eo.reward < 0) & (pre_stm == 1))
    win_w = ((eo.reward > 0) & (pre_stm == 1)) | ((eo.reward < 0) & (pre_stm == 0))
    base = torch.stack([
        done.sum(), (win_b & term).sum(), (win_w & term).sum(), (term & (eo.reward == 0)).sum(),
        term.sum(), trunc.sum(), torch.where(done, eo.ply_count, 0).sum()])
    if not k:
        return base
    outcomes = torch.stack([term & (r_l > 0), term & (r_l < 0), term & (r_l == 0)]).long()
    per_block = torch.zeros(3, k, dtype=torch.int64, device=outcomes.device)
    per_block.index_add_(1, block, outcomes)
    return torch.cat([base, per_block.reshape(-1)])


def rollout_tail(value_fn: Callable[[], torch.Tensor], *counts: torch.Tensor):
    """(value_fn() after the last ply, each of `counts` read to the host)."""
    with tracing.span("forward.last"):
        next_value = value_fn()
    with tracing.span("rollout.stats", sync=len(counts)):
        return next_value, [c.tolist() for c in counts]


def make_selfplay_rollout(env_core: EnvCore, model: torch.nn.Module, adapter, num_steps: int,
                          forward_fn=None):
    """rollout(env_states, obs, masks, generator, sampler=None) ->
    ((env_states, obs, masks), traj, next_value, stats)."""
    fwd = forward_fn or EagerForward()
    N, C, A, T = env_core.num_envs, env_core.num_channels, env_core.action_space, num_steps
    dev = env_core.device

    @torch.no_grad()
    @tracing.traced("rollout")
    def rollout(env_states, obs, masks, generator: torch.Generator | None,
                sampler: Sampler | None = None):
        learner = Learner(fwd, model, adapter, generator, C)
        traj = empty_trajectory(T, N, C, A, dev)
        counts = torch.zeros(7, dtype=torch.int64, device=dev)
        for t in range(T):
            with ply(t):
                actions, log_probs, values = learner.act(
                    obs, masks, functools.partial(sampler, t) if sampler is not None else None)
                last_mover = env_states.stm.long()
                env_states, eo = engine_step(env_core, env_states, actions)
                dones = eo.terminated | eo.truncated

                trunc_only = eo.truncated & ~eo.terminated
                tv = truncation_bootstrap(trunc_only, lambda: torch.where(
                    trunc_only, -learner.value(eo.terminal_obs), float("nan")))
                if tv is not None:
                    traj.next_value_override[t] = tv

                with tracing.span("store"):
                    write_row(traj, t, slice(None), dict(
                        obs=obs, actions=actions, log_probs=log_probs, values=values,
                        rewards=eo.reward, dones=dones, terminated=eo.terminated,
                        legal_masks=masks, value_cats=compute_value_cats(eo.reward, eo.terminated),
                        score_targets=eo.material.float() / SCORE_NORMALIZATION))
                    counts += ply_counts(eo, dones, trunc_only, last_mover)
                obs, masks = eo.obs, eo.legal_mask

        traj.next_value_override = alternating_perspective_overrides(
            traj.values, traj.terminated, traj.next_value_override)
        next_value, (c,) = rollout_tail(lambda: -learner.value(obs), counts)
        return (env_states, obs, masks), traj, next_value, RolloutStats.of(c)

    return rollout
