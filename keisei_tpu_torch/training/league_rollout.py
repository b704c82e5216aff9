"""Split-merge league rollout: the learner against K frozen opponents
(counterpart of keisei_tpu/training/league_rollout.py).

Env e plays against cohort slot e // (N/K). The learner is the trainer's
`nn.Module` (eval mode here; the update flips it to train mode); the
opponents are one parameter-free twin of it (`opponent_module`) run
through `torch.func.functional_call` on slot k of the K-stacked state
dict, never the learner's module. `lax.scan` becomes a Python loop over
plies writing into preallocated device tensors.

Two paths, as in the reference:

* **Compact (parity-locked)**, when colors may be re-rolled, K is even and
  T is even. The learner moves in envs [0, N/2) on even plies and in
  [N/2, N) on odd plies: each env's learner color is chosen at reset so
  that this holds (`parity_colors`, and the XOR re-assignment on episode
  end). Each ply runs ONE learner forward over the moving half and K/2
  opponent-block forwards over the other. Each pair of plies emits one
  (N,)-wide row of finalized learner transitions; a learner move that
  ends its episode is deferred one ply into the env's own slot (a fresh
  game's first reply never ends it). `LeagueStats.parity_mismatch`
  counts env-plies where the lock did not hold (always 0 unless a caller
  breaks the color contract). Trajectory: (T/2 + 1, N).

* **Dynamic fallback** (fixed colors, odd K or odd T): the learner forward
  over the full batch and K block forwards every ply, selected per env by
  seat. Trajectory: (T + 1, N).

Shared semantics: rewards accumulate in learner perspective; transitions
finalize where the outcome resolved; truncation bootstraps -V(terminal
obs) sign-corrected to the learner; trailing un-finalized pendings form
the last row, bootstrapped by the sign-corrected V(obs_T). The pieces of
a ply (span, learner forward and draw, engine step, truncation bootstrap,
counts, tail) are the self-play rollout's (training/rollout.py).

Data parallelism (`mesh`): rank r runs the columns of global envs
[r N/W, (r+1) N/W) on an EnvCore of N/W envs. Every rule above is read in
global indices (the opponent block of env e is e // (N/K), the compact
path's halves are global [0, N/2) and [N/2, N)), a forward whose rows all
lie on other ranks is skipped, and the ranks' trajectories concatenated in
rank order are the single process's; `LeagueStats.summed` adds up their
counts.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, replace
from typing import Callable

import torch
from torch.func import functional_call

from ..env.vec_env import EnvCore
from ..utils import tracing
from .ppo import SCORE_NORMALIZATION, compute_value_cats
from .rollout import (EagerForward, Learner, RolloutStats, empty_trajectory, engine_step, ply,
                      ply_counts, rollout_tail, truncation_bootstrap, write_row)

# sampler(ply, seat, block, masks) -> actions or None: replaces the draw of
# one forward (seat "learner" with block None, or "opponent" with block k),
# called in the reference's order: the learner, then opponent blocks in
# index order. recolor(ply) -> (N,) colors replaces the dynamic path's color
# draw, made every ply. Tests force JAX's draws through both.
Sampler = Callable[[int, str, "int | None", torch.Tensor], "torch.Tensor | None"]
Recolor = Callable[[int], torch.Tensor]


@dataclass
class PendingState:
    """Per-env learner transition awaiting its outcome. The compact path's
    deferral fields: a learner move that ends its episode still opens a
    pending (carrying the final done/terminated flags and any truncation
    bootstrap) and emits one ply later into the env's compacted slot."""

    valid: torch.Tensor       # (N,) bool
    obs: torch.Tensor         # (N, C, 81) f32
    action: torch.Tensor      # (N,) int64
    log_prob: torch.Tensor    # (N,) f32
    value: torch.Tensor       # (N,) f32
    legal_mask: torch.Tensor  # (N, A) bool
    reward: torch.Tensor      # (N,) f32 accumulated, learner perspective
    score_target: torch.Tensor  # (N,) f32
    done: torch.Tensor        # (N,) bool: episode already over (deferred emit)
    terminated: torch.Tensor  # (N,) bool: deferred terminal flag
    override: torch.Tensor    # (N,) f32: deferred truncation bootstrap (NaN none)


def init_pending(num_envs: int, obs_shape: tuple, action_space: int,
                 device: torch.device | str) -> PendingState:
    def z(*shape, dtype=torch.float32):
        return torch.zeros((num_envs,) + shape, dtype=dtype, device=device)

    return PendingState(
        valid=z(dtype=torch.bool), obs=z(*obs_shape), action=z(dtype=torch.int64),
        log_prob=z(), value=z(), legal_mask=z(action_space, dtype=torch.bool),
        reward=z(), score_target=z(), done=z(dtype=torch.bool),
        terminated=z(dtype=torch.bool),
        override=torch.full((num_envs,), float("nan"), device=device),
    )


def opponent_module(model: torch.nn.Module) -> torch.nn.Module:
    """A parameter-free twin of `model` (same class and config, built on
    the meta device, eval mode) for functional_call on opponent weights."""
    with torch.device("meta"):
        twin = type(model)(model.params_cfg)
    return twin.eval()


def parity_colors(num_envs: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Initial learner colors satisfying the parity lock: with all envs
    fresh (stm = 0) the first half plays Black, the second White."""
    return (torch.arange(num_envs, device=device) >= num_envs // 2).int()


def compact_supported(num_steps: int, k_opp: int, color_randomization: bool = True) -> bool:
    """Whether the parity-locked compact rollout applies: re-rollable
    colors (the lock IS a color assignment), an even K (K/2 opponent
    blocks per env half) and an even T (two plies per row; epoch
    boundaries must keep the parity)."""
    return bool(color_randomization) and k_opp % 2 == 0 and num_steps % 2 == 0


@dataclass
class LeagueStats:
    """RolloutStats + per-opponent outcome counts from the learner's side
    (host ints)."""

    base: RolloutStats
    opp_wins: list[int]      # (K,) learner wins vs opponent k
    opp_losses: list[int]    # (K,)
    opp_draws: list[int]     # (K,)
    parity_mismatch: int     # compact path: env-plies that broke the lock

    def summed(self, mesh) -> "LeagueStats":
        """The counts summed over the ranks of `mesh` (one all-reduce).
        Itself on one rank."""
        if mesh.group is None:
            return self
        K = len(self.opp_wins)
        flat = [*dataclasses.astuple(self.base), *self.opp_wins, *self.opp_losses,
                *self.opp_draws, self.parity_mismatch]
        t = mesh.all_reduce_(torch.tensor(flat, dtype=torch.int64, device=mesh.device))
        with tracing.span("rollout.summed", sync=2):
            return _league_stats(t[:-1].tolist(), K, int(t[-1]))


def make_league_rollout(env_core: EnvCore, model: torch.nn.Module, adapter, num_steps: int,
                        k_opp: int, color_randomization: bool = True, mesh=None):
    """rollout(opp_vars, env_states, obs, masks, learner_color, generator,
    sampler=None, recolor=None) -> ((env_states, obs, masks, learner_color),
    traj, next_value, stats).

    `opp_vars` is the K-stacked state dict (stack_cohort_variables), of
    the learner's architecture. traj is (T/2 + 1, n) on the compact path,
    (T + 1, n) on the dynamic path, for the n = env_core.num_envs envs of
    this rank of `mesh` (all N envs without one); stats count them. The
    learner's forward is EagerForward, through the same protocol as
    make_selfplay_rollout's `forward_fn`."""
    world, rank = (mesh.world_size, mesh.rank) if mesh is not None else (1, 0)
    cols = _Columns(env_core.num_envs, rank, world, env_core.device)
    if cols.N % k_opp != 0:
        raise ValueError(f"num_envs {cols.N} must divide by cohort size {k_opp}")
    forwards = functools.partial(_Forwards, EagerForward(), model,
                                 opponent_module(model), adapter, env_core.num_channels)
    if compact_supported(num_steps, k_opp, color_randomization):
        return _make_compact_rollout(env_core, forwards, num_steps, k_opp, cols)
    return _make_dynamic_rollout(env_core, forwards, num_steps, k_opp, color_randomization, cols)


class _Columns:
    """This rank's n columns among the N global envs: global index of each
    column, and the local slice of a global range (empty when it lies on
    other ranks)."""

    def __init__(self, n: int, rank: int, world: int, dev):
        self.n, self.N, self.offset = n, n * world, rank * n
        self.global_index = torch.arange(self.offset, self.offset + n, device=dev)

    def local(self, lo: int, hi: int) -> slice:
        def clamp(g):
            return min(max(g - self.offset, 0), self.n)

        return slice(clamp(lo), clamp(hi))

    def blocks(self, ks, B: int) -> list:
        """(k, local slice) of each block k in `ks` with columns on this rank."""
        out = [(k, self.local(k * B, (k + 1) * B)) for k in ks]
        return [(k, sl) for k, sl in out if sl.stop > sl.start]


class _Forwards(Learner):
    """The learner's forward (Learner) and the K opponent slots' forwards,
    with the sampler hook; opponents' values and log-probs are discarded."""

    def __init__(self, forward_fn, model, opp_model, adapter, C, opp_vars, generator, sampler):
        super().__init__(forward_fn, model, adapter, generator, C)
        self.opp_model, self.sampler = opp_model, sampler
        self.slots = [{k: v[i] for k, v in opp_vars.items()}
                      for i in range(next(iter(opp_vars.values())).shape[0])]

    def _hook(self, t, seat, k):
        return functools.partial(self.sampler, t, seat, k) if self.sampler else None

    def learner(self, t, obs, masks):
        return self.act(obs, masks, self._hook(t, "learner", None))

    def opponent(self, t, k, obs, masks):
        with tracing.span("forward.opponent", index=k):
            out = functional_call(self.opp_model, self.slots[k],
                                  (obs.reshape(-1, self.C, 9, 9),), strict=True)
        return self.sample(out, masks, self._hook(t, "opponent", k))[0]

    def value_to_learner(self, obs, stm, learner_color):
        """V(obs) from the learner's side: the model's value is the side to
        move's, so it is negated where the opponent is to move."""
        v = self.value(obs)
        return torch.where(stm == learner_color, v, -v)


def _league_stats(c: list[int], K: int, mismatch: int) -> LeagueStats:
    return LeagueStats(base=RolloutStats.of(c), opp_wins=c[7:7 + K],
                       opp_losses=c[7 + K:7 + 2 * K], opp_draws=c[7 + 2 * K:],
                       parity_mismatch=mismatch)


def _tail_row(pend: PendingState, deferred: bool) -> dict:
    """The trailing row of still-pending learner transitions. On the
    compact path, deferred-done ones are complete transitions; open ones
    are bootstrapped by next_value."""
    nan = torch.full_like(pend.reward, float("nan"))
    if deferred:
        done, term = pend.valid & pend.done, pend.valid & pend.terminated
        cats = torch.where(done, compute_value_cats(pend.reward, term), -1)
        override = torch.where(done, pend.override, nan)
    else:
        done = term = torch.zeros_like(pend.valid)
        cats, override = torch.full_like(pend.action, -1), nan
    return dict(obs=pend.obs, actions=pend.action, log_probs=pend.log_prob,
                values=pend.value, rewards=torch.where(pend.valid, pend.reward, 0.0),
                dones=done, terminated=term, legal_masks=pend.legal_mask, value_cats=cats,
                score_targets=torch.where(pend.valid, pend.score_target, 0.0),
                next_value_override=override, valid=pend.valid)


def _make_compact_rollout(env_core: EnvCore, forwards, num_steps: int, k_opp: int,
                          cols: _Columns):
    """The compact (parity-locked) path."""
    n, C, A, dev = cols.n, env_core.num_channels, env_core.action_space, env_core.device
    N = cols.N
    B = N // k_opp  # block size per opponent
    H = N // 2
    KH = k_opp // 2  # opponent blocks per env half
    T2 = num_steps // 2
    # env half: 0 for global [0, H), 1 for [H, N); the learner moves in
    # half p at plies of parity p
    b_env = (cols.global_index >= H).int()
    block = cols.global_index // B
    nan = torch.full((n,), float("nan"), device=dev)
    # per parity p: the learner half's local columns, the finalize half's,
    # and the opponent blocks (of the other half) with columns here
    learner_cols = [cols.local(p * H, (p + 1) * H) for p in (0, 1)]
    finalize_cols = [cols.local((1 - p) * H, (2 - p) * H) for p in (0, 1)]
    opp_blocks = [cols.blocks(range(KH, k_opp), B), cols.blocks(range(KH), B)]

    def sub_step(fw: _Forwards, p: int, t: int, t2: int, traj, carry):
        """One ply at static parity p: the learner half [pH, (p+1)H) moves;
        the pendings the other half opened last ply finalize into row t2."""
        env_states, obs, masks, learner_color, pend, counts, mismatch = carry
        ls, fs = learner_cols[p], finalize_cols[p]
        learner_to_move = b_env == p

        actions = torch.zeros(n, dtype=torch.int64, device=dev)
        a_l_full = torch.zeros(n, dtype=torch.int64, device=dev)
        logp_l_full = torch.zeros(n, device=dev)
        v_l_full = torch.zeros(n, device=dev)
        if ls.stop > ls.start:  # no learner forward on a rank without its envs
            a_l, logp_l, v_l = fw.learner(t, obs[ls], masks[ls])
            actions[ls] = a_l_full[ls] = a_l
            logp_l_full[ls], v_l_full[ls] = logp_l, v_l
        for kb, sl in opp_blocks[p]:
            actions[sl] = fw.opponent(t, kb, obs[sl], masks[sl])

        pre_stm = env_states.stm.int()
        mismatch = mismatch + (learner_to_move != (pre_stm == learner_color)).sum()

        env_states, eo = engine_step(env_core, env_states, actions)
        done = eo.terminated | eo.truncated
        # reward in learner perspective; the engine reports the last mover's
        r_l = torch.where(learner_to_move, eo.reward, -eo.reward)

        # 1. accumulate into open pendings (deferred-closed ones are final)
        reward = pend.reward + torch.where(pend.valid & ~pend.done, r_l, 0.0)

        # 2. finalize: with strict alternation and the lock, every pending
        # opened last ply finalizes now. A deferred pending's episode is
        # already over; this ply's done belongs to the env's new game
        fin = pend.valid
        slot_done = fin & (pend.done | done)
        slot_term = fin & (pend.terminated | (eo.terminated & ~pend.done))
        cats = torch.where(fin, compute_value_cats(reward, slot_term), -1)

        # truncation bootstrap: -V(terminal obs) to the learner; one forward
        # serves finalize-time truncations and deferred learner-move ones
        trunc = eo.truncated & ~eo.terminated
        tv_l = truncation_bootstrap(trunc & (fin | learner_to_move), lambda: fw.value_to_learner(
            eo.terminal_obs, 1 - pre_stm, learner_color))
        if tv_l is None:
            tv_l = torch.zeros(n, device=dev)
        with tracing.span("store"):
            slot_override = torch.where(pend.done, pend.override,
                                        torch.where(trunc & fin, tv_l, nan))

            # 3. the compacted row of the finalize half
            fin_f = fin[fs]
            write_row(traj, t2, fs, dict(
                obs=torch.where(fin_f[:, None, None], pend.obs[fs], obs[fs]),
                actions=torch.where(fin_f, pend.action[fs], 0),
                log_probs=torch.where(fin_f, pend.log_prob[fs], 0.0),
                values=torch.where(fin_f, pend.value[fs], 0.0),
                rewards=torch.where(fin_f, reward[fs], 0.0),
                dones=slot_done[fs], terminated=slot_term[fs],
                legal_masks=torch.where(fin_f[:, None], pend.legal_mask[fs], masks[fs]),
                value_cats=cats[fs],
                score_targets=torch.where(fin_f, pend.score_target[fs], 0.0),
                next_value_override=slot_override[fs], valid=fin_f))

            # 4. open new pendings for the learner half, even on done (deferred)
            create = learner_to_move
            score_now = eo.material.float() / SCORE_NORMALIZATION
            pend = PendingState(
                valid=create,
                obs=torch.where(create[:, None, None], obs, pend.obs),
                action=torch.where(create, a_l_full, pend.action),
                log_prob=torch.where(create, logp_l_full, pend.log_prob),
                value=torch.where(create, v_l_full, pend.value),
                legal_mask=torch.where(create[:, None], masks, pend.legal_mask),
                reward=torch.where(create, r_l, 0.0),
                score_target=torch.where(create, score_now, pend.score_target),
                done=create & done,
                terminated=create & eo.terminated,
                override=torch.where(create & trunc, tv_l, nan),
            )

            # 5. parity-locked color on episode end: the fresh game (stm = 0)
            # has the learner move iff next ply's parity is the env's half
            learner_color = torch.where(done, b_env ^ (1 - p), learner_color)
            counts = counts + ply_counts(eo, done, trunc, pre_stm, r_l, block, k_opp)
        return (env_states, eo.obs, eo.legal_mask, learner_color, pend, counts, mismatch)

    @torch.no_grad()
    @tracing.traced("rollout")
    def rollout(opp_vars: dict, env_states, obs, masks, learner_color,
                generator: torch.Generator | None, sampler: Sampler | None = None,
                recolor: Recolor | None = None):
        fw = forwards(opp_vars, generator, sampler)
        traj = empty_trajectory(T2 + 1, n, C, A, dev, valid=True)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        carry = (env_states, obs, masks, learner_color.int(),
                 init_pending(n, (C, 81), A, dev),
                 torch.zeros(7 + 3 * k_opp, dtype=torch.int64, device=dev), zero)
        for t2 in range(T2):
            # row t2: columns [H, N) finalize at parity 0, [0, H) at parity 1
            for p in (0, 1):
                with ply(2 * t2 + p):
                    carry = sub_step(fw, p, 2 * t2 + p, t2, traj, carry)
        env_states, obs, masks, learner_color, pend, counts, mismatch = carry

        # trailing row: the second half holds a pending opened at the final
        # ply; open ones are bootstrapped by V(obs_T) to the learner
        write_row(traj, T2, slice(0, n), _tail_row(pend, deferred=True))
        next_value, (c, m) = rollout_tail(lambda: fw.value_to_learner(
            obs, env_states.stm.int(), learner_color), counts, mismatch)
        return (env_states, obs, masks, learner_color), traj, next_value, \
            _league_stats(c, k_opp, m)

    return rollout


def _make_dynamic_rollout(env_core: EnvCore, forwards, num_steps: int, k_opp: int,
                          color_randomization: bool, cols: _Columns):
    """The dynamic (full-batch select) fallback path."""
    n, C, A, dev = cols.n, env_core.num_channels, env_core.action_space, env_core.device
    B = cols.N // k_opp  # block size per opponent
    block = cols.global_index // B
    opp_blocks = cols.blocks(range(k_opp), B)
    nan = torch.full((n,), float("nan"), device=dev)

    @torch.no_grad()
    @tracing.traced("rollout")
    def rollout(opp_vars: dict, env_states, obs, masks, learner_color,
                generator: torch.Generator | None, sampler: Sampler | None = None,
                recolor: Recolor | None = None):
        fw = forwards(opp_vars, generator, sampler)
        traj = empty_trajectory(num_steps + 1, n, C, A, dev, valid=True)
        learner_color = learner_color.int()
        pend = init_pending(n, (C, 81), A, dev)
        counts = torch.zeros(7 + 3 * k_opp, dtype=torch.int64, device=dev)
        for t in range(num_steps):
            with ply(t):
                pre_stm = env_states.stm.int()
                learner_to_move = pre_stm == learner_color

                a_l, logp_l, v_l = fw.learner(t, obs, masks)
                a_o = torch.zeros(n, dtype=torch.int64, device=dev)
                for k, sl in opp_blocks:
                    a_o[sl] = fw.opponent(t, k, obs[sl], masks[sl])
                actions = torch.where(learner_to_move, a_l, a_o)

                env_states, eo = engine_step(env_core, env_states, actions)
                done = eo.terminated | eo.truncated
                r_l = torch.where(learner_to_move, eo.reward, -eo.reward)
                learner_next = eo.current_player.int() == learner_color

                # 1. accumulate into prior pendings
                reward = pend.reward + torch.where(pend.valid, r_l, 0.0)
                # 2. finalize prior pendings (done or the turn returns to the
                # learner); the learner's own move that ended the episode
                # finalizes at once (no pending can be open when it moves)
                fin_prior = pend.valid & (done | learner_next)
                emit_imm = learner_to_move & done & ~pend.valid
                valid_slot = fin_prior | emit_imm

                score_target = eo.material.float() / SCORE_NORMALIZATION
                slot_reward = torch.where(fin_prior, reward, r_l)
                slot_term = valid_slot & eo.terminated
                trunc = eo.truncated & ~eo.terminated
                cut = trunc & valid_slot
                tv_l = truncation_bootstrap(cut, lambda: fw.value_to_learner(
                    eo.terminal_obs, 1 - pre_stm, learner_color))
                override = nan if tv_l is None else torch.where(cut, tv_l, nan)
                with tracing.span("store"):
                    write_row(traj, t, slice(0, n), dict(
                        obs=torch.where(fin_prior[:, None, None], pend.obs, obs),
                        actions=torch.where(fin_prior, pend.action, a_l),
                        log_probs=torch.where(fin_prior, pend.log_prob, logp_l),
                        values=torch.where(fin_prior, pend.value, v_l),
                        rewards=torch.where(valid_slot, slot_reward, 0.0),
                        dones=valid_slot & done, terminated=slot_term,
                        legal_masks=torch.where(fin_prior[:, None], pend.legal_mask, masks),
                        value_cats=torch.where(valid_slot,
                                               compute_value_cats(slot_reward, slot_term), -1),
                        score_targets=torch.where(
                            valid_slot,
                            torch.where(fin_prior, pend.score_target, score_target), 0.0),
                        next_value_override=override, valid=valid_slot))

                    # 3. open new pendings where the learner moved mid-game
                    create = learner_to_move & ~done
                    pend = replace(
                        pend,
                        valid=(pend.valid & ~fin_prior) | create,
                        obs=torch.where(create[:, None, None], obs, pend.obs),
                        action=torch.where(create, a_l, pend.action),
                        log_prob=torch.where(create, logp_l, pend.log_prob),
                        value=torch.where(create, v_l, pend.value),
                        legal_mask=torch.where(create[:, None], masks, pend.legal_mask),
                        reward=torch.where(create, r_l, torch.where(fin_prior, 0.0, reward)),
                        score_target=torch.where(create, score_target, pend.score_target),
                    )
                    if color_randomization:  # re-roll the learner's color on episode end
                        new_color = (recolor(t) if recolor is not None else
                                     torch.rand(n, generator=generator, device=dev) < 0.5)
                        learner_color = torch.where(done, new_color.to(dev).int(), learner_color)
                    counts += ply_counts(eo, done, trunc, pre_stm, r_l, block, k_opp)
                obs, masks = eo.obs, eo.legal_mask

        write_row(traj, num_steps, slice(0, n), _tail_row(pend, deferred=False))
        next_value, (c,) = rollout_tail(lambda: fw.value_to_learner(
            obs, env_states.stm.int(), learner_color), counts)
        return (env_states, obs, masks, learner_color), traj, next_value, \
            _league_stats(c, k_opp, 0)

    return rollout

