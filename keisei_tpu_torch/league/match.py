"""Frozen A-vs-B matches, batched over the environment (counterpart of
keisei_tpu/league/match.py).

N games run in parallel: each ply does ONE forward per model over the
whole batch and selects per env by seat. Win attribution is vectorized
from last-mover rewards. Colors alternate across the batch (A is Black in
even envs). Each env plays exactly one counted game; the env auto-resets
afterwards and further transitions are ignored via a `done_seen` carry.
The host runs fixed-size chunks of plies and stops once every env has
finished.

The models run through `torch.func.functional_call` on the state dicts a
caller passes (the store's, on its device); the games run on the device
of A's weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import functional_call

from ..env.vec_env import EnvCore
from ..training.ppo import ILLEGAL_LOGIT


class ModelCache:
    """Arch-keyed module memoization shared by every match consumer.

    One parameter-free module (built on the meta device, in eval mode) per
    (architecture, params) combination: it serves any number of entries'
    state dicts through functional_call. A consumer keeps its own cache,
    so no module is shared between threads."""

    def __init__(self):
        self._models: dict[str, torch.nn.Module] = {}

    def model_for(self, entry) -> tuple[torch.nn.Module, str]:
        """(module, cache-key) for an OpponentEntry-like object."""
        from ..models.registry import build_model

        key = f"{entry.architecture}:{sorted(entry.model_params.items())}"
        if key not in self._models:
            with torch.device("meta"):
                module = build_model(entry.architecture, entry.model_params)[0]
            self._models[key] = module.eval()
        return self._models[key], key


@dataclass
class MatchResult:
    wins_a: int
    wins_b: int
    draws: int
    games: int
    total_plies: int

    @property
    def score_a(self) -> float:
        return (self.wins_a + 0.5 * self.draws) / max(self.games, 1)


@dataclass
class MatchRollout:
    """Device-resident transitions collected during a match, for Dynamic-entry
    online training. All tensors are (T, N, ...); `mover_color` is the seat
    that chose each action and `rewards` are last-mover perspective."""

    obs: torch.Tensor | None  # (T, N, C, 81) f32 (None in light collection)
    actions: torch.Tensor  # (T, N) int64
    legal_masks: torch.Tensor | None  # (T, N, A) bool (None in light collection)
    rewards: torch.Tensor  # (T, N) f32
    dones: torch.Tensor  # (T, N) bool
    captured: torch.Tensor  # (T, N) u8 — hand-piece index or 255
    term_reason: torch.Tensor  # (T, N) u8
    mover_color: torch.Tensor  # (T, N) int32
    a_color: torch.Tensor  # (N,) int32 — seat assignment for side attribution


def host_rollout(rollout: MatchRollout) -> MatchRollout:
    """The small (T, N) fields of a rollout as numpy arrays on the host (one
    copy each), the form features.extract_game_features reads; obs and
    legal masks are left out."""
    def host(t):
        return t.cpu().numpy()

    return MatchRollout(obs=None, actions=host(rollout.actions), legal_masks=None,
                        rewards=host(rollout.rewards), dones=host(rollout.dones),
                        captured=host(rollout.captured), term_reason=host(rollout.term_reason),
                        mover_color=host(rollout.mover_color), a_color=host(rollout.a_color))


def _make_chunk(env_core: EnvCore, model_a, model_b, chunk_steps: int, temperature: float):
    N, C = env_core.num_envs, env_core.num_channels

    def forward(model, variables, obs, masks, generator):
        out = functional_call(model, variables, (obs.reshape(N, C, 9, 9),), strict=True)
        flat = out.policy_logits.reshape(N, -1).float()
        masked = torch.where(masks, flat / temperature, ILLEGAL_LOGIT)
        u = torch.rand(masked.shape, generator=generator, device=masked.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(masked + gumbel, dim=-1)

    @torch.no_grad()
    def chunk(vars_a, vars_b, env_states, obs, masks, a_color, done_seen, result, plies,
              generator):
        ys = []
        for _ in range(chunk_steps):
            act_a = forward(model_a, vars_a, obs, masks, generator)
            act_b = forward(model_b, vars_b, obs, masks, generator)
            stm = env_states.stm.int()
            actions = torch.where(stm == a_color, act_a, act_b)

            env_states, out = env_core.step(env_states, actions)
            done = out.terminated | out.truncated
            fresh = done & ~done_seen
            # winner color from last-mover reward
            win_color = torch.where(out.reward > 0, stm,
                                    torch.where(out.reward < 0, 1 - stm, -1))
            r = torch.where(win_color < 0, 0, torch.where(win_color == a_color, 1, -1))
            result = torch.where(fresh, r, result)
            plies = torch.where(fresh, out.ply_count, plies)
            done_seen = done_seen | done
            ys.append((obs, actions, masks, out.reward, done, stm,
                       out.captured, out.term_reason))
            obs, masks = out.obs, out.legal_mask
        carry = (env_states, obs, masks, done_seen, result, plies)
        return carry, [torch.stack(parts) for parts in zip(*ys)]

    return chunk


def play_match(
    model_a,
    vars_a,
    model_b,
    vars_b,
    *,
    num_games: int = 64,
    max_ply: int = 512,
    num_channels: int = 50,
    chunk_steps: int = 64,
    temperature: float = 1.0,
    seed: int = 0,
    env_core: EnvCore | None = None,
    chunk_fn=None,
    collect: bool | str = False,
) -> MatchResult | tuple[MatchResult, MatchRollout]:
    """Play `num_games` A-vs-B games; A holds Black in even-indexed envs.

    Pass a prebuilt (env_core, chunk_fn) pair to reuse them across
    matches. With collect=True, also return the full (T, N) transition
    record for Dynamic-entry training; collect="light" keeps only the
    small per-step tensors (for feature extraction). Sampling draws from
    a generator of the match's own, seeded with `seed`.
    """
    device = next(iter(vars_a.values())).device
    core = env_core or EnvCore(num_games, max_ply, num_channels, device)
    N = core.num_envs
    chunk = chunk_fn or _make_chunk(core, model_a, model_b, chunk_steps, temperature)
    generator = torch.Generator(device=core.device)
    generator.manual_seed(seed)

    env_states, obs, masks = core.init()
    a_color = torch.arange(N, device=core.device, dtype=torch.int32) % 2
    done_seen = torch.zeros(N, dtype=torch.bool, device=core.device)
    result = torch.zeros(N, dtype=torch.int64, device=core.device)
    plies = torch.zeros(N, dtype=torch.int32, device=core.device)

    collected = []
    max_chunks = -(-max_ply // chunk_steps) + 1
    for _ in range(max_chunks):
        (env_states, obs, masks, done_seen, result, plies), ys = chunk(
            vars_a, vars_b, env_states, obs, masks, a_color, done_seen,
            result, plies, generator,
        )
        if collect == "light":
            collected.append((None, ys[1], None, *ys[3:]))
        elif collect:
            collected.append(ys)
        if bool(done_seen.all()):
            break

    done_np = done_seen.cpu().numpy()
    res_np = result.cpu().numpy()[done_np]
    match_result = MatchResult(
        wins_a=int((res_np == 1).sum()),
        wins_b=int((res_np == -1).sum()),
        draws=int((res_np == 0).sum()),
        games=int(done_np.sum()),
        total_plies=int(plies.cpu().numpy()[done_np].sum()),
    )
    if not collect:
        return match_result
    cat = [None if parts[0] is None else torch.cat(parts, dim=0)
           for parts in zip(*collected)]
    rollout = MatchRollout(
        obs=cat[0], actions=cat[1], legal_masks=cat[2], rewards=cat[3],
        dones=cat[4], mover_color=cat[5], captured=cat[6],
        term_reason=cat[7], a_color=a_color,
    )
    return match_result, rollout


def make_match_runner(
    model_a, model_b, *, num_games: int, max_ply: int = 512,
    num_channels: int = 50, chunk_steps: int = 64, temperature: float = 1.0,
):
    """Build once, then run many (vars_a, vars_b, seed) matches: the shape
    the gauntlet and the tournament need (architectures fixed per runner,
    weights swapped per pairing). The env is built at the first match, on
    the device of its weights."""
    built: dict = {}

    def run(vars_a, vars_b, seed: int = 0, collect: bool = False):
        device = next(iter(vars_a.values())).device
        if device not in built:
            core = EnvCore(num_games, max_ply, num_channels, device)
            built[device] = (core, _make_chunk(core, model_a, model_b, chunk_steps,
                                               temperature))
        core, chunk = built[device]
        return play_match(
            model_a, vars_a, model_b, vars_b,
            num_games=num_games, max_ply=max_ply, num_channels=num_channels,
            chunk_steps=chunk_steps, temperature=temperature, seed=seed,
            env_core=core, chunk_fn=chunk, collect=collect,
        )

    return run
