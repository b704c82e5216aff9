"""ConcurrentMatchPool: P pairings play at once in one batched environment
(counterpart of keisei_tpu/league/concurrent.py).

`parallel_matches` slots x `envs_per_match` lanes inside one EnvCore of
N = P*E games. Every ply runs ONE forward over the 2P stacked weight sets
(a-side then b-side of each slot) on a state dict stacked once per round:
`models/se_resnet.py:stacked_policy_logits`, where each conv is one
grouped conv over the 2P weight sets, in place of 2P launch-bound eager
forwards (`torch.func.vmap` of `functional_call` is refused: autocast
does not cast under vmap). One env step then advances every game of every
pairing, and a round costs the longest game's plies, not the sum over
pairings.

The rest follows the reference: `chunk_steps` plies per host call, the
early exit read from the `done_seen` flag of LAG chunks back (the read
overlaps the device work queued after it), short rounds padded with the
last pairing (the pad's results are dropped), and with `collect=True` /
`"light"` per-pairing MatchRollout slices of the shared (T, N) trajectory.

All pairings in a pool share one architecture; heterogeneous pairings are
played one at a time by LeagueTournament. Actions are Gumbel draws from
one torch.Generator seeded with the round's seed; `sampler(step, masks)`
may return the (N,) actions of a ply instead (tests replay JAX's draws).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..env.vec_env import EnvCore
from ..models.se_resnet import stacked_policy_logits
from ..training.ppo import ILLEGAL_LOGIT
from ..utils.device import resolve_device
from .match import MatchResult, MatchRollout


@dataclass
class RoundStats:
    pairings: int
    games: int
    total_plies: int
    steps: int


def stack_pairings(pairings) -> dict[str, torch.Tensor]:
    """One (2P, ...) state dict from P (vars_a, vars_b) pairs: the a-sides
    in slot order, then the b-sides."""
    trees = [a for a, _ in pairings] + [b for _, b in pairings]
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


class ConcurrentMatchPool:
    # run_round calls of every pool in the process (chip_smoke.py reads it
    # to show that a tournament round went through the pool)
    rounds_run = 0

    def __init__(
        self,
        model,
        parallel_matches: int = 4,
        envs_per_match: int = 16,
        max_ply: int = 512,
        num_channels: int = 50,
        chunk_steps: int = 128,
        temperature: float = 1.0,
        device: torch.device | str = "cuda",
    ):
        self.model = model
        self.P = parallel_matches
        self.E = envs_per_match
        self.N = self.P * self.E
        self.max_ply = max_ply
        self.chunk_steps = chunk_steps
        self.temperature = temperature
        self.device = resolve_device(device)
        self.core = EnvCore(self.N, max_ply, num_channels, self.device)

    def stacked_forward(self, stacked, obs, masks):
        """(stacked (2P, ...) state dict, obs (2P, E, C, 81), masks (2P, E, A))
        -> legal-masked, temperature-scaled logits (2P, E, A) in f32."""
        logits = stacked_policy_logits(self.model.params_cfg, stacked, obs)
        return torch.where(masks, logits / self.temperature, ILLEGAL_LOGIT)

    @torch.no_grad()
    def _chunk(self, stacked, carry, a_color, generator, sampler, step0, mode):
        env_states, obs, masks, done_seen, result, plies = carry
        P, E, N = self.P, self.E, self.N
        ys = []
        for i in range(self.chunk_steps):
            obs_p = obs.reshape(P, E, *obs.shape[1:])
            masks_p = masks.reshape(P, E, -1)
            logits = self.stacked_forward(stacked, torch.cat([obs_p, obs_p]),
                                          torch.cat([masks_p, masks_p]))
            stm = env_states.stm.int()
            forced = sampler(step0 + i, masks) if sampler is not None else None
            if forced is None:
                u = torch.rand(logits.shape, generator=generator, device=logits.device)
                gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
                acts = torch.argmax(logits + gumbel, dim=-1)
                actions = torch.where(stm == a_color, acts[:P].reshape(N), acts[P:].reshape(N))
            else:
                actions = forced.to(device=obs.device, dtype=torch.int64)

            env_states, out = self.core.step(env_states, actions)
            done = out.terminated | out.truncated
            fresh = done & ~done_seen
            win_color = torch.where(out.reward > 0, stm,
                                    torch.where(out.reward < 0, 1 - stm, -1))
            r = torch.where(win_color < 0, 0, torch.where(win_color == a_color, 1, -1))
            result = torch.where(fresh, r, result)
            plies = torch.where(fresh, out.ply_count, plies)
            done_seen = done_seen | done
            # the layout of match._make_chunk's ys, so that slot slices
            # rebuild the sequential runner's MatchRollout
            if mode == "full":
                ys.append((obs, actions, masks, out.reward, done, stm,
                           out.captured, out.term_reason))
            elif mode == "light":
                ys.append((actions, out.reward, done, stm, out.captured, out.term_reason))
            obs, masks = out.obs, out.legal_mask
        carry = (env_states, obs, masks, done_seen, result, plies)
        return carry, [torch.stack(parts) for parts in zip(*ys)]

    def run_round(self, pairings, seed: int = 0, collect=False, sampler=None):
        """pairings: list of (vars_a, vars_b) state dicts on the pool's
        device, at most P; shorter rounds are padded with the last pairing
        (pad results discarded).

        collect=False -> (results, stats). collect=True / "light" ->
        (results, stats, rollouts) where rollouts[i] is pairing i's
        MatchRollout slice of the shared trajectory ("light" drops
        observations and legal masks, enough for feature extraction)."""
        empty = RoundStats(0, 0, 0, 0)
        if not pairings:
            return ([], empty, []) if collect else ([], empty)
        if len(pairings) > self.P:
            raise ValueError(f"{len(pairings)} pairings > pool capacity {self.P}")
        type(self).rounds_run += 1
        real = len(pairings)
        padded = list(pairings) + [pairings[-1]] * (self.P - real)
        stacked = stack_pairings(padded)

        dev = self.device
        env_states, obs, masks = self.core.init()
        a_color = torch.arange(self.N, device=dev, dtype=torch.int32) % 2
        carry = (env_states, obs, masks, torch.zeros(self.N, dtype=torch.bool, device=dev),
                 torch.zeros(self.N, dtype=torch.int64, device=dev),
                 torch.zeros(self.N, dtype=torch.int32, device=dev))
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        mode = "full" if collect is True else ("light" if collect == "light" else "none")

        collected = []
        steps = 0
        max_chunks = -(-self.max_ply // self.chunk_steps) + 1
        # the early exit reads the flag of LAG chunks back: the host never
        # waits for the chunk it just queued (up to LAG extra chunks of
        # auto-reset play of the same pairings; results froze at each env's
        # first terminal)
        LAG = 2 if self.chunk_steps < 128 else 1
        done_flags = []
        for i in range(max_chunks):
            carry, ys = self._chunk(stacked, carry, a_color, generator, sampler, steps, mode)
            if collect:
                collected.append(ys)
            steps += self.chunk_steps
            done_flags.append(carry[3])
            if i >= LAG and bool(done_flags[i - LAG].all()):
                break

        _, _, _, done_seen, result, plies = carry
        done_np = done_seen.cpu().numpy().reshape(self.P, self.E)
        res_np = result.cpu().numpy().reshape(self.P, self.E)
        ply_np = plies.cpu().numpy().reshape(self.P, self.E)
        results = []
        for p in range(real):
            d = done_np[p]
            r = res_np[p][d]
            results.append(MatchResult(
                wins_a=int((r == 1).sum()),
                wins_b=int((r == -1).sum()),
                draws=int((r == 0).sum()),
                games=int(d.sum()),
                total_plies=int(ply_np[p][d].sum()),
            ))
        stats = RoundStats(
            pairings=real,
            games=sum(r.games for r in results),
            total_plies=sum(r.total_plies for r in results),
            steps=steps,
        )
        if not collect:
            return results, stats

        cat = [torch.cat(parts, dim=0) for parts in zip(*collected)]
        if collect == "light":
            cat = [None, cat[0], None, *cat[1:]]
        rollouts = []
        for p in range(real):
            sl = slice(p * self.E, (p + 1) * self.E)
            rollouts.append(MatchRollout(
                obs=None if cat[0] is None else cat[0][:, sl],
                actions=cat[1][:, sl],
                legal_masks=None if cat[2] is None else cat[2][:, sl],
                rewards=cat[3][:, sl],
                dones=cat[4][:, sl],
                mover_color=cat[5][:, sl],
                captured=cat[6][:, sl],
                term_reason=cat[7][:, sl],
                a_color=a_color[sl],
            ))
        return results, stats, rollouts

