"""The engine's transitions, held to the plain rules reference (rules.py).

A run follows a few envs, drawn from the seed, from the first step of the
env batch it builds. `Tape.record`, called after each engine step, keeps
for those envs the action and everything the step returned that the
rollout reads: the observation after an auto-reset, the terminal
observation, the legal mask, the reward, terminated, truncated and the
material. `Tape.flush`, after each unit, moves them to the host. After the
window the reference plays the same actions from the initial position, and
every kept transition is compared exactly: `engine_off` counts those that
differ in anything, and an action the reference holds illegal counts too
(that env is then followed no further).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from . import rules

FIELDS = ("actions", "obs", "terminal_obs", "masks", "scalars")


class Tape:
    def __init__(self, num_envs: int, tracked: int, seed: int, device, max_ply: int):
        pick = random.Random(int(seed) ^ 0x7A9E)
        self.envs = sorted(pick.sample(range(num_envs), min(tracked, num_envs)))
        self.idx = torch.tensor(self.envs, device=device)
        self.max_ply = max_ply
        self.pending: list = []
        self.host: dict = {f: [] for f in FIELDS}

    def record(self, actions: torch.Tensor, eo) -> None:
        i = self.idx
        scalars = torch.stack([eo.reward.float(), eo.terminated.float(), eo.truncated.float(),
                               eo.material.float()])
        self.pending.append((actions[i], eo.obs[i], eo.terminal_obs[i], eo.legal_mask[i],
                             scalars[:, i].T))

    def flush(self) -> None:
        if not self.pending:
            return
        for name, parts in zip(FIELDS, zip(*self.pending)):
            self.host[name].append(torch.stack(parts).cpu().numpy())
        self.pending = []

    def plies(self) -> int:
        return sum(a.shape[0] for a in self.host["actions"])


def check(tape: Tape) -> dict:
    """engine_off and (not compared) how much was compared."""
    tape.flush()
    if not tape.host["actions"]:
        return {"engine_off": 1, "_engine_transitions": 0}
    h = {f: np.concatenate(v) for f, v in tape.host.items()}
    k = len(tape.envs)
    games = [rules.Game(tape.max_ply) for _ in range(k)]
    alive = [True] * k
    off = ends = compared = 0
    for t in range(h["actions"].shape[0]):
        for j in range(k):
            if not alive[j]:
                continue
            compared += 1
            try:
                o = games[j].step(int(h["actions"][t, j]))
            except ValueError:
                off += 1
                alive[j] = False
                continue
            reward, terminated, truncated, material = h["scalars"][t, j]
            same = (np.array_equal(o["obs"], h["obs"][t, j].reshape(rules.PLANES, 81))
                    and np.array_equal(o["terminal_obs"],
                                       h["terminal_obs"][t, j].reshape(rules.PLANES, 81))
                    and np.array_equal(rules.mask_of(o["legal"]), h["masks"][t, j])
                    and o["reward"] == reward and o["terminated"] == bool(terminated)
                    and o["truncated"] == bool(truncated) and o["material"] == material)
            off += not same
            ends += o["terminated"] or o["truncated"]
    return {"engine_off": off, "_engine_transitions": compared, "_engine_game_ends": ends,
            "_engine_envs": k}
