"""Batched environment core (counterpart of keisei_tpu/env/vec_env.py EnvCore).

`EnvCore.init()` and `EnvCore.step(states, actions)` run the rules engine
on N envs at once on one device, with auto-reset. The host-facing `VecEnv`
shim of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch

from keisei_tpu.engine import types as TY

from ..engine import core as C


class EnvCore:
    """N envs on one device. The engine tables and the fresh-game state and
    outputs are built once, at construction."""

    def __init__(self, num_envs: int, max_ply: int = 500, num_channels: int = 50,
                 device: torch.device | str = "cpu"):
        if num_channels not in (46, 50):
            raise ValueError(f"num_channels must be 46 or 50, got {num_channels}")
        self.num_envs = num_envs
        self.max_ply = max_ply
        self.num_channels = num_channels
        self.action_space = TY.ACTION_SPACE
        self.device = torch.device(device)
        self.tables = C.EngineTables(self.device)
        self.reset_state = C.init_state(1, max_ply, self.tables)
        self.reset_obs, self.reset_mask, _ = C.initial_outputs(
            self.reset_state, num_channels, self.tables)

    def init(self):
        """Fresh (states, obs (N, C, 81), legal_mask (N, 11259)) for all envs."""
        n = self.num_envs
        states = self.reset_state.map(lambda x: x.expand((n,) + x.shape[1:]).clone())
        obs = self.reset_obs.expand(n, -1, -1).clone()
        mask = self.reset_mask.expand(n, -1).clone()
        return states, obs, mask

    def step(self, states: C.GameState, actions: torch.Tensor):
        """(states', StepOutput) for one action per env."""
        return C.env_step(states, actions, self.reset_state, self.reset_obs,
                          self.reset_mask, self.num_channels, self.tables)
