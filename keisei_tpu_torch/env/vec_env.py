"""Batched environment (counterpart of keisei_tpu/env/vec_env.py).

* `EnvCore`: `init()` and `step(states, actions)` run the rules engine on
  N envs at once on one device, with auto-reset (the training path).
* `VecEnv`: the host shim with the reference VecEnv's Python surface
  (constructor, `reset` / `step` returning numpy arrays shaped per the
  StepResult contract, episode counters, `get_sfen`,
  `get_spectator_data`) and the spatial <-> flat action tables.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields
from types import SimpleNamespace

import numpy as np
import torch

from ..engine import core as C
from ..engine import types as TY
from ..engine.sfen import to_sfen
from ..utils.device import resolve_device
from .spectator_data import build_spectator_dict, move_usi


class EnvCore:
    """N envs on one device (the card unless the caller names "cpu"; "cuda"
    without a card raises). The engine tables and the fresh-game state and
    outputs are built once, at construction."""

    def __init__(self, num_envs: int, max_ply: int = 500, num_channels: int = 50,
                 device: torch.device | str = "cuda"):
        if num_channels not in (46, 50):
            raise ValueError(f"num_channels must be 46 or 50, got {num_channels}")
        self.num_envs = num_envs
        self.max_ply = max_ply
        self.num_channels = num_channels
        self.action_space = TY.ACTION_SPACE
        self.device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Spatial <-> flat (13,527) action-space conversion tables
# ---------------------------------------------------------------------------


def _build_flat_tables():
    """Static maps between the 11,259 spatial and 13,527 flat action spaces.

    Flat encoding per the reference DefaultActionMapper: board = from*160 +
    dest_offset*2 + promote with dest_offset skipping `from`; drops =
    12960 + to*7 + piece. Both spaces are perspective-relative, so the
    mapping is position-independent.
    """
    spatial_to_flat = np.full(TY.ACTION_SPACE, TY.FLAT_ACTION_SPACE, dtype=np.int32)
    flat_to_spatial = np.full(TY.FLAT_ACTION_SPACE, -1, dtype=np.int32)

    def put(spatial, flat):
        spatial_to_flat[spatial] = flat
        flat_to_spatial[flat] = spatial

    for sq in range(81):
        r, c = divmod(sq, 9)
        for slot in range(139):
            idx = sq * 139 + slot
            if slot >= 132:
                put(idx, 12960 + sq * 7 + (slot - 132))
                continue
            if slot >= 128:
                k = slot - 128
                lr, promote = k // 2, k % 2
                tr, tc = r - 2, c + (-1 if lr == 0 else 1)
            else:
                promote = 1 if slot >= 64 else 0
                base = slot - 64 if slot >= 64 else slot
                d, dist = base // 8, base % 8 + 1
                dr, dc = TY.DIRECTIONS[d]
                tr, tc = r + dr * dist, c + dc * dist
            if not (0 <= tr < 9 and 0 <= tc < 9):
                continue
            to = tr * 9 + tc
            dest_offset = to - 1 if to > sq else to
            put(idx, sq * 160 + dest_offset * 2 + promote)
    return spatial_to_flat, flat_to_spatial


SPATIAL_TO_FLAT, FLAT_TO_SPATIAL = _build_flat_tables()


# ---------------------------------------------------------------------------
# Host-facing shim (reference-compatible surface)
# ---------------------------------------------------------------------------


@dataclass
class StepMetadata:
    captured_piece: np.ndarray  # (N,) u8, 255 = no capture
    termination_reason: np.ndarray  # (N,) u8
    ply_count: np.ndarray  # (N,) u16
    material_balance: np.ndarray  # (N,) i32, last-mover perspective


@dataclass
class StepResult:
    observations: np.ndarray  # (N, C, 9, 9) f32
    legal_masks: np.ndarray  # (N, A) bool
    rewards: np.ndarray  # (N,) f32
    terminated: np.ndarray  # (N,) bool
    truncated: np.ndarray  # (N,) bool
    terminal_observations: np.ndarray  # (N, C, 9, 9) f32
    current_players: np.ndarray  # (N,) u8
    step_metadata: StepMetadata


@dataclass
class ResetResult:
    observations: np.ndarray
    legal_masks: np.ndarray


class VecEnv:
    """Host shim with the reference VecEnv's constructor and step contract:
    `step` runs one engine step over all N envs on the device and copies
    the results to numpy for the host tier. Training uses EnvCore."""

    # spectator move-history record window (steps)
    HISTORY_WINDOW = 64

    def __init__(
        self,
        num_envs: int = 512,
        max_ply: int = 500,
        observation_mode: str = "default",
        action_mode: str = "default",
        device: torch.device | str = "cuda",
    ) -> None:
        if observation_mode not in ("default", "katago"):
            raise ValueError(f"unknown observation_mode {observation_mode!r}")
        if action_mode not in ("default", "spatial"):
            raise ValueError(f"unknown action_mode {action_mode!r}")
        self.num_envs = num_envs
        self.max_ply = max_ply
        self.observation_mode = observation_mode
        self.action_mode = action_mode
        self.num_channels = 46 if observation_mode == "default" else 50
        self.action_space = (
            TY.ACTION_SPACE if action_mode == "spatial" else TY.FLAT_ACTION_SPACE
        )
        self._core = EnvCore(num_envs, max_ply, self.num_channels, device)
        self._states, _, mask0 = self._core.init()
        self._last_mask = mask0.cpu().numpy()  # spatial-space mask cache

        self.episodes_completed = 0
        self.episodes_drawn = 0
        self.episodes_truncated = 0
        self.total_episode_ply = 0
        # one (actions, stms, dones) record per step; per-env histories are
        # rebuilt only on inspection (get_spectator_data), so an episode
        # longer than the window shows only its most recent moves
        self._move_records: deque = deque(maxlen=self.HISTORY_WINDOW)

    # -- helpers ------------------------------------------------------------

    def _mask_out(self, spatial_mask: np.ndarray) -> np.ndarray:
        if self.action_mode == "spatial":
            return spatial_mask
        flat = np.zeros((self.num_envs, TY.FLAT_ACTION_SPACE + 1), dtype=bool)
        np.put_along_axis(
            flat, np.broadcast_to(SPATIAL_TO_FLAT, spatial_mask.shape), spatial_mask, axis=1
        )
        return flat[:, : TY.FLAT_ACTION_SPACE]

    def _to_spatial_actions(self, actions: np.ndarray) -> np.ndarray:
        if self.action_mode == "spatial":
            return actions
        sp = FLAT_TO_SPATIAL[actions]
        if np.any(sp < 0):
            bad = np.nonzero(sp < 0)[0][0]
            raise ValueError(
                f"env {bad}: flat action {actions[bad]} has no board geometry"
            )
        return sp

    # -- public surface -------------------------------------------------------

    def reset(self) -> ResetResult:
        self._states, obs0, mask0 = self._core.init()
        self._last_mask = mask0.cpu().numpy()
        self._move_records.clear()
        return ResetResult(
            observations=obs0.cpu().numpy().reshape(self.num_envs, self.num_channels, 9, 9),
            legal_masks=self._mask_out(self._last_mask),
        )

    def step(self, actions) -> StepResult:
        actions = np.asarray(actions, dtype=np.int64)
        if actions.shape != (self.num_envs,):
            raise ValueError(
                f"expected {self.num_envs} actions, got shape {actions.shape}"
            )
        if np.any((actions < 0) | (actions >= self.action_space)):
            bad = np.nonzero((actions < 0) | (actions >= self.action_space))[0][0]
            raise ValueError(f"env {bad}: action {actions[bad]} out of range")
        spatial = self._to_spatial_actions(actions)
        legal = np.take_along_axis(self._last_mask, spatial[:, None], axis=1)[:, 0]
        if not legal.all():
            bad = np.nonzero(~legal)[0][0]
            raise ValueError(
                f"env {bad}: action {actions[bad]} is illegal in the current position"
            )

        pre_stm = self._states.stm.cpu().numpy()
        self._states, out = self._core.step(
            self._states, torch.as_tensor(spatial, device=self._core.device))
        out = SimpleNamespace(**{f.name: getattr(out, f.name).cpu().numpy()
                                 for f in fields(out)})
        self._last_mask = out.legal_mask

        done = out.terminated | out.truncated
        self._move_records.append((spatial, pre_stm, done))
        n_done = int(done.sum())
        if n_done:
            self.episodes_completed += n_done
            self.total_episode_ply += int(out.ply_count[done].sum())
            # one draw definition everywhere: terminated with no winner
            self.episodes_drawn += int(
                (out.terminated[done] & (out.reward[done] == 0)).sum()
            )
            self.episodes_truncated += int(
                (out.term_reason[done] == TY.MAX_MOVES).sum()
            )

        N, Cn = self.num_envs, self.num_channels
        return StepResult(
            observations=out.obs.reshape(N, Cn, 9, 9),
            legal_masks=self._mask_out(out.legal_mask),
            rewards=out.reward,
            terminated=out.terminated,
            truncated=out.truncated,
            terminal_observations=out.terminal_obs.reshape(N, Cn, 9, 9),
            current_players=out.current_player.astype(np.uint8),
            step_metadata=StepMetadata(
                captured_piece=out.captured,
                termination_reason=out.term_reason,
                ply_count=out.ply_count.astype(np.uint16),
                material_balance=out.material,
            ),
        )

    # -- stats getters ------------------------------------------------------

    @property
    def draw_rate(self) -> float:
        return self.episodes_drawn / max(self.episodes_completed, 1)

    @property
    def mean_episode_length(self) -> float:
        return self.total_episode_ply / max(self.episodes_completed, 1)

    @property
    def truncation_rate(self) -> float:
        return self.episodes_truncated / max(self.episodes_completed, 1)

    def reset_stats(self) -> None:
        self.episodes_completed = 0
        self.episodes_drawn = 0
        self.episodes_truncated = 0
        self.total_episode_ply = 0

    # -- inspection -----------------------------------------------------------

    def get_sfen(self, i: int) -> str:
        return to_sfen(self._states.board[i].cpu().numpy(),
                       self._states.hands[i].cpu().numpy(), int(self._states.stm[i]))

    def _histories(self) -> list[list[tuple[int, int]]]:
        """Per-env (action, stm) histories replayed from the step records."""
        hist: list[list[tuple[int, int]]] = [[] for _ in range(self.num_envs)]
        for spatial, stm, done in self._move_records:
            for i in np.nonzero(done)[0]:
                hist[i].clear()
            for i in np.nonzero(~done)[0]:
                hist[i].append((int(spatial[i]), int(stm[i])))
        return hist

    def get_spectator_data(self) -> list[dict]:
        """Reference-format spectator dicts for every env. States are
        post-auto-reset, so `is_over` reflects the fresh game (False)."""
        st = SimpleNamespace(**{f: getattr(self._states, f).cpu().numpy()
                                for f in ("board", "hands", "stm", "ply", "in_check")})
        histories = self._histories()
        return [
            build_spectator_dict(
                st.board[i], st.hands[i], int(st.stm[i]), int(st.ply[i]),
                reason=TY.NOT_TERMINATED, winner=-1, in_check=bool(st.in_check[i]),
                move_history=[move_usi(a, s) for a, s in histories[i]],
            )
            for i in range(self.num_envs)
        ]
