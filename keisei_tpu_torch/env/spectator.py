"""SpectatorEnv: one game for display, analysis and the showcase
(counterpart of keisei_tpu/env/spectator.py).

The same public surface as the JAX package's: the rich dict state,
`from_sfen` seeding (the move number seeds the ply), NO auto-reset (the
game stays ended until `reset()`), `legal_actions()` /
`legal_moves_with_usi()`, 46-channel observations, and Hodges move history
with full disambiguation; the `default` (flat) and `spatial` action modes.

The game is a batch of one `GameState` on `device` (the card unless the
caller names "cpu"; "cuda" without a card raises), stepped by the port's
engine (`engine/core.py`): apply, the legal mask, the position's status and
its observation, as the JAX step program computes them. After each step
the host keeps one copy of what the surface reads (board, hands, side to
move, ply, status, mask, observation), fetched in a single transfer.
"""

from __future__ import annotations

from dataclasses import replace
from functools import lru_cache

import numpy as np
import torch

from ..engine import core as C
from ..engine import types as TY
from ..engine.sfen import parse_sfen, parse_sfen_move_number, to_sfen
from ..utils.device import resolve_device
from .spectator_data import build_spectator_dict, move_notation, move_usi
from .vec_env import FLAT_TO_SPATIAL, SPATIAL_TO_FLAT

_OBS_CHANNELS = 46
# the host copy: int32 columns of one transfer, the observation's f32 bits last
_SPANS = (("mask", TY.ACTION_SPACE), ("board", 81), ("hands", 14), ("stm", 1), ("ply", 1),
          ("reason", 1), ("winner", 1), ("in_check", 1), ("obs", _OBS_CHANNELS * 81))


@lru_cache(maxsize=8)
def _tables(device: torch.device) -> C.EngineTables:
    """The engine's tables, built once per device and shared by all games."""
    return C.EngineTables(device)


class SpectatorEnv:
    def __init__(self, max_ply: int = 500, action_mode: str = "default",
                 device: torch.device | str = "cuda"):
        if action_mode not in ("default", "spatial"):
            raise ValueError(f"unknown action_mode {action_mode!r}")
        self.max_ply = max_ply
        self.action_mode = action_mode
        self.device = resolve_device(device)
        self._tb = _tables(self.device)
        self.move_history: list[tuple[int, str]] = []
        self._state = C.init_state(1, max_ply, self._tb)
        self._refresh()

    @classmethod
    def from_sfen(cls, sfen: str, max_ply: int | None = None,
                  action_mode: str = "default",
                  device: torch.device | str = "cuda") -> "SpectatorEnv":
        env = cls(max_ply or 500, action_mode, device)
        board, hands, stm = parse_sfen(sfen)  # raises on invalid SFEN
        # honor the optional move-number field: ply feeds the observation's
        # progress plane and the max_ply truncation (as the JAX package does)
        move_no = parse_sfen_move_number(sfen)
        ply = (move_no - 1) if move_no else 0
        env._state = C.state_from_position(board, hands, stm, env.max_ply, env._tb, ply=ply)
        env.move_history = []
        env._refresh()
        return env

    # -- internals -----------------------------------------------------------

    def _refresh(self) -> None:
        """Legal mask, check, status and observation of the current
        position into the state and the host copy. Also the tail of a step:
        the status of a just-reached position is the JAX step's."""
        s, tb = self._state, self._tb
        pboard = C.perspective_board(s.board, s.stm)
        own_hand = s.hands[0, s.stm.long()]
        mask, in_check, _ = C.legal_mask_pspace(pboard, own_hand, tb)
        mask = mask.reshape(1, -1)
        # termination status of the CURRENT position: a game seeded from an
        # SFEN that is already decided must not report in_progress
        reason, winner, rep_count = C.position_status(s, mask, self.max_ply, tb)
        obs = C.observe(pboard, s.hands, s.stm, s.ply, self.max_ply, rep_count, in_check,
                        _OBS_CHANNELS, tb)
        self._state = s = replace(s, in_check=in_check, reason=reason, winner=winner)
        cols = torch.cat([mask[0].int(), s.board[0].int(), s.hands[0].reshape(-1).int(),
                          s.stm.int(), s.ply.int(), s.reason.int(), s.winner.int(),
                          s.in_check.int(), obs[0].reshape(-1).view(torch.int32)])
        host = cols.cpu().numpy()
        parts, at = {}, 0
        for name, n in _SPANS:
            parts[name] = host[at:at + n]
            at += n
        self._mask = parts["mask"].astype(bool)
        self._obs = parts["obs"].view(np.float32).reshape(_OBS_CHANNELS, 81)
        self._board = parts["board"].astype(np.int8)
        self._hands = parts["hands"].astype(np.int8).reshape(2, 7)
        self._stm, self._ply, self._reason, self._winner, self._in_check = (
            int(parts[k][0]) for k in ("stm", "ply", "reason", "winner", "in_check"))

    def _spatial(self, action: int) -> int:
        if self.action_mode == "spatial":
            return int(action)
        sp = int(FLAT_TO_SPATIAL[int(action)])
        if sp < 0:
            raise ValueError(f"flat action {action} has no board geometry")
        return sp

    # -- public surface -------------------------------------------------------

    @property
    def action_space_size(self) -> int:
        return TY.ACTION_SPACE if self.action_mode == "spatial" else TY.FLAT_ACTION_SPACE

    def reset(self) -> dict:
        self._state = C.init_state(1, self.max_ply, self._tb)
        self.move_history = []
        self._refresh()
        return self.to_dict()

    def step(self, action: int) -> dict:
        """Apply one action; returns the state dict plus reward/terminated.
        Raises on illegal actions and on moves after game end."""
        if self.is_over():
            raise ValueError("game is over — call reset()")
        spatial = self._spatial(action)
        if not (0 <= spatial < TY.ACTION_SPACE) or not self._mask[spatial]:
            raise ValueError(f"action {action} is illegal in this position")

        last_mover = self._stm
        notation = move_notation(spatial, self._board, last_mover, legal_mask=self._mask)
        self.move_history.append((int(action), notation))

        a = torch.full((1,), spatial, dtype=torch.int64, device=self.device)
        self._state = C.apply_action(self._state, a, self._tb)
        self._refresh()
        d = self.to_dict()
        w = self._winner
        d["reward"] = 0.0 if w < 0 else (1.0 if w == last_mover else -1.0)
        d["terminated"] = self.is_over()
        return d

    def to_dict(self) -> dict:
        return build_spectator_dict(
            self._board, self._hands, self._stm, self._ply, self._reason, self._winner,
            bool(self._in_check), move_history=[n for _, n in self.move_history],
        )

    def to_sfen(self) -> str:
        return to_sfen(self._board, self._hands, self._stm)

    def get_observation(self) -> np.ndarray:
        """(46, 9, 9) float32 observation (observation.rs layout)."""
        return self._obs.reshape(_OBS_CHANNELS, 9, 9)

    def legal_actions(self) -> list[int]:
        if self.is_over():
            return []
        idx = np.flatnonzero(self._mask)
        if self.action_mode == "spatial":
            return [int(i) for i in idx]
        flat = SPATIAL_TO_FLAT[idx]
        return [int(f) for f in flat if f < TY.FLAT_ACTION_SPACE]

    def legal_moves_with_usi(self) -> list[tuple[int, str]]:
        if self.is_over():
            return []
        out = []
        for sp in np.flatnonzero(self._mask):
            a = int(sp) if self.action_mode == "spatial" else int(SPATIAL_TO_FLAT[sp])
            out.append((a, move_usi(int(sp), self._stm)))
        return out

    def is_over(self) -> bool:
        return self._reason != TY.NOT_TERMINATED

    def current_player(self) -> str:
        return "black" if self._stm == 0 else "white"

    @property
    def ply(self) -> int:
        return self._ply

    @property
    def winner(self) -> int:
        """0 Black, 1 White, -1 none (a draw, or the game is not over)."""
        return self._winner
