"""Behavioral game-feature extraction from match rollouts.

Capability parity with the reference GameFeatureTracker
(keisei/training/game_feature_tracker.py:1-60, :176+), redesigned for the
batched rollout shape: instead of incrementally mutating per-env trackers
on every step, feature rows are extracted vectorized-after-the-fact from a
MatchRollout's (T, N) arrays — captures, drops, early drops, promotions,
first-capture ply, opening sequences (3/6), early rook/king movement, all
classified purely from the spatial action encoding.
"""

from __future__ import annotations

import json

import numpy as np

from .match import MatchRollout

NO_CAPTURE = 255
EARLY_DROP_PLY = 40
ROOK_WINDOW = 20
KING_WINDOW = 30
# perspective-space starting squares (the action's source square is
# perspective-relative, so one constant serves both colors —
# game_feature_tracker.py:28-40)
ROOK_START = 7 * 9 + 7  # 8h in perspective space (row 7, col 7)
KING_START = 8 * 9 + 4


def _first_game_slices(dones: np.ndarray):
    """Per env: slice [0, end] covering the FIRST game (auto-reset follows)."""
    T, N = dones.shape
    out = []
    for n in range(N):
        idx = np.flatnonzero(dones[:, n])
        out.append(int(idx[0]) + 1 if len(idx) else T)
    return out


def extract_game_features(
    rollout: MatchRollout,
    entry_a_id: int,
    entry_b_id: int,
    epoch: int,
) -> list[dict]:
    """One feature row per (finished first game, side) — two rows per env."""
    actions = np.asarray(rollout.actions)
    dones = np.asarray(rollout.dones)
    rewards = np.asarray(rollout.rewards)
    captured = np.asarray(rollout.captured)
    reasons = np.asarray(rollout.term_reason)
    movers = np.asarray(rollout.mover_color)
    a_color = np.asarray(rollout.a_color)
    T, N = actions.shape
    ends = _first_game_slices(dones)

    slots = actions % 139
    sources = actions // 139
    is_drop = slots >= 132
    # slide promotions are slots 64-127; knight promotions are the ODD
    # knight slots (129, 131) — 128/130 are plain jumps
    is_promo = ((slots >= 64) & (slots < 128)) | (slots == 129) | (slots == 131)

    rows: list[dict] = []
    for n in range(N):
        end = ends[n]
        if end >= T and not dones[: end, n].any():
            continue  # unfinished game: skip (reference emits on game end)
        g_actions = actions[:end, n]
        g_moves = movers[:end, n]
        g_caps = captured[:end, n]
        last = end - 1
        reason = int(reasons[last, n])
        total = end
        win_color = -1
        if rewards[last, n] > 0:
            win_color = int(g_moves[last])
        elif rewards[last, n] < 0:
            win_color = 1 - int(g_moves[last])

        for entry_id, opp_id, color in (
            (entry_a_id, entry_b_id, int(a_color[n])),
            (entry_b_id, entry_a_id, 1 - int(a_color[n])),
        ):
            mine = g_moves == color
            plies = np.flatnonzero(mine)
            if len(plies) == 0:
                continue
            my_caps = np.flatnonzero(mine & (g_caps != NO_CAPTURE))
            my_drops = np.flatnonzero(mine & is_drop[:end, n])
            my_promos = mine & is_promo[:end, n]
            rook_moves = mine & (sources[:end, n] == ROOK_START) & ~is_drop[:end, n]
            king_moves = mine & (sources[:end, n] == KING_START) & ~is_drop[:end, n]
            rook_first = np.flatnonzero(rook_moves)
            result = ("win" if win_color == color else
                      "loss" if win_color == 1 - color else "draw")
            opening = [int(a) for a in g_actions[plies[:6]]]
            rows.append({
                "checkpoint_id": entry_id,
                "opponent_id": opp_id,
                "epoch": epoch,
                "side": "black" if color == 0 else "white",
                "result": result,
                "total_plies": int(total),
                "first_action": int(g_actions[plies[0]]),
                "opening_seq_3": json.dumps(opening[:3]),
                "opening_seq_6": json.dumps(opening),
                "rook_moved_ply": int(rook_first[0]) if len(rook_first) else None,
                "king_displacement_20": int(king_moves[:20].sum() > 0),
                "first_capture_ply": int(my_caps[0]) if len(my_caps) else None,
                "first_drop_ply": int(my_drops[0]) if len(my_drops) else None,
                "num_captures": int(len(my_caps)),
                "num_drops": int(len(my_drops)),
                "num_promotions": int(my_promos.sum()),
                "num_early_drops": int((my_drops < EARLY_DROP_PLY).sum()),
                "rook_moves_in_20": int(rook_moves[:ROOK_WINDOW].sum()),
                "king_moves_in_30": int(king_moves[:KING_WINDOW].sum()),
                "termination_reason": reason,
            })
    return rows
