"""Precomputed constant tables for the TPU-native shogi engine.

The port's own copy of keisei_tpu/engine/tables.py, numpy only, so that the port never
imports the JAX package; tests/test_torch_copies.py holds the two equal.

All rule geometry (step attacks, slide rays, between-masks, promotion zones)
is baked into dense numpy constants at import time so that move generation on
device is pure table lookups + boolean algebra — no data-dependent control
flow, no ray loops (replaces the reference's scalar ray-casting in
shogi-core/src/attack.rs:63-225 with a branchless, batched formulation).

Everything is expressed in **perspective space**: side 0 is the player to
move ("moves north", promotion zone rows 0-2), side 1 is the opponent
("moves south"). The environment canonicalizes the board into this space
before movegen, so the tables need no color axis beyond side.
"""

from __future__ import annotations

import numpy as np

from .types import (
    BISHOP,
    DIRECTIONS,
    GOLD,
    KING,
    KNIGHT,
    LANCE,
    MAX_DIST,
    NUM_DIRS,
    NUM_KINDS,
    NUM_SQUARES,
    PAWN,
    PROMO_OFFSET,
    ROOK,
    SILVER,
)

# ---------------------------------------------------------------------------
# Direction indices (perspective space)
# ---------------------------------------------------------------------------
N_, NE, E_, SE, S_, SW, W_, NW = range(8)

# Step directions per kind, for SIDE 0 (mover, forward = north).
# Gold movers: N, NE, NW, E, W, S.
_GOLD_DIRS = [N_, NE, NW, E_, W_, S_]
STEP_DIRS_SIDE0: dict[int, list[int]] = {
    PAWN: [N_],
    LANCE: [],  # slides only
    KNIGHT: [],  # jumps handled separately
    SILVER: [N_, NE, NW, SE, SW],
    GOLD: _GOLD_DIRS,
    BISHOP: [],
    ROOK: [],
    KING: [N_, NE, E_, SE, S_, SW, W_, NW],
    PAWN + 8: _GOLD_DIRS,
    LANCE + 8: _GOLD_DIRS,
    KNIGHT + 8: _GOLD_DIRS,
    SILVER + 8: _GOLD_DIRS,
    BISHOP + 8: [N_, E_, S_, W_],  # horse: bishop slides + ortho steps
    ROOK + 8: [NE, SE, SW, NW],  # dragon: rook slides + diag steps
}

SLIDE_DIRS_SIDE0: dict[int, list[int]] = {
    LANCE: [N_],
    BISHOP: [NE, SE, SW, NW],
    ROOK: [N_, E_, S_, W_],
    BISHOP + 8: [NE, SE, SW, NW],
    ROOK + 8: [N_, E_, S_, W_],
}


def _opp_dir(d: int) -> int:
    """180-degree rotation of a direction index."""
    return (d + 4) % 8


def _offset(sq: int, dr: int, dc: int) -> int:
    """Apply (dr, dc); return -1 if off board."""
    r, c = divmod(sq, 9)
    nr, nc = r + dr, c + dc
    if 0 <= nr < 9 and 0 <= nc < 9:
        return nr * 9 + nc
    return -1


def _build_tables():
    # MOVE_STEP_OK[kind, dir]: side-0 single-step capability (16, 8)
    move_step_ok = np.zeros((NUM_KINDS, NUM_DIRS), dtype=bool)
    for kind, dirs in STEP_DIRS_SIDE0.items():
        for d in dirs:
            move_step_ok[kind, d] = True

    # SLIDE_OK[kind, side, dir] (16, 2, 8)
    slide_ok = np.zeros((NUM_KINDS, 2, NUM_DIRS), dtype=bool)
    for kind, dirs in SLIDE_DIRS_SIDE0.items():
        for d in dirs:
            slide_ok[kind, 0, d] = True
            slide_ok[kind, 1, _opp_dir(d)] = True

    # KNIGHT_TO[side, from, slot] (2, 81, 2), slot 0 = "left" (dc=-1 for side
    # 0), slot 1 = "right" (dc=+1). Matches the reference knight slot
    # normalization (spatial_action_mapper.rs:94-133: slot 0 has dc the same
    # sign as dr; in perspective space dr=-2, so left = dc=-1).
    knight_to = np.full((2, NUM_SQUARES, 2), -1, dtype=np.int32)
    for f in range(NUM_SQUARES):
        knight_to[0, f, 0] = _offset(f, -2, -1)
        knight_to[0, f, 1] = _offset(f, -2, +1)
        knight_to[1, f, 0] = _offset(f, +2, +1)
        knight_to[1, f, 1] = _offset(f, +2, -1)

    # STEP_ATT[kind, side, from, to] (16, 2, 81, 81): one-step attack
    # incidence including knight jumps (used for attack maps / check tests).
    step_att = np.zeros((NUM_KINDS, 2, NUM_SQUARES, NUM_SQUARES), dtype=bool)
    for kind, dirs in STEP_DIRS_SIDE0.items():
        for d in dirs:
            dr, dc = DIRECTIONS[d]
            for f in range(NUM_SQUARES):
                t = _offset(f, dr, dc)
                if t >= 0:
                    step_att[kind, 0, f, t] = True
                t2 = _offset(f, -dr, -dc)
                if t2 >= 0:
                    step_att[kind, 1, f, t2] = True
    for side in range(2):
        for f in range(NUM_SQUARES):
            for slot in range(2):
                t = knight_to[side, f, slot]
                if t >= 0:
                    step_att[KNIGHT, side, f, t] = True

    # RAY[dir, from, k] (8, 81, 8): square at distance k+1 along dir, or -1.
    ray = np.full((NUM_DIRS, NUM_SQUARES, MAX_DIST), -1, dtype=np.int32)
    for d in range(NUM_DIRS):
        dr, dc = DIRECTIONS[d]
        for f in range(NUM_SQUARES):
            cur = f
            for k in range(MAX_DIST):
                cur = _offset(cur, dr, dc)
                if cur < 0:
                    break
                ray[d, f, k] = cur

    # ALIGNED_DIR[from, to] (81, 81): direction index or -1;
    # DIST[from, to]: Chebyshev distance along that line (0 if unaligned).
    aligned_dir = np.full((NUM_SQUARES, NUM_SQUARES), -1, dtype=np.int32)
    dist_tab = np.zeros((NUM_SQUARES, NUM_SQUARES), dtype=np.int32)
    for d in range(NUM_DIRS):
        for f in range(NUM_SQUARES):
            for k in range(MAX_DIST):
                t = ray[d, f, k]
                if t >= 0:
                    aligned_dir[f, t] = d
                    dist_tab[f, t] = k + 1

    # BETWEEN[from, to, sq] (81, 81, 81): squares strictly between aligned
    # from/to; all-false when unaligned.
    between = np.zeros((NUM_SQUARES, NUM_SQUARES, NUM_SQUARES), dtype=bool)
    for f in range(NUM_SQUARES):
        for t in range(NUM_SQUARES):
            d = aligned_dir[f, t]
            if d < 0:
                continue
            for k in range(dist_tab[f, t] - 1):
                between[f, t, ray[d, f, k]] = True

    return move_step_ok, slide_ok, knight_to, step_att, ray, aligned_dir, dist_tab, between


(
    MOVE_STEP_OK,
    SLIDE_OK,
    KNIGHT_TO,
    STEP_ATT,
    RAY,
    ALIGNED_DIR,
    _DIST_TAB,  # made by _build_tables; no runtime consumer
    BETWEEN,
) = _build_tables()

# MOVE_OK[kind, dir, dist_idx] (16, 8, 8): side-0 capability for slot moves —
# dist_idx 0 means distance 1 (step or slide), dist_idx >= 1 slide only.
MOVE_OK = np.zeros((NUM_KINDS, NUM_DIRS, MAX_DIST), dtype=bool)
MOVE_OK[:, :, 0] = MOVE_STEP_OK | SLIDE_OK[:, 0, :]
for _k in range(1, MAX_DIST):
    MOVE_OK[:, :, _k] = SLIDE_OK[:, 0, :]

# Promotion helpers (side 0, perspective rows). Reference: movegen.rs:17-64.
ROW_OF = np.arange(NUM_SQUARES) // 9
COL_OF = np.arange(NUM_SQUARES) % 9
IN_PROMO_ZONE = ROW_OF <= 2  # (81,) bool, perspective space

# MUST_PROMOTE_AT[kind, sq] (16, 81): forced promotion when landing there.
MUST_PROMOTE_AT = np.zeros((NUM_KINDS, NUM_SQUARES), dtype=bool)
MUST_PROMOTE_AT[PAWN] = ROW_OF == 0
MUST_PROMOTE_AT[LANCE] = ROW_OF == 0
MUST_PROMOTE_AT[KNIGHT] = ROW_OF <= 1

# DEAD_DROP[hand_piece, sq] (7, 81): drop would leave the piece moveless.
DEAD_DROP = np.zeros((7, NUM_SQUARES), dtype=bool)
DEAD_DROP[PAWN] = ROW_OF == 0
DEAD_DROP[LANCE] = ROW_OF == 0
DEAD_DROP[KNIGHT] = ROW_OF <= 1

# CAN_PROMOTE_KIND[kind] — unpromoted P/L/N/S/B/R only.
CAN_PROMOTE_KIND = np.zeros(NUM_KINDS, dtype=bool)
CAN_PROMOTE_KIND[[PAWN, LANCE, KNIGHT, SILVER, BISHOP, ROOK]] = True

# Observation channel for each perspective-space cell value:
# cell = kind + 16 * side  ->  channel index in the 46/50-channel layout
# (reference observation.rs:1-13, 43-72). -1 for invalid kinds.
_UNPROMOTED_CH = {PAWN: 0, LANCE: 1, KNIGHT: 2, SILVER: 3, GOLD: 4, BISHOP: 5, ROOK: 6, KING: 7}
_PROMOTED_CH = {PAWN: 0, LANCE: 1, KNIGHT: 2, SILVER: 3, BISHOP: 4, ROOK: 5}
OBS_CHANNEL = np.full(32, -1, dtype=np.int32)
for _kind in range(NUM_KINDS):
    base = _kind - PROMO_OFFSET if _kind >= PROMO_OFFSET else _kind
    promoted = _kind >= PROMO_OFFSET
    if promoted and base not in _PROMOTED_CH:
        continue
    own_ch = (8 + _PROMOTED_CH[base]) if promoted else _UNPROMOTED_CH[base]
    opp_ch = (22 + _PROMOTED_CH[base]) if promoted else (14 + _UNPROMOTED_CH[base])
    OBS_CHANNEL[_kind] = own_ch
    OBS_CHANNEL[_kind + 16] = opp_ch

# Startpos board (absolute space, int8 cells kind + 16*color, -1 empty).
# Row 0 = White's back rank (SFEN first rank), row 8 = Black's back rank.
def _startpos_board() -> np.ndarray:
    board = np.full(NUM_SQUARES, -1, dtype=np.int8)
    back = [LANCE, KNIGHT, SILVER, GOLD, KING, GOLD, SILVER, KNIGHT, LANCE]
    for c, kind in enumerate(back):
        board[0 * 9 + c] = kind + 16  # white
        board[8 * 9 + c] = kind  # black
    board[1 * 9 + 1] = ROOK + 16  # white rook at row1 col1 (SFEN "1r5b1")
    board[1 * 9 + 7] = BISHOP + 16
    board[7 * 9 + 1] = BISHOP  # black bishop at row7 col1 ("1B5R1")
    board[7 * 9 + 7] = ROOK
    for c in range(9):
        board[2 * 9 + c] = PAWN + 16
        board[6 * 9 + c] = PAWN
    return board


STARTPOS_BOARD = _startpos_board()
