"""Core constants and enums for the TPU-native shogi engine.

The port's own copy of keisei_tpu/engine/types.py, numpy only, so that the port never
imports the JAX package; tests/test_torch_copies.py holds the two equal.

Piece-kind encoding (this framework's own scheme — not the reference's):
    kind 0..7  = P, L, N, S, G, B, R, K (unpromoted)
    kind 8..11 = +P, +L, +N, +S  (base kind + 8)
    kind 13    = +B (horse), kind 14 = +R (dragon)
    kinds 12 and 15 are unused (G and K cannot promote).

Board cells are int8: EMPTY (-1) or ``kind + 16 * color`` (color 0 = Black,
1 = White). Row 0 is White's back rank (Black's promotion zone is rows 0-2),
matching SFEN order and the reference engine's Square layout
(reference: shogi-core/src/types.rs:159-219).

Action space: 81 x 139 = 11,259 spatial actions, semantics identical to the
reference SpatialActionMapper (shogi-gym/src/spatial_action_mapper.rs:1-28):
    slot 0-63    slide dir*8 + (dist-1), no promotion
    slot 64-127  same, with promotion
    slot 128-131 knight left/right x promote (128=L, 129=L+, 130=R, 131=R+)
    slot 132-138 drops, hand-piece order P,L,N,S,G,B,R
Directions (perspective space, N = toward the opponent):
    0=N(-1,0) 1=NE(-1,+1) 2=E(0,+1) 3=SE(+1,+1) 4=S(+1,0) 5=SW(+1,-1)
    6=W(0,-1) 7=NW(-1,-1)
"""

from __future__ import annotations

import numpy as np

# --- piece kinds -----------------------------------------------------------
PAWN, LANCE, KNIGHT, SILVER, GOLD, BISHOP, ROOK, KING = range(8)
NUM_BASE = 8
PROMO_OFFSET = 8
NUM_KINDS = 16  # 12 valid, slots 12/15 unused

# Which base kinds can promote.
CAN_PROMOTE = np.zeros(NUM_KINDS, dtype=bool)
CAN_PROMOTE[[PAWN, LANCE, KNIGHT, SILVER, BISHOP, ROOK]] = True

EMPTY = -1

# Hand piece indices 0..6 = P,L,N,S,G,B,R (reference HandPieceType order,
# shogi-core/src/types.rs:101-122).
NUM_HAND = 7
HAND_MAX = np.array([18, 4, 4, 4, 4, 2, 2], dtype=np.int32)

# --- board geometry --------------------------------------------------------
NUM_SQUARES = 81
BOARD_SIZE = 9

# Perspective-space directions (dr, dc); index order matches the reference
# spatial mapper (spatial_action_mapper.rs:31-40).
DIRECTIONS = np.array(
    [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)],
    dtype=np.int32,
)
NUM_DIRS = 8
MAX_DIST = 8

# --- action space ----------------------------------------------------------
NUM_MOVE_TYPES = 139
ACTION_SPACE = NUM_SQUARES * NUM_MOVE_TYPES  # 11,259
FLAT_ACTION_SPACE = 81 * 80 * 2 + 81 * 7  # 13,527 (reference DefaultActionMapper)

# --- game results ----------------------------------------------------------
# TerminationReason codes match the reference exactly
# (shogi-gym/src/step_result.rs:7-30).
NOT_TERMINATED = 0
CHECKMATE = 1
REPETITION = 2
PERPETUAL_CHECK = 3
IMPASSE = 4
MAX_MOVES = 5

# Winner codes used internally alongside the termination reason:
WINNER_NONE = -1  # draw / not terminal

# --- piece values ----------------------------------------------------------
# Material values for the score head (reference rules.rs:406-423); indexed by
# kind. Promoted values: +P=7 +L=6 +N=6 +S=6 +B=10 +R=12.
PIECE_VALUE = np.zeros(NUM_KINDS, dtype=np.int32)
PIECE_VALUE[[PAWN, LANCE, KNIGHT, SILVER, GOLD, BISHOP, ROOK, KING]] = [
    1, 3, 4, 5, 6, 8, 10, 0,
]
PIECE_VALUE[[PAWN + 8, LANCE + 8, KNIGHT + 8, SILVER + 8, BISHOP + 8, ROOK + 8]] = [
    7, 6, 6, 6, 10, 12,
]

# Impasse values (reference rules.rs:391-397): R/B (incl. promoted) = 5,
# king = 0, everything else = 1.
IMPASSE_VALUE = np.ones(NUM_KINDS, dtype=np.int32)
IMPASSE_VALUE[[BISHOP, ROOK, BISHOP + 8, ROOK + 8]] = 5
IMPASSE_VALUE[KING] = 0
IMPASSE_VALUE[[12, 15]] = 0

# Hand-piece values for material balance (hand pieces are never promoted).
HAND_VALUE = PIECE_VALUE[:NUM_HAND].copy()
HAND_IMPASSE_VALUE = IMPASSE_VALUE[:NUM_HAND].copy()


def sq(row: int, col: int) -> int:
    return row * 9 + col


def kind_of(cell: int) -> int:
    return cell % 16


def color_of(cell: int) -> int:
    return cell // 16


def is_promoted_kind(kind: int) -> bool:
    return kind >= PROMO_OFFSET


def base_of(kind: int) -> int:
    return kind - PROMO_OFFSET if kind >= PROMO_OFFSET else kind
