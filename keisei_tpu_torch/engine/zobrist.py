"""Deterministic Zobrist hashing tables.

The port's own copy of keisei_tpu/engine/zobrist.py, numpy only, so that the port never
imports the JAX package; tests/test_torch_copies.py holds the two equal.

Hashes are 64-bit, stored as a pair of uint32 lanes so device code never
needs uint64 (JAX x64 mode stays off). Table layout mirrors the reference's
structure (shogi-core/src/zobrist.rs:17-132) — piece-square keys, count-
indexed hand keys, and a side-to-move key — but the actual constants are this
framework's own (hashes are internal; only position-identity semantics must
match).

The position hash is defined as:
    XOR over occupied squares of Z_PIECE[color*16 + kind, sq]
  ^ XOR over (color, hand_piece) with count >= 1 of Z_HAND[color, piece, count]
  ^ (Z_STM if White to move else 0)
"""

from __future__ import annotations

import numpy as np

_SEED = 0x5EED_CAFE_F00D
_rng = np.random.Generator(np.random.PCG64(_SEED))

# 32 cell codes (color*16 + kind) x 81 squares x 2 uint32 lanes.
Z_PIECE = _rng.integers(0, 2**32, size=(32, 81, 2), dtype=np.uint32)
# color x 7 hand pieces x counts 0..18 (count 0 unused, kept for direct index).
Z_HAND = _rng.integers(0, 2**32, size=(2, 7, 19, 2), dtype=np.uint32)
Z_HAND[:, :, 0, :] = 0  # count 0 contributes nothing
Z_STM = _rng.integers(0, 2**32, size=(2,), dtype=np.uint32)


def compute_hash(board: np.ndarray, hands: np.ndarray, stm: int) -> np.ndarray:
    """Full-scan hash of an absolute-space position. Returns (2,) uint32.

    Oracle / host-side reference; the device engine updates incrementally.
    """
    h = np.zeros(2, dtype=np.uint32)
    for s in range(81):
        cell = int(board[s])
        if cell >= 0:
            h ^= Z_PIECE[cell, s]
    for color in range(2):
        for p in range(7):
            cnt = int(hands[color, p])
            if cnt >= 1:
                h ^= Z_HAND[color, p, cnt]
    if stm == 1:
        h ^= Z_STM
    return h
